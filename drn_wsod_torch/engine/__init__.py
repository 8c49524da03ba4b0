from .trainer import (TrainState, create_train_state, make_multi_train_step,
                      make_train_step)

__all__ = ["TrainState", "create_train_state", "make_multi_train_step",
           "make_train_step"]
