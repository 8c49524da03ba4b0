from .build import (SGD, build_lr_schedule, build_optimizer,
                    make_param_labels)

__all__ = ["SGD", "build_lr_schedule", "build_optimizer", "make_param_labels"]
