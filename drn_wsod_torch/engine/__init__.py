from .events import (CommonMetricPrinter, EventStorage, HistoryBuffer,
                     JSONWriter, TensorboardWriter, get_event_storage)
from .hooks import (EvalHook, HookBase, IterationTimer, PeriodicCheckpointer,
                    PeriodicWriter, PGTVisualization, PreciseBNHook,
                    ProfilerHook)
from .precise_bn import update_bn_stats
from .trainer import (Trainer, TrainState, create_train_state,
                      make_csc_train_step, make_multi_train_step,
                      make_train_step)

__all__ = ["CommonMetricPrinter", "EvalHook", "EventStorage",
           "HistoryBuffer", "HookBase", "IterationTimer", "JSONWriter",
           "PeriodicCheckpointer", "PeriodicWriter", "PGTVisualization",
           "PreciseBNHook",
           "ProfilerHook", "TensorboardWriter", "TrainState", "Trainer",
           "create_train_state", "get_event_storage", "make_csc_train_step",
           "make_multi_train_step", "make_train_step", "update_bn_stats"]
