"""drn_wsod_torch: the PyTorch/CUDA port of drn_wsod_tpu for NVIDIA Hopper.

Entry points run on a CUDA device unless the caller passes ``device="cpu"``.
The port imports nothing of JAX or of the JAX package.
"""

from .checkpoint import Checkpointer, load_reference_weights, params_from_jax
from .config import get_cfg
from .engine import (Trainer, create_train_state, make_multi_train_step,
                     make_train_step)
from .engine.defaults import AsyncPredictor, DefaultPredictor
from .evaluation import (PascalVOCDetectionEvaluator, inference_on_dataset,
                         make_detect_fn)
from .models import build_model
from .ops import multiclass_nms, roi_pool_batched
from .postprocessing import rescale_boxes
from .solver import build_optimizer
from .structures import WSODBatch
from .synthetic import synthetic_batch
from .tta import GeneralizedRCNNWithTTAAVG

__all__ = ["AsyncPredictor", "Checkpointer", "DefaultPredictor",
           "GeneralizedRCNNWithTTAAVG", "PascalVOCDetectionEvaluator",
           "Trainer", "WSODBatch", "build_model", "build_optimizer",
           "create_train_state", "get_cfg", "inference_on_dataset",
           "load_reference_weights", "make_detect_fn",
           "make_multi_train_step", "make_train_step", "multiclass_nms",
           "params_from_jax", "rescale_boxes", "roi_pool_batched",
           "synthetic_batch"]
