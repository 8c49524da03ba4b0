"""Utilities (counterpart of ``drn_wsod_tpu/utils``): seeding and the
environment report, throttled logging, the out-of-memory retry; the
visualizers (``visualizer``, ``video_visualizer``) draw in numpy, without
Pillow."""

from .env import collect_env_info, seed_all_rng
from .logger import log_every_n, log_every_n_seconds, log_first_n
from .memory import retry_if_oom

__all__ = ["collect_env_info", "seed_all_rng", "retry_if_oom",
           "log_every_n", "log_every_n_seconds", "log_first_n"]
