"""The configs of the repo's ``configs/`` by their relative path, and the
models they build (counterpart of ``drn_wsod_tpu/model_zoo.py``, Detectron2's
``model_zoo``)."""

from __future__ import annotations

import os

from .config import CfgNode, get_cfg

_CONFIG_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def get_config_file(config_path: str) -> str:
    """The file of a path relative to ``configs/``, such as
    'PascalVOC-Detection/oicr_WSR_50_DC5_1x.yaml'."""
    full = os.path.join(_CONFIG_ROOT, config_path)
    if not os.path.exists(full):
        raise FileNotFoundError(f"{config_path} not found in {_CONFIG_ROOT}")
    return full


def get_config(config_path: str, trained: bool = False) -> CfgNode:
    """The port's config of ``config_path``; ``MODEL.WEIGHTS`` cleared
    unless ``trained``."""
    cfg = get_cfg()
    cfg.merge_from_file(get_config_file(config_path))
    if not trained:
        cfg.MODEL.WEIGHTS = ""
    return cfg


def get(config_path: str, trained: bool = False, device=None):
    """(cfg, model) of ``config_path``, the model built on ``device`` (CUDA
    unless the caller names another one) with random weights; with
    ``trained``, ``MODEL.WEIGHTS`` loaded where the file exists here."""
    from .checkpoint import load_reference_weights
    from .models import build_model

    cfg = get_config(config_path, trained)
    model = build_model(cfg, device=device)
    if trained and cfg.MODEL.WEIGHTS and os.path.exists(cfg.MODEL.WEIGHTS):
        load_reference_weights(cfg.MODEL.WEIGHTS, model)
    return cfg, model
