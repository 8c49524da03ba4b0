"""The port's own config copy merges every YAML of the config zoo to the
same tree as the JAX package's (or fails the same way)."""

import pytest

import drn_wsod_torch
from drn_wsod_tpu.config import get_cfg as jax_get_cfg
from test_torch_common import CONFIGS, FLAGSHIP

YAMLS = sorted(str(p.relative_to(CONFIGS)) for p in CONFIGS.rglob("*.yaml"))


def _merged(get_cfg, path):
    cfg = get_cfg()
    try:
        cfg.merge_from_file(path)
    except (KeyError, ValueError) as e:
        return type(e).__name__
    return cfg.to_dict()


def test_defaults_match():
    assert drn_wsod_torch.get_cfg().to_dict() == jax_get_cfg().to_dict()


def test_flagship_matches():
    got = _merged(drn_wsod_torch.get_cfg, FLAGSHIP)
    assert got == _merged(jax_get_cfg, FLAGSHIP)
    assert got["MODEL"]["ROI_BOX_HEAD"]["DAN_DIM"] == [2048, 4096]
    assert got["MODEL"]["DTYPE"] == "bfloat16"


@pytest.mark.parametrize("path", YAMLS)
def test_zoo_config_matches(path):
    path = str(CONFIGS / path)
    assert _merged(drn_wsod_torch.get_cfg, path) == _merged(jax_get_cfg, path)


def test_overrides_freeze_and_clone():
    cfg = drn_wsod_torch.get_cfg()
    cfg.merge_from_list(["MODEL.DTYPE", "float32",
                         "MODEL.ROI_BOX_HEAD.DAN_DIM", "[64, 64]",
                         "INPUT.MIN_SIZE_TRAIN", "(480, 512)"])
    assert cfg.MODEL.ROI_BOX_HEAD.DAN_DIM == [64, 64]
    assert cfg.INPUT.MIN_SIZE_TRAIN == (480, 512)
    frozen = cfg.clone().freeze()
    with pytest.raises(AttributeError):
        frozen.MODEL.DTYPE = "bfloat16"
    with pytest.raises(KeyError):
        cfg.merge_from_list(["MODEL.NO_SUCH_KEY", "1"])
