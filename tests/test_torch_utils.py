"""The port's ``utils`` (``env``, ``logger``, ``memory``) and ``model_zoo``
against the JAX package's modules where they behave the same: the seeding
of numpy and ``random``, the throttled loggers' counts, the config of every
YAML of the zoo; and what is the port's own: torch seeded too, the
environment report without JAX, ``retry_if_oom`` on a raised
``torch.OutOfMemoryError``, ``model_zoo.get`` building on the device it is
given (and refusing a missing CUDA device)."""

import logging
import random

import numpy as np
import pytest
import torch

from drn_wsod_torch import model_zoo as pzoo
from drn_wsod_torch import utils as putils
from drn_wsod_torch.utils import logger as plogger
from drn_wsod_tpu import model_zoo as jzoo
from drn_wsod_tpu import utils as jutils
from drn_wsod_tpu.utils import logger as jlogger
from test_torch_common import CONFIGS

YAMLS = sorted(str(p.relative_to(CONFIGS)) for p in CONFIGS.rglob("*.yaml"))


def _draws():
    return (np.random.rand(3).tolist(), random.random())


def test_seed_all_rng_seeds_numpy_random_and_torch(monkeypatch):
    monkeypatch.delenv("PYTHONHASHSEED", raising=False)
    assert jutils.seed_all_rng(1234) == 1234
    want = _draws()
    assert putils.seed_all_rng(1234) == 1234
    assert _draws() == want
    got_t = torch.rand(4)
    torch.manual_seed(1234)
    assert torch.equal(got_t, torch.rand(4))
    import os

    assert os.environ["PYTHONHASHSEED"] == "1234"
    seed = putils.seed_all_rng()
    assert isinstance(seed, int) and 0 <= seed < 2 ** 32


def test_collect_env_info_reports_torch_not_jax():
    info = putils.collect_env_info()
    lines = dict(ln.split(": ", 1) for ln in info.splitlines()
                 if ": " in ln)
    assert lines["torch"] == torch.__version__
    assert lines["numpy"] == np.__version__
    assert "python" in lines and "nvcc" in lines and "torch CUDA" in lines
    assert "jax" not in info.lower() and "flax" not in info.lower()
    if not torch.cuda.is_available():
        assert "cards: none" in info


class _Count(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture
def counted():
    """A handler on a logger of its own; returns (name, handler)."""
    name = "torch_utils_test"
    lg = logging.getLogger(name)
    h = _Count()
    lg.addHandler(h)
    lg.setLevel(logging.DEBUG)
    yield name, h
    lg.removeHandler(h)


def _fire(module, name, fn, calls, *args, **kw):
    """``calls`` calls from one line of ``module``'s throttled logger."""
    for i in range(calls):
        getattr(module, fn)(logging.INFO, f"m{i % 2}", *args, name=name, **kw)


@pytest.mark.parametrize("fn,args,kw,calls", [
    ("log_first_n", (2,), {}, 5),
    ("log_first_n", (1,), {"key": "message"}, 5),
    ("log_first_n", (1,), {"key": ("caller", "message")}, 6),
    ("log_every_n", (3,), {}, 7),
])
def test_throttled_loggers_count_as_jax(counted, fn, args, kw, calls):
    name, h = counted
    _fire(jlogger, name, fn, calls, *args, **kw)
    want = list(h.messages)
    h.messages.clear()
    _fire(plogger, name, fn, calls, *args, **kw)
    assert h.messages == want and want


def test_log_every_n_seconds_counts_as_jax(counted, monkeypatch):
    name, h = counted
    import types

    for module in (jlogger, plogger):
        clock = iter([0.0, 0.5, 1.2, 1.3, 2.5, 2.6])
        monkeypatch.setattr(module, "time", types.SimpleNamespace(
            time=lambda: next(clock)))
        for _ in range(6):
            module.log_every_n_seconds(logging.INFO, "tick", 1, name=name)
    assert h.messages == ["tick"] * 6     # t = 0, 1.2, 2.5 in each


def test_retry_if_oom(monkeypatch):
    emptied = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: emptied.append(True))

    def oom(x):
        raise torch.OutOfMemoryError("CUDA out of memory")

    assert putils.retry_if_oom(oom, fallback=lambda x: x * 2)(21) == 42
    assert emptied == [True]
    with pytest.raises(torch.OutOfMemoryError):
        putils.retry_if_oom(oom)(1)
    assert emptied == [True, True]

    def other(x):
        raise ValueError("not memory")

    with pytest.raises(ValueError):
        putils.retry_if_oom(other, fallback=lambda x: x)(1)
    assert putils.retry_if_oom(lambda x: x + 1)(1) == 2
    assert len(emptied) == 2


def _merged(zoo, path, trained):
    try:
        return zoo.get_config(path, trained=trained).to_dict()
    except (KeyError, ValueError) as e:
        return type(e).__name__


@pytest.mark.parametrize("path", YAMLS)
def test_model_zoo_config_matches_jax(path):
    assert pzoo.get_config_file(path) == jzoo.get_config_file(path)
    for trained in (False, True):
        got = _merged(pzoo, path, trained)
        assert got == _merged(jzoo, path, trained)
        if isinstance(got, dict) and not trained:
            assert got["MODEL"]["WEIGHTS"] == ""


def test_model_zoo_missing_file_and_device():
    with pytest.raises(FileNotFoundError):
        pzoo.get_config_file("PascalVOC-Detection/nope.yaml")
    path = "PascalVOC-Detection/oicr_WSR_18_DC5_1x.yaml"
    cfg, model = pzoo.get(path, device="meta")
    assert cfg.MODEL.WEIGHTS == ""
    assert next(model.parameters()).device.type == "meta"
    assert model.box_head.fc1.weight.shape[0] == \
        cfg.MODEL.ROI_BOX_HEAD.DAN_DIM[0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pzoo.get(path)
