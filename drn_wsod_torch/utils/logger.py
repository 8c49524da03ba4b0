"""Throttled logging (counterpart of ``drn_wsod_tpu/utils/logger.py``):
``log_first_n``, ``log_every_n`` and ``log_every_n_seconds``, keyed by the
calling line by default, so that independent call sites throttle
independently."""

from __future__ import annotations

import logging
import sys
import time
from typing import Dict, Tuple

_LOG_COUNTER: Dict[Tuple, int] = {}
_LOG_TIMER: Dict[Tuple, float] = {}


def _caller_key():
    # the first frame outside this module
    frame = sys._getframe(1)
    while frame and frame.f_code.co_filename == __file__:
        frame = frame.f_back
    return (frame.f_code.co_filename, frame.f_lineno)


def _find_key(key, msg):
    if key == "caller":
        return _caller_key()
    if key == "message":
        return (msg,)
    return _caller_key() + (msg,)


def log_first_n(lvl: int, msg: str, n: int = 1, *, name: str | None = None,
                key: str = "caller"):
    """Log only the first ``n`` times this call site (``key`` "caller"),
    this message ("message") or both (anything else) fires."""
    k = _find_key(key, msg)
    _LOG_COUNTER[k] = _LOG_COUNTER.get(k, 0) + 1
    if _LOG_COUNTER[k] <= n:
        logging.getLogger(name or "drn_wsod_torch").log(lvl, msg)


def log_every_n(lvl: int, msg: str, n: int = 1, *, name: str | None = None):
    """Log on the first of every ``n`` calls from this call site."""
    k = _caller_key()
    _LOG_COUNTER[k] = _LOG_COUNTER.get(k, 0) + 1
    if (_LOG_COUNTER[k] - 1) % n == 0:
        logging.getLogger(name or "drn_wsod_torch").log(lvl, msg)


def log_every_n_seconds(lvl: int, msg: str, n: int = 1, *,
                        name: str | None = None):
    """Log at most once every ``n`` seconds from this call site."""
    k = _caller_key()
    now = time.time()
    last = _LOG_TIMER.get(k)
    if last is None or now - last >= n:
        logging.getLogger(name or "drn_wsod_torch").log(lvl, msg)
        _LOG_TIMER[k] = now
