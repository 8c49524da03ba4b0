"""Metric storage and writers (counterpart of
``drn_wsod_tpu/engine/events.py``): a per-iteration history of named
scalars with smoothing, drained periodically by writers (the terminal
printer, ``metrics.json``, TensorBoard)."""

from __future__ import annotations

import datetime
import json
import logging
import os
from collections import defaultdict, deque
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)

_CURRENT_STORAGE_STACK = []


def get_event_storage() -> "EventStorage":
    """The innermost ``with EventStorage(...)`` storage."""
    if not _CURRENT_STORAGE_STACK:
        raise RuntimeError("get_event_storage() must be called inside a "
                           "'with EventStorage(...)'")
    return _CURRENT_STORAGE_STACK[-1]


class HistoryBuffer:
    """Bounded history of (value, iteration) with a running global mean."""

    def __init__(self, max_length: int = 1000000, window: int = 20):
        self._data: deque = deque(maxlen=max_length)
        self._window = window
        self._count = 0
        self._global_avg = 0.0

    def update(self, value: float, iteration: int):
        self._data.append((value, iteration))
        self._count += 1
        self._global_avg += (value - self._global_avg) / self._count

    def latest(self) -> float:
        return self._data[-1][0]

    def median(self, window: int = 20) -> float:
        vals = sorted(v for v, _ in list(self._data)[-window:])
        return vals[len(vals) // 2]

    def avg(self, window: int = 20) -> float:
        vals = [v for v, _ in list(self._data)[-window:]]
        return sum(vals) / max(len(vals), 1)

    def global_avg(self) -> float:
        return self._global_avg

    def values(self):
        return list(self._data)


class EventStorage:
    """Scalars (and images, for TensorBoard) put at the current iteration;
    the trainer advances the iteration with :meth:`step`."""

    def __init__(self, start_iter: int = 0):
        self._history: Dict[str, HistoryBuffer] = defaultdict(HistoryBuffer)
        self._iter = start_iter
        self._latest: Dict[str, tuple] = {}
        self._smoothing_hints: Dict[str, bool] = {}
        self._images: list = []

    @property
    def iter(self) -> int:
        return self._iter

    def put_scalar(self, name: str, value, smoothing_hint: bool = True):
        value = float(value)
        self._history[name].update(value, self._iter)
        self._latest[name] = (value, self._iter)
        self._smoothing_hints[name] = smoothing_hint

    def put_scalars(self, *, smoothing_hint: bool = True, **kwargs):
        for k, v in kwargs.items():
            self.put_scalar(k, v, smoothing_hint=smoothing_hint)

    def put_image(self, name: str, img):
        """Attach an (H, W, 3) uint8 RGB image to the current iteration;
        drained by :class:`TensorboardWriter`."""
        self._images.append((name, img, self._iter))

    def images(self):
        return list(self._images)

    def clear_images(self):
        self._images = []

    def history(self, name: str) -> HistoryBuffer:
        return self._history[name]

    def histories(self):
        return self._history

    def latest(self):
        return dict(self._latest)

    def latest_with_smoothing_hint(self, window: int = 20):
        """{name: (value, iteration)}: the median over ``window`` for a
        smoothed scalar, the latest value otherwise."""
        out = {}
        for k, (v, it) in self._latest.items():
            out[k] = (self._history[k].median(window)
                      if self._smoothing_hints.get(k) else v, it)
        return out

    def step(self):
        self._iter += 1

    def __enter__(self):
        _CURRENT_STORAGE_STACK.append(self)
        return self

    def __exit__(self, *args):
        assert _CURRENT_STORAGE_STACK[-1] is self
        _CURRENT_STORAGE_STACK.pop()


class EventWriter:
    def write(self, storage: EventStorage):
        raise NotImplementedError

    def close(self):
        pass


class JSONWriter(EventWriter):
    """Appends one JSON line per write to ``json_file``: the iteration and
    every scalar, smoothed where its hint says so."""

    def __init__(self, json_file: str, window: int = 20):
        os.makedirs(os.path.dirname(json_file) or ".", exist_ok=True)
        self._file = open(json_file, "a")
        self._window = window

    def write(self, storage: EventStorage):
        record = {"iteration": storage.iter}
        for k, (v, _) in storage.latest_with_smoothing_hint(
                self._window).items():
            record[k] = v
        self._file.write(json.dumps(record, sort_keys=True) + "\n")
        self._file.flush()

    def close(self):
        self._file.close()


class TensorboardWriter(EventWriter):
    """TensorBoard event files through ``torch.utils.tensorboard``, which
    needs the ``tensorboard`` package (an ImportError names it where it is
    missing): smoothed scalars and any ``put_image`` payloads, then cleared.
    Images are encoded by the port's PNG writer (``data/png.py``) into the
    image summary directly: ``add_image`` would need Pillow."""

    def __init__(self, log_dir: str, window: int = 20):
        from torch.utils.tensorboard import SummaryWriter

        self._writer = SummaryWriter(log_dir)
        self._window = window

    def write(self, storage: EventStorage):
        for k, (v, it) in storage.latest_with_smoothing_hint(
                self._window).items():
            self._writer.add_scalar(k, v, it)
        if storage.images():
            from tensorboard.compat.proto.summary_pb2 import Summary

            from ..data.png import encode_png

            for name, img, it in storage.images():
                img = np.ascontiguousarray(img, np.uint8)
                h, w, c = img.shape
                image = Summary.Image(height=h, width=w, colorspace=c,
                                      encoded_image_string=encode_png(img))
                self._writer._get_file_writer().add_summary(
                    Summary(value=[Summary.Value(tag=name, image=image)]),
                    it)
        storage.clear_images()

    def close(self):
        self._writer.close()


class CommonMetricPrinter(EventWriter):
    """Logs the ETA, the losses' medians, data_time and lr."""

    def __init__(self, max_iter: int):
        self._max_iter = max_iter

    def write(self, storage: EventStorage):
        iteration = storage.iter
        eta = ""
        hist = storage.histories()
        if "time" in hist and hist["time"].values():
            eta_seconds = hist["time"].global_avg() * (self._max_iter
                                                       - iteration)
            eta = f"eta: {datetime.timedelta(seconds=int(eta_seconds))}  "
        losses = [f"{k}: {h.median(20):.4g}"
                  for k, h in hist.items() if "loss" in k]
        lr = ""
        if "lr" in hist and hist["lr"].values():
            lr = f"lr: {hist['lr'].latest():.5g}  "
        data_time = ""
        if "data_time" in hist and hist["data_time"].values():
            data_time = f"data_time: {hist['data_time'].avg(20):.4f}  "
        logger.info(
            f"{eta}iter: {iteration}  {'  '.join(losses)}  {data_time}{lr}")
