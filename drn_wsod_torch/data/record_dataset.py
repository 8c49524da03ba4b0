"""Packed record shards (counterpart of ``drn_wsod_tpu/data/record_dataset.py``).

Records are packed once (``drn_wsod_torch.tools.pack_dataset``) with the
images already decoded, so training reads one slice of a memory map and
unpickles it per sample: no file IO per image and no JPEG decode.

The format is the JAX package's (``native/record_io.cpp``), read and written
here with Python's ``mmap`` and numpy, so a shard written by either package
reads in the other:

    header:  int64 magic 0x57534F445245435A ("WSODRECZ"), int64 count,
             int64 index offset
    records: the pickled payloads, back to back
    index:   count x (int64 offset, int64 length)

All integers are in the machine's byte order, as the C++ writer stores them.
Payloads are pickles and are trusted: load only shards from a known source.
"""

from __future__ import annotations

import mmap
import os
import pickle
from typing import Iterable, List

import numpy as np

MAGIC = 0x57534F445245435A
_HEADER = 3 * 8


def write_records(path: str, records: Iterable[dict]) -> int:
    """Pack picklable records into a shard at ``path`` (written to a
    temporary file in the same directory, then renamed into place).
    Returns the record count."""
    payloads = [pickle.dumps(r, protocol=pickle.HIGHEST_PROTOCOL)
                for r in records]
    lengths = np.asarray([len(p) for p in payloads], dtype=np.int64)
    offsets = _HEADER + np.cumsum(lengths) - lengths
    index_offset = _HEADER + int(lengths.sum())
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(np.asarray([MAGIC, len(payloads), index_offset],
                               dtype=np.int64).tobytes())
            for p in payloads:
                f.write(p)
            f.write(np.stack([offsets, lengths], axis=1)
                    .astype(np.int64).tobytes())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return len(payloads)


class RecordDataset:
    """Random-access list of the records of one shard."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size < _HEADER:
                raise ValueError(f"{path}: not a record shard (too short)")
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        magic, n, index_offset = np.frombuffer(self._map, np.int64, 3)
        if int(magic) != MAGIC:
            self._map.close()
            raise ValueError(f"{path}: not a record shard (bad magic)")
        self._n = int(n)
        self._index = np.frombuffer(self._map, np.int64, 2 * self._n,
                                    int(index_offset)).reshape(-1, 2)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> dict:
        if not 0 <= i < self._n:
            raise IndexError(i)
        off, length = (int(v) for v in self._index[i])
        return pickle.loads(self._map[off:off + length])

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def close(self):
        if self._map is not None:
            self._index = None
            self._map.close()
            self._map = None

    def __del__(self):  # noqa: D105
        try:
            self.close()
        except (AttributeError, BufferError):
            pass


def pack_dataset(records: List[dict], path: str,
                 decode_images: bool = True) -> int:
    """Pack dataset records into a shard, with each image's decoded BGR
    pixels under "image" (``decode_images``) so that training skips the
    decode. The pixels come from ``mapper.read_image``: JPEG files decode
    with the port's own decoder, without Pillow; other formats need
    Pillow."""
    from .mapper import read_image

    def gen():
        for r in records:
            out = dict(r)
            if decode_images and "file_name" in r and "image" not in r:
                out["image"] = read_image(r["file_name"], "BGR")
            yield out

    return write_records(path, gen())
