"""The program's spans and counters, on the clock of ``torch.profiler``'s
device trace.

* ``span(name, id=None)``: a context manager around one part of the work.
  It records its name, start, end, the span open around it on the same
  thread (its parent), the thread (``threading.get_native_id()`` and
  ``threading.get_ident()``) and an identifier: a span given ``id`` sets
  it, and the spans opened inside it inherit it (the training step for
  ``train.*``, the image id for ``tta.*``).
* ``record(name, t0_ns, t1_ns, id=None)``: a span whose two
  ``time.perf_counter_ns()`` reads the caller made itself (the Trainer's
  wait for batches, whose duration is also its ``data_time``).
* ``count(name, n=1)``: adds ``n`` to a counter.
* ``enable()`` / ``disable()`` / ``drain()``.

Off by default. While off, ``span`` returns one shared no-op context (no
allocation, no clock read) and ``record`` and ``count`` return at once:
each costs one flag test. While on, every thread keeps its open spans and
its finished ones in a buffer of its own, with no lock on the way in;
``drain()`` takes what the buffers hold and hands it out.

The clock: spans are timed with ``time.perf_counter_ns()``. ``drain()``
puts them on the Unix epoch in nanoseconds, the clock of the profiler's
kineto events (``start_ns()``), through one pair of reads
``(time.time_ns(), time.perf_counter_ns())`` taken at ``enable()``, so that
a span and a kernel can be laid side by side with no fitting.

The recorder is one per process, as the profiler it is laid beside is.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

_perf_ns = time.perf_counter_ns
_enabled = False
_anchor = (0, 0)                   # (time.time_ns(), perf_counter_ns())
_serial = itertools.count(1)       # next() is atomic under the GIL
_local = threading.local()
_buffers: List["_Buffer"] = []     # every thread's buffer, in first-use order
_lock = threading.Lock()           # registration and the counters


class Span(NamedTuple):
    """A finished span; times in nanoseconds on the Unix epoch."""
    name: str
    start_ns: int
    end_ns: int
    serial: int                 # unique in the process
    parent: Optional[int]       # the serial of the span open around it
    tid: int                    # threading.get_native_id()
    ident: int                  # threading.get_ident()
    id: Optional[int]           # the identifier, set by the root


class _Buffer:
    __slots__ = ("stack", "done", "tid", "ident", "thread")

    def __init__(self):
        self.stack: List[_Span] = []
        self.done: List[tuple] = []
        self.tid = threading.get_native_id()
        self.ident = threading.get_ident()
        self.thread = threading.current_thread()


def _buffer() -> _Buffer:
    buf = getattr(_local, "buf", None)
    if buf is None:
        buf = _local.buf = _Buffer()
        with _lock:
            _buffers.append(buf)
    return buf


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "id", "serial", "parent", "buf", "t0")

    def __init__(self, name: str, id: Optional[int]):
        self.name, self.id = name, id

    def __enter__(self):
        buf = self.buf = _buffer()
        parent = buf.stack[-1] if buf.stack else None
        self.parent = None if parent is None else parent.serial
        if self.id is None and parent is not None:
            self.id = parent.id
        self.serial = next(_serial)
        buf.stack.append(self)
        self.t0 = _perf_ns()
        return self

    def __exit__(self, *exc):
        t1 = _perf_ns()
        buf = self.buf
        buf.stack.pop()
        buf.done.append((self.name, self.t0, t1, self.serial, self.parent,
                         self.id))
        return False


def span(name: str, id: Optional[int] = None):
    """A context manager recording ``name`` while the recorder is on."""
    if not _enabled:
        return _NOOP
    return _Span(name, id)


def record(name: str, t0_ns: int, t1_ns: int,
           id: Optional[int] = None) -> None:
    """A finished span from two ``time.perf_counter_ns()`` reads, its
    parent the span open on this thread, if any."""
    if not _enabled:
        return
    buf = _buffer()
    parent = buf.stack[-1] if buf.stack else None
    if id is None and parent is not None:
        id = parent.id
    buf.done.append((name, t0_ns, t1_ns, next(_serial),
                     None if parent is None else parent.serial, id))


_counters: Dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    if not _enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def enabled() -> bool:
    return _enabled


def enable() -> None:
    """Start recording (a no-op where the recorder is on already), and
    take the pair of clock reads that ``drain`` converts with."""
    global _enabled, _anchor
    if _enabled:
        return
    _anchor = (time.time_ns(), _perf_ns())
    _enabled = True


def disable() -> None:
    """Stop recording; spans open now still record when they close."""
    global _enabled
    _enabled = False


def drain() -> Tuple[List[Span], Dict[str, int]]:
    """Every finished span, on the profiler's clock, in each thread's order
    of closing, and the counters' totals; both cleared. A span that closes
    while the drain runs stays for the next one."""
    wall, perf = _anchor
    shift = wall - perf
    spans: List[Span] = []
    with _lock:
        buffers = list(_buffers)
        counters = dict(_counters)
        _counters.clear()
        # threads that have ended and left nothing are let go
        _buffers[:] = [b for b in _buffers
                       if b.thread.is_alive() or b.done or b.stack]
    for buf in buffers:
        n = len(buf.done)
        taken = buf.done[:n]
        del buf.done[:n]            # the owner only appends past n
        spans.extend(Span(name, t0 + shift, t1 + shift, serial, parent,
                          buf.tid, buf.ident, sid)
                     for name, t0, t1, serial, parent, sid in taken)
    return spans, counters


def merge_chrome_trace(path: str, spans: List[Span],
                       counters: Dict[str, int]) -> None:
    """Add ``spans`` to the Chrome trace that ``torch.profiler`` wrote at
    ``path``, as complete events (category ``program_span``) on their
    threads, on the trace's own clock (its ``baseTimeNanoseconds``), and
    the counters under ``programCounters``: one file shows the program's
    spans over its operators and kernels."""
    import json
    import os

    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    trace.setdefault("traceEvents", []).extend(
        {"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
         "tid": s.tid, "ts": (s.start_ns - base) / 1e3,
         "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"id": s.id, "serial": s.serial, "parent": s.parent}}
        for s in spans)
    trace["programCounters"] = dict(counters)
    with open(path, "w") as f:
        json.dump(trace, f)
