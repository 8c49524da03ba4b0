"""The program's spans (``drn_wsod_torch/utils/tracing.py``) laid over the
device trace of a traced sub-window.

Each device operation is joined to the CUDA runtime call that launched it
(the same ``correlation_id``) and put down to the innermost span open on the
launching thread at the launch's start. A thread with no spans is the
autograd engine's device thread running a backward: its launches go to the
loop thread's innermost span at that moment, which is ``train.backward``.
The launching thread is known by the key that kineto gives a runtime call:
on the H100's torch 2.11 ``device_resource_id()`` holds the thread's
``threading.get_ident()`` cut to a signed 32-bit integer, and
``start_thread_id()`` holds 1 for every thread (PERF.md, section 3).
Where no launch's key matches a thread of the spans, every operation falls
to the loop thread by time.

Both clocks are the Unix epoch in nanoseconds. From them:

* ``device_by_span``: device seconds (the union of the operations'
  intervals) by the path of the span each was put down to, top 10;
* ``idle_by_span``: each idle gap between the device's operations put down
  to the loop thread's innermost span at its start and, where the prefetch
  thread was inside one of its spans then, that span too; seconds by
  label, top 10;
* ``counters``: each counter's total over the window;
* the readings that a per-layer metric of a traced cell would give
  (``READINGS``), each ``None`` where the run recorded no spans.

The benchmark's drivers do not turn the recorder on (PERF.md, Open
questions): ``span_probe.py`` runs a cell's traced sub-window with it on.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np

from h100_bench.trace import merged

OUTSIDE = "outside any span"
LOOP_PREFIXES = ("train.", "tta.")
PREFETCH_PREFIX = "prefetch."


class Op(NamedTuple):
    """A device operation and the runtime call that launched it."""
    name: str
    start_ns: int
    end_ns: int
    launch_ns: Optional[int]      # None: no launch found in the trace
    thread: Optional[int]         # the launching thread's key


class Call(NamedTuple):
    """A CUDA runtime call on the host."""
    name: str
    start_ns: int
    end_ns: int
    thread: Optional[int]


def int32(x: int) -> int:
    return (int(x) + 2 ** 31) % 2 ** 32 - 2 ** 31


def kineto_rows(events, cuda):
    """(device operations, runtime calls) from kineto events (``prof.
    profiler.kineto_results.events()``); ``cuda`` is the device type of
    the device's operations."""
    launches, calls, device = {}, [], []
    for e in events:
        if e.device_type() == cuda:
            device.append(e)
        elif e.name().startswith("cu"):
            start = e.start_ns()
            c = Call(e.name(), start, start + e.duration_ns(),
                     int32(e.device_resource_id()))
            calls.append(c)
            launches.setdefault(e.correlation_id(), c)
    ops = []
    for e in device:
        c = launches.get(e.correlation_id())
        if c is None and e.linked_correlation_id():
            c = launches.get(e.linked_correlation_id())
        start = e.start_ns()
        ops.append(Op(e.name(), start, start + e.duration_ns(),
                      None if c is None else c.start_ns,
                      None if c is None else c.thread))
    return ops, calls


def union_ns(intervals) -> int:
    return int(sum(e - s for s, e in merged(intervals)))


def innermost(spans, times) -> list:
    """For each of ``times``, the innermost of ``spans`` (one thread's,
    nested) that holds it (start <= t < end), or None."""
    spans = sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))
    times = np.asarray(times, np.int64)
    out = [None] * len(times)
    stack, i = [], 0
    for q in np.argsort(times, kind="stable"):
        t = times[q]
        while i < len(spans) and spans[i].start_ns <= t:
            s = spans[i]
            i += 1
            while stack and stack[-1].end_ns <= s.start_ns:
                stack.pop()
            stack.append(s)
        while stack and stack[-1].end_ns <= t:
            stack.pop()
        out[q] = stack[-1] if stack else None
    return out


def _role_thread(spans, prefixes) -> Optional[int]:
    counts: Dict[int, int] = {}
    for s in spans:
        if s.name.startswith(prefixes):
            counts[s.tid] = counts.get(s.tid, 0) + 1
    return max(counts, key=counts.get) if counts else None


class Linked:
    """The device operations of a window, each put down to a span."""

    def __init__(self, spans, ops: List[Op]):
        self.spans = list(spans)
        self.ops = list(ops)
        self.by_serial = {s.serial: s for s in self.spans}
        self.threads: Dict[int, list] = {}
        for s in self.spans:
            self.threads.setdefault(s.tid, []).append(s)
        self.loop = _role_thread(self.spans, LOOP_PREFIXES)
        self.prefetch = _role_thread(self.spans, PREFETCH_PREFIX)
        key = {}
        for s in self.spans:
            key[int32(s.ident)] = s.tid
        self.key = key
        launched = [op.launch_ns is not None for op in self.ops]
        self.matched = sum(1 for op in self.ops
                           if op.thread is not None and op.thread in key)
        by_thread: Dict[Optional[int], list] = {}
        for i, op in enumerate(self.ops):
            if not launched[i]:
                continue
            tid = key.get(op.thread) if self.matched else None
            if tid is None:
                tid = self.loop
            by_thread.setdefault(tid, []).append(i)
        self.span_of: List[Optional[object]] = [None] * len(self.ops)
        for tid, idx in by_thread.items():
            if tid is None:
                continue
            found = innermost(self.threads[tid],
                              [self.ops[i].launch_ns for i in idx])
            for i, s in zip(idx, found):
                self.span_of[i] = s
        self._paths: Dict[int, str] = {}

    def path(self, s) -> str:
        if s is None:
            return OUTSIDE
        p = self._paths.get(s.serial)
        if p is None:
            parent = self.by_serial.get(s.parent)
            p = s.name if parent is None else f"{self.path(parent)}/{s.name}"
            self._paths[s.serial] = p
        return p

    def busy_ns(self) -> int:
        return union_ns([(op.start_ns, op.end_ns) for op in self.ops])

    def named_share(self) -> float:
        """The share of the device's busy time that falls to a span."""
        busy = self.busy_ns()
        named = union_ns([(op.start_ns, op.end_ns)
                          for op, s in zip(self.ops, self.span_of)
                          if s is not None])
        return named / busy if busy else 0.0

    def device_ns(self, name: str) -> int:
        """The union of the intervals of the operations put down to a span
        named ``name``."""
        return union_ns([(op.start_ns, op.end_ns)
                         for op, s in zip(self.ops, self.span_of)
                         if s is not None and s.name == name])

    def device_by_span(self, top: int = 10):
        groups: Dict[str, list] = {}
        for op, s in zip(self.ops, self.span_of):
            groups.setdefault(self.path(s), []).append(
                (op.start_ns, op.end_ns))
        rows = sorted(((p, union_ns(iv) * 1e-9) for p, iv in groups.items()),
                      key=lambda r: -r[1])
        return [[p[:160], v] for p, v in rows[:top]]

    def gaps(self):
        iv = merged([(op.start_ns, op.end_ns) for op in self.ops])
        return [(iv[i][1], iv[i + 1][0]) for i in range(len(iv) - 1)]

    def idle_labels(self, gaps):
        starts = [a for a, _ in gaps]
        loop = (innermost(self.threads[self.loop], starts)
                if self.loop is not None else [None] * len(gaps))
        pre = (innermost(self.threads[self.prefetch], starts)
               if self.prefetch is not None else [None] * len(gaps))
        return [(self.path(lp), None if pp is None else pp.name)
                for lp, pp in zip(loop, pre)]

    def idle_by_span(self, top: int = 10):
        gaps = self.gaps()
        sums: Dict[str, float] = {}
        for (a, b), (lp, pp) in zip(gaps, self.idle_labels(gaps)):
            label = lp if pp is None else f"{lp} | {pp}"
            sums[label] = sums.get(label, 0.0) + (b - a) * 1e-9
        rows = sorted(sums.items(), key=lambda kv: -kv[1])
        return [[k[:160], v] for k, v in rows[:top]]

    def idle_named_share(self) -> float:
        """The share of the idle time between operations whose start finds
        the loop thread inside a span."""
        gaps = self.gaps()
        total = sum(b - a for a, b in gaps)
        named = sum(b - a for (a, b), (lp, _) in
                    zip(gaps, self.idle_labels(gaps)) if lp != OUTSIDE)
        return named / total if total else 0.0

    def thread_role(self, key: Optional[int]) -> str:
        tid = self.key.get(key)
        if tid is None:
            return "a thread without spans"
        if tid == self.loop:
            return "loop"
        if tid == self.prefetch:
            return "prefetch"
        return f"thread {tid}"

    def longest_gaps(self, calls: List[Call], top: int = 10):
        """The ``top`` longest gaps, each with the runtime call running at
        its start (the innermost, on any thread, as ``trace.py:idle_gaps``
        names it), that call's thread, and the loop thread's span."""
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        labels = self.idle_labels(gaps)
        starts = np.asarray([c.start_ns for c in calls], np.int64)
        ends = np.asarray([c.end_ns for c in calls], np.int64)
        out = []
        for (a, b), (lp, pp) in zip(gaps, labels):
            inside = (starts <= a) & (ends > a)
            c = (calls[int(np.argmax(np.where(inside, starts, -1)))]
                 if inside.any() else None)
            out.append({"s": (b - a) * 1e-9,
                        "call": None if c is None else c.name,
                        "thread": None if c is None
                        else self.thread_role(c.thread),
                        "loop_span": lp, "prefetch_span": pp})
        return out


def linked(ctx) -> Optional[Linked]:
    """The window's operations put down to spans, made once a run, or None
    where the run recorded no spans or no operations."""
    if not ctx.get("spans") or not ctx.get("device_ops"):
        return None
    if "_linked" not in ctx:
        ctx["_linked"] = Linked(ctx["spans"], ctx["device_ops"])
    return ctx["_linked"]


def breakdown(ctx) -> dict:
    """The keys a traced run's breakdown gains: ``device_by_span``,
    ``idle_by_span`` and ``counters`` (empty where nothing was
    recorded)."""
    ln = linked(ctx)
    return {"device_by_span": [] if ln is None else ln.device_by_span(),
            "idle_by_span": [] if ln is None else ln.idle_by_span(),
            "counters": dict(ctx.get("counters") or {})}


def _count(spans, name: str) -> int:
    return sum(1 for s in spans if s.name == name)


def device_ms(ctx, kind: str, name: str, per: str) -> Optional[float]:
    """The device's milliseconds in the operations put down to spans named
    ``name``, a span named ``per`` (a step, an image)."""
    if ctx.get("kind") != kind:
        return None
    ln = linked(ctx)
    if ln is None:
        return None
    n = _count(ln.spans, per)
    ns = ln.device_ns(name)
    if not n or not ns:
        return None
    return ns * 1e-6 / n


def host_share(ctx, kind: str, name: str, of: str) -> Optional[float]:
    """The host time of the loop thread's spans named ``name`` over that of
    its spans named ``of``, in %."""
    if ctx.get("kind") != kind or not ctx.get("spans"):
        return None
    spans = ctx["spans"]
    loop = _role_thread(spans, LOOP_PREFIXES)
    part = sum(s.end_ns - s.start_ns for s in spans
               if s.tid == loop and s.name == name)
    whole = sum(s.end_ns - s.start_ns for s in spans
                if s.tid == loop and s.name == of)
    if not part or not whole:
        return None
    return 100.0 * part / whole


READINGS = {
    "backbone_device_ms.train_busy":
        lambda ctx: device_ms(ctx, "train", "model.backbone", "train.step"),
    "backward_device_ms.train_busy":
        lambda ctx: device_ms(ctx, "train", "train.backward", "train.step"),
    "backbone_device_ms.eval":
        lambda ctx: device_ms(ctx, "eval", "model.backbone", "tta.image"),
    "view_build_device_ms.eval":
        lambda ctx: device_ms(ctx, "eval", "tta.view_build", "tta.image"),
    "mining_host_share.train":
        lambda ctx: host_share(ctx, "train", "model.refine.mine",
                               "train.step"),
}
