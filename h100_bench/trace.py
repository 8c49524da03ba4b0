"""The traced sub-window: ``torch.profiler`` around a call, reduced to the
device's activity (kernels, copies, fills) as intervals, their union, the
sums by name and the longest idle gaps labelled by the CUDA runtime call the
host was in at their start. Only the CUDA activity is recorded (kernels and
runtime calls, no host operators): a PCL step launches some 13,000 kernels,
and recording the host's operators too took its traced run past 300 s."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Trace:
    device: List[Tuple[str, float, float]]   # (name, start s, end s)
    host: List[Tuple[str, float, float]]
    window_s: float                          # host clock around the call

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of
        the intervals, so overlapping work counts once)."""
        return union_s([(s, e) for _, s, e in self.device])

    def by_name(self, match: str) -> List[float]:
        """Durations (s) of the device operations whose name holds
        ``match``."""
        return [e - s for n, s, e in self.device if match in n]

    def breakdown(self, top: int = 10) -> dict:
        sums = {}
        for n, s, e in self.device:
            sums[n] = sums.get(n, 0.0) + (e - s)
        ops = sorted(sums.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], v] for n, v in ops],
                "idle_gaps": self.idle_gaps(top)}

    def idle_gaps(self, top: int = 10):
        """The longest gaps between device operations, each named by the
        innermost host event running at its start."""
        iv = merged([(s, e) for _, s, e in self.device])
        gaps = [(iv[i][1], iv[i + 1][0]) for i in range(len(iv) - 1)]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        if not self.host:
            return [["unknown", b - a] for a, b in gaps]
        names = [n for n, _, _ in self.host]
        starts = np.asarray([s for _, s, _ in self.host])
        ends = np.asarray([e for _, _, e in self.host])
        out = []
        for a, b in gaps:
            inside = (starts <= a) & (ends > a)
            if inside.any():
                i = int(np.argmax(np.where(inside, starts, -np.inf)))
                label = names[i]
            else:
                label = "host outside the CUDA runtime"
            out.append([label[:160], b - a])
        return out


def merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_s(intervals) -> float:
    return float(sum(e - s for s, e in merged(intervals)))


def events(prof):
    """(device, host) events as (name, start s, end s)."""
    device, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    try:
        events = prof.profiler.kineto_results.events()
        for e in events:
            if hasattr(e, "start_ns"):
                s = e.start_ns() * 1e-9
                d = e.duration_ns() * 1e-9
            else:
                s = e.start_us() * 1e-6
                d = e.duration_us() * 1e-6
            (device if e.device_type() == cuda else host).append(
                (e.name(), s, s + d))
    except AttributeError:
        for e in prof.events():
            s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            (device if e.device_type == cuda else host).append((e.name, s, t))
    return device, host


def profiler():
    """The profiler of a traced sub-window: the CUDA activity only (the
    host's on a machine without CUDA, where the CPU tests run)."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA
                               if torch.cuda.is_available()
                               else ProfilerActivity.CPU])


def traced(fn: Callable[[], object], sync: Callable[[], None]):
    """Run ``fn`` under the profiler, fenced on both sides; returns (its
    result, the Trace)."""
    sync()
    with profiler() as prof:
        h0 = time.perf_counter()
        out = fn()
        sync()
        h1 = time.perf_counter()
    device, host = events(prof)
    return out, Trace(device=device, host=host, window_s=h1 - h0)
