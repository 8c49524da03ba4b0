"""What every run of the benchmark shares: the checkout's files found by
name, the run's seeds, the weights drawn from them, the card's name and
power limit, the process's age and CPU share, the look for JAX, and the
result's line.

Nothing here imports the program at module level, and nothing imports
JAX or the JAX package at all.
"""

from __future__ import annotations

import ast
import copy
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# what must never be loaded in a run's process, by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "drn_wsod_tpu")


def cache_env() -> Dict[str, str]:
    """Fixed directories inside the checkout for every cache a run may
    fill (the program builds its CUDA sources into ``build/drn_wsod_torch``
    by itself), and ``USE_FLAX=0``."""
    base = ROOT / "build" / "h100_bench"
    return {"TRITON_CACHE_DIR": str(base / "triton"),
            "TORCHINDUCTOR_CACHE_DIR": str(base / "inductor"),
            "USE_FLAX": "0"}


def process_age_s() -> float:
    """Seconds since this process started, from /proc (its start in clock
    ticks after boot against the uptime)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


@dataclasses.dataclass(frozen=True)
class Seeds:
    traffic: int     # the records (numpy Generator)
    weights: int     # the weights (torch.Generator on the device)
    sample: int      # which answers the reference checks


def derive_seeds(seed: int) -> Seeds:
    """Independent streams of one ``--seed`` of any size."""
    s = np.random.SeedSequence(abs(int(seed))).generate_state(3, np.uint64)
    return Seeds(traffic=int(s[0] >> 1), weights=int(s[1] >> 1),
                 sample=int(s[2] >> 1))


# ------------------------------------------------------------ files by name

def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _decode(v):
    """YAML's Python-literal strings ("(480, 576)") as values."""
    if isinstance(v, dict):
        return {k: _decode(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_decode(x) for x in v]
    if isinstance(v, str) and v[:1] in "([":
        try:
            return ast.literal_eval(v)
        except (ValueError, SyntaxError):
            return v
    return v


def set_dotted(d: dict, key: str, value) -> None:
    parts = key.split(".")
    for p in parts[:-1]:
        d = d.setdefault(p, {})
    d[parts[-1]] = value


def load_config(name: str, extra: Optional[dict] = None) -> dict:
    """A configuration's file (``configs/<name>.json``): the values it
    states where the YAML leaves them to the defaults, the YAML over them,
    its overrides and ``extra`` ({dotted key: value}, the CPU tests' small
    sizes) over that, merged under "merged". The program is given every
    one of them."""
    with open(HERE / "configs" / f"{name}.json") as f:
        conf = json.load(f)
    merged = {}
    for k, v in conf["stated"].items():
        set_dotted(merged, k, v)
    _merge(merged, _decode(copy.deepcopy(conf["yaml"])))
    for k, v in {**conf["overrides"], **(extra or {})}.items():
        set_dotted(merged, k, v)
    conf["merged"] = merged
    return conf


def _merge(into: dict, other: dict) -> None:
    for k, v in other.items():
        if isinstance(v, dict) and isinstance(into.get(k), dict):
            _merge(into[k], v)
        else:
            into[k] = v


def load_mix(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def load_limits(workload: str) -> dict:
    with open(HERE / "limits" / f"{workload}.json") as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    """The driver module ``drivers/<name>.py``."""
    return load_module(HERE / "drivers" / f"{name}.py",
                       f"h100_bench_driver_{name}")


def metric_reader(name: str):
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    return load_module(HERE / "metrics" / f"{name}.py",
                       "h100_bench_metric_" + name.replace(".", "_")).read


# ------------------------------------------------------------------ weights

def make_weights(leaves, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of the architecture drawn from ``seed`` on ``device``
    by its rule, float32: one normal and one uniform draw for all of
    them, sliced and scaled."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n_norm = sum(int(np.prod(l.shape)) for l in leaves if l.init == "normal")
    n_unif = sum(int(np.prod(l.shape)) for l in leaves if l.init == "uniform")
    normal = torch.randn(n_norm, generator=gen, device=device)
    uniform = torch.rand(n_unif, generator=gen, device=device)
    out, at_n, at_u = {}, 0, 0
    for l in leaves:
        n = int(np.prod(l.shape))
        if l.init == "normal":
            t = normal[at_n:at_n + n].view(l.shape) * l.scale
            at_n += n
        elif l.init == "uniform":
            t = (uniform[at_u:at_u + n].view(l.shape) * 2.0 - 1.0) * l.scale
            at_u += n
        else:
            t = torch.full(l.shape, l.scale, device=device)
        out[l.name] = t
    return out


@torch.no_grad()
def load_into(model: torch.nn.Module, W: Dict[str, torch.Tensor]) -> None:
    """Copy ``W`` over the program's parameters and persistent buffers,
    which must be exactly its names and shapes (each rounds to the dtype the
    program stores it in)."""
    state = dict(model.named_parameters())
    state.update({n: b for n, b in model.named_buffers()
                  if n in model.state_dict()})
    if set(state) != set(W):
        missing = sorted(set(W) - set(state))[:5]
        extra = sorted(set(state) - set(W))[:5]
        raise RuntimeError(f"the program's model is not the configuration's:"
                           f" missing {missing}, unexpected {extra}")
    for n, t in state.items():
        if tuple(t.shape) != tuple(W[n].shape):
            raise RuntimeError(f"{n}: the program has {tuple(t.shape)}, the "
                               f"configuration {tuple(W[n].shape)}")
        t.copy_(W[n])


# --------------------------------------------------------------- the device

def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card(dev: torch.device, count: int) -> dict:
    """The card's name and power limit as nvidia-smi reads them, and the
    count of cards used."""
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": "n/a", "count": count}
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={dev.index or 0}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        name, limit = [s.strip() for s in out.split(",")][:2]
    except (OSError, ValueError, subprocess.SubprocessError):
        name, limit = torch.cuda.get_device_name(dev), "unknown"
    return {"name": name, "power_limit": limit, "count": count}


def device_block(dev: torch.device, count: int, peak_bytes: int) -> dict:
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": kind, "count": count, "memory_peak_bytes": int(peak_bytes)}


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ------------------------------------------------------------- host load

def host_sample() -> tuple:
    """(wall s, this process's CPU s, all threads)."""
    t = os.times()
    return time.perf_counter(), t.user + t.system


def host_load(a: tuple, b: tuple) -> dict:
    """This process's CPU time between two ``host_sample`` readings over
    the wall time (1.0 = one core busy all along), and the machine's CPU
    count: where the host issues the device's work, a process that gets
    fewer cores issues it slower."""
    return {"process_cores": (b[1] - a[1]) / max(b[0] - a[0], 1e-9),
            "cpus": os.cpu_count()}


# --------------------------------------------------------------- the result

def percentile(values, q: float) -> float:
    """The q-th percentile, linear between the order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def emit(result: dict, checks: List[dict]) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error; then the result's line, with them under "checks" last,
    as the last line of standard output. Refuses, printing nothing, where
    JAX, flax or the JAX package is loaded in this process by now: after
    the window, the metric readers and the reference."""
    loaded = forbidden_loaded()
    if loaded:
        raise RuntimeError(f"loaded in the run's process: {loaded}; "
                           "no result")
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"({'ok' if c['ok'] else 'FAILED'})", file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in checks}
    print(json.dumps(line), flush=True)


def now() -> float:
    return time.perf_counter()


def log(msg: str) -> None:
    """A phase of the run on standard error, with the process's age."""
    print(f"[h100_bench {process_age_s():7.1f} s] {msg}", file=sys.stderr,
          flush=True)
