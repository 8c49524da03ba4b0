"""Narrow-dtype max probe (counterpart of the JAX package's
``tools/mosaic_dtype_probe.py``, kept under its name).

    python -m drn_wsod_torch.tools.mosaic_dtype_probe

The JAX tool probed which narrow dtypes the TPU's Mosaic compiler lowers in
a Pallas kernel (a static slice and a max, the op mix a quantized RoIPool
table would need). On Hopper it probes that ``nvcc`` for ``sm_90a`` builds
and runs the same max, ``csrc/narrow_max.cu`` (K4), in each dtype: bf16,
int8, uint8, float8 e4m3fn and e5m2, and int4 (two to a byte). The input is
the JAX tool's, ``arange(16 * 512) / 8192`` as a (16, 512) float32 array
cast to the dtype (all zeros in the integer dtypes); the kernel's max of
rows 0-7 and rows 8-15 is held bit for bit against the plain version. One
line per dtype, ``OK``, ``WRONG-RESULT`` or ``FAIL (...)``, with the card's
name and power limit; the tool exits 1 unless every line is OK.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, List, Optional, Tuple

import torch

from drn_wsod_torch.tools.ablate_bench import card


def probe(kind: str, device) -> str:
    from drn_wsod_torch.ops.narrow_max import (narrow_max, narrow_max_plain,
                                               probe_input)

    try:
        x = probe_input(kind, device)
        out = narrow_max(x, kind)
        expect = narrow_max_plain(x, kind)
        ok = torch.equal(out.view(torch.uint8), expect.view(torch.uint8))
        return "OK" if ok else "WRONG-RESULT"
    except Exception as e:  # a build or launch failure is this probe's answer
        return f"FAIL ({type(e).__name__}: {str(e)[:120]})"


def run(device=None, emit: Optional[Callable[[str, str], None]] = None
        ) -> List[Tuple[str, str]]:
    """(kind, result) for each dtype, in the JAX tool's order; ``device``
    is CUDA unless the caller names another."""
    from drn_wsod_torch.device import resolve_device
    from drn_wsod_torch.ops.narrow_max import KINDS

    dev = resolve_device(device)
    out = []
    for kind in KINDS:
        out.append((kind, probe(kind, dev)))
        if emit is not None:
            emit(*out[-1])
    return out


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        print("mosaic_dtype_probe: no CUDA device; the probe runs the card's "
              "kernels", file=sys.stderr)
        return 1
    tag = f"[{card()}]"
    rows = run(emit=lambda kind, result: print(f"{kind:16s} {result} {tag}",
                                               flush=True))
    return 0 if all(result == "OK" for _, result in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
