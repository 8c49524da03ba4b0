"""Post-process a ``metrics.json`` event file (the port's copy of
``tools/filter_events.py``): keep the keys that contain any of
``--keys``, print each series' count, last, min and max, and optionally
write the filtered records.

    python -m drn_wsod_torch.tools.filter_events OUTPUT/metrics.json \\
        [--keys loss lr] [--out slim.json]
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict


def argument_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="drn_wsod_torch filter_events")
    p.add_argument("metrics_json")
    p.add_argument("--keys", nargs="*", default=[],
                   help="only keys containing any of these substrings")
    p.add_argument("--out", default="", help="write filtered records here")
    return p


def main(argv=None) -> dict:
    """Print the summary; returns {key: [(iteration, value), ...]}."""
    args = argument_parser().parse_args(argv)
    records = []
    with open(args.metrics_json) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))

    def keep(k):
        return not args.keys or any(s in k for s in args.keys)

    series = defaultdict(list)
    for r in records:
        it = r.get("iteration", -1)
        for k, v in r.items():
            if k != "iteration" and keep(k) and isinstance(v, (int, float)):
                series[k].append((it, v))

    for k in sorted(series):
        vals = [v for _, v in series[k]]
        last_it, last = series[k][-1]
        print(f"{k:40s} n={len(vals):5d} last={last:.5g} (it {last_it})  "
              f"min={min(vals):.5g} max={max(vals):.5g}")

    if args.out:
        with open(args.out, "w") as f:
            for r in records:
                slim = {k: v for k, v in r.items()
                        if k == "iteration" or keep(k)}
                f.write(json.dumps(slim) + "\n")
    return dict(series)


if __name__ == "__main__":
    main()
