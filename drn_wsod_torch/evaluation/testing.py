"""Result printing and verification for accuracy-regression configs
(counterpart of ``drn_wsod_tpu/evaluation/testing.py``):
``TEST.EXPECTED_RESULTS`` entries are [task, metric, expected, tolerance]."""

from __future__ import annotations

import logging
from typing import Dict

logger = logging.getLogger(__name__)


def flatten_results_dict(results: Dict) -> Dict[str, float]:
    """{"task": {"metric": v}} -> {"task/metric": float(v)}, any depth."""
    out = {}

    def rec(d, prefix=""):
        for k, v in d.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, dict):
                rec(v, key)
            elif isinstance(v, (int, float)):
                out[key] = float(v)

    rec(results)
    return out


def print_csv_format(results: Dict) -> None:
    """Log each task's metrics as ``copypaste:`` CSV lines, the form
    Detectron2's log-scraping tools read."""
    for task, metrics in results.items():
        if not isinstance(metrics, dict):
            continue
        keys = [k for k, v in metrics.items()
                if isinstance(v, (int, float))]
        if not keys:
            continue
        logger.info(f"copypaste: Task: {task}")
        logger.info("copypaste: " + ",".join(keys))
        logger.info("copypaste: " + ",".join(
            f"{float(metrics[k]):.4f}" for k in keys))


def verify_results(cfg, results: Dict) -> bool:
    """Whether every ``TEST.EXPECTED_RESULTS`` entry holds (True when there
    are none); each check is logged."""
    expected = cfg.TEST.EXPECTED_RESULTS
    if not expected:
        return True
    flat = flatten_results_dict(results)
    ok = True
    for task, metric, expected_val, tolerance in expected:
        key = f"{task}/{metric}"
        actual = flat.get(key)
        if actual is None:
            logger.error(f"verify_results: metric {key} not found in "
                         f"{sorted(flat)}")
            ok = False
            continue
        passed = abs(actual - expected_val) <= tolerance
        logger.info(f"verify_results: {key} = {actual:.4f} "
                    f"(expected {expected_val} ± {tolerance}) "
                    f"{'OK' if passed else 'FAILED'}")
        ok = ok and passed
    return ok
