"""The numbers that decide ``correct``: what the timed path produced against
the plain reference, each held to its cell's limit (``limits/<cell>.json``);
a number that a cell's limits do not name is printed, not compared.

Training (the first three steps of the object the window drives):
  * ``loss_gap``: the worst step's |program - reference| of the total loss
    over |reference|;
  * ``grad_gap``: the first gradient as the optimizer gets it (its trace
    after one step, decay included), the worst leaf's gap of norms over
    the larger of that leaf's reference norm and the median leaf's;
  * ``wsddn_grad_diff``: the first gradient (the trace after one step) of
    WSDDN's two weights, the norm of the program's difference from the
    reference over the reference's norm, the worse of the two. Their
    gradient takes no mined target, so no pseudo box that flips between two
    near-equal proposals moves it; and a difference, where a gap of norms
    averages rounding that only adds noise away, tells the float8 control
    from the program about six-fold (PERF.md);
  * ``change_gap``: the parameters' change after three steps, likewise,
    leaving out the leaves whose reference gradient is under a thousandth
    of the median leaf's (they move by rounding alone);
  * ``labels_wrong``: images whose labels differ from their record's.
TTA evaluation (a sample of the images the window finished):
  * ``score_gap``: the worst image's largest gap of the averaged score
    matrix over its largest reference score;
  * ``box_gap``: the largest gap of the averaged original-frame boxes, px
    (the same float32 operations: exact);
  * ``nms_wrong``: images whose detections differ from the reference's NMS
    over the program's own averaged matrices (exact).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names):
    med = float(np.median([ref[n] for n in ref])) or 1.0
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in names}


def train_readings(prog: dict, ref: dict) -> dict:
    """``prog``: per-step {name: loss}, the trace norms after step one, the
    change norms after step three; ``ref``: the same from the reference,
    with its raw gradient norms."""
    loss_gap = max(abs(p["total_loss"] - r["total_loss"])
                   / max(abs(r["total_loss"]), 1e-30)
                   for p, r in zip(prog["losses"], ref["losses"]))
    med_g = float(np.median(list(ref["grad"].values())))
    moved = [n for n, g in ref["grad"].items() if g >= 1e-3 * med_g]
    grad = _leaf_gaps(prog["trace"], ref["trace"], ref["trace"])
    change = _leaf_gaps(prog["change"], ref["change"], moved)
    # the direction too: the norm of the difference, which rounding that
    # only adds noise moves where a gap of norms averages it away
    wsddn_dir = max(float((prog["wsddn_trace"][n].to(t.device) - t).norm()
                          / t.norm().clamp(min=1e-30))
                    for n, t in ref["wsddn_trace"].items())
    worst_g = max(grad, key=grad.get)
    worst_c = max(change, key=change.get)
    return {"loss_gap": loss_gap, "grad_gap": grad[worst_g],
            "wsddn_grad_diff": wsddn_dir,
            "change_gap": change[worst_c],
            "labels_wrong": prog.get("labels_wrong", 0),
            "_worst_grad_leaf": [worst_g, prog["trace"][worst_g],
                                 ref["trace"][worst_g]],
            "_worst_change_leaf": [worst_c, prog["change"][worst_c],
                                   ref["change"][worst_c]],
            "_left_out": sorted(set(ref["grad"]) - set(moved)),
            "_step1": {"program": prog["losses"][0],
                       "reference": ref["losses"][0]},
            "_losses": {"program": [p["total_loss"] for p in prog["losses"]],
                        "reference": [r["total_loss"]
                                      for r in ref["losses"]]}}


def tta_readings(prog: List[dict], ref: List[dict],
                 ref_nms_of_prog: List[dict]) -> dict:
    score_gap = max(float(np.abs(p["all_scores"] - r["all_scores"]).max())
                    / max(float(np.abs(r["all_scores"]).max()), 1e-30)
                    for p, r in zip(prog, ref))
    box_gap = max(float(np.abs(p["all_boxes"] - r["all_boxes"]).max())
                  for p, r in zip(prog, ref))
    nms_wrong = sum(
        any(not np.array_equal(p[k], n[k])
            for k in ("boxes", "scores", "classes", "valid"))
        for p, n in zip(prog, ref_nms_of_prog))
    return {"score_gap": score_gap, "box_gap": box_gap,
            "nms_wrong": nms_wrong}


def judge(readings: dict, limits: dict):
    """(correct, checks): every number in ``limits`` held to its limit; a
    number that is missing or not finite fails."""
    checks = []
    for name, spec in limits.items():
        v = readings.get(name)
        ok = v is not None and math.isfinite(v) and v <= spec["limit"]
        checks.append({"name": name, "value": v, "limit": spec["limit"],
                       "ok": bool(ok)})
    return all(c["ok"] for c in checks), checks
