"""A whole run at a small size on the CPU, the look for a card skipped,
with the timed path broken underneath: ``correct`` comes out false for
each fault a cell can have, and true for the sound program."""

import pytest
import torch

from h100_bench.run import run_cell
from h100_bench.small import RECORDS, SMALL

SEED = 20231018


def _run(workload):
    result, checks = run_cell(workload, SEED, 1.0, False, "cpu",
                              extra=SMALL, n_records=RECORDS)
    return result["correct"], {c["name"]: c for c in checks}


def _state_unchanged(monkeypatch):
    from drn_wsod_torch.solver.build import SGD

    def update(self, grads, state, params):
        state["count"] += 1

    monkeypatch.setattr(SGD, "update", update)


def _half_batch(monkeypatch):
    from drn_wsod_torch.models.meta_arch import GeneralizedRCNNWSL

    forward = GeneralizedRCNNWSL.forward

    def half(self, batch, **kw):
        n = max(batch.image.shape[0] // 2, 1)
        return forward(self, batch.map(lambda t: t[:n]), **kw)

    monkeypatch.setattr(GeneralizedRCNNWSL, "forward", half)


def _answer_altered(monkeypatch):
    from drn_wsod_torch.tta import GeneralizedRCNNWithTTAAVG

    detect = GeneralizedRCNNWithTTAAVG.detect_image

    def altered(self, image, record):
        dets = detect(self, image, record)
        dets["classes"][0] = (dets["classes"][0] + 1) % self.num_classes
        return dets

    monkeypatch.setattr(GeneralizedRCNNWithTTAAVG, "detect_image", altered)


def _half_views(monkeypatch):
    from drn_wsod_torch.tta import GeneralizedRCNNWithTTAAVG

    groups = GeneralizedRCNNWithTTAAVG.groups

    def half(self, image_hw):
        out, i = {}, 0
        for bucket, views in groups(self, image_hw).items():
            for v in views:
                if i % 2 == 0:
                    out.setdefault(bucket, []).append(v)
                i += 1
        return out

    monkeypatch.setattr(GeneralizedRCNNWithTTAAVG, "groups", half)


@pytest.mark.parametrize("workload", ["oicr_r50.train_voc07",
                                      "pcl_r50.train_voc07"])
@pytest.mark.parametrize("fault", [None, _state_unchanged, _half_batch])
def test_training_cell(workload, fault, monkeypatch):
    torch.manual_seed(0)
    if fault is not None:
        fault(monkeypatch)
    correct, checks = _run(workload)
    assert correct == (fault is None), checks


@pytest.mark.parametrize("fault", [None, _answer_altered, _half_views])
def test_tta_cell(fault, monkeypatch):
    if fault is not None:
        fault(monkeypatch)
    correct, checks = _run("oicr_r50.tta_eval_voc07")
    assert correct == (fault is None), checks
