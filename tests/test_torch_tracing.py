"""The port's recorder (``drn_wsod_torch/utils/tracing.py``) and the spans
the program records with it, on the CPU: nesting, parents, identifiers and
per-thread lists; nothing recorded while off, through one shared no-op;
the clock against the profiler's; the Trainer's, the TTA's and the model's
spans and the counter ``model.first_shape``."""

import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch.engine import trainer as ptrainer
from drn_wsod_torch.models import build_model
from drn_wsod_torch.solver import build_optimizer
from drn_wsod_torch.tta import GeneralizedRCNNWithTTAAVG
from drn_wsod_torch.utils import tracing

torch.set_num_threads(1)

FLAGSHIP = str(Path(__file__).resolve().parents[1] / "configs"
               / "PascalVOC-Detection" / "oicr_WSR_50_DC5_1x.yaml")
TOY = ["MODEL.RESNETS.DEPTH", "18", "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
       "MODEL.ROI_BOX_HEAD.DAN_DIM", "[64, 64]",
       "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "64", "MODEL.DTYPE",
       "float32", "TEST.AUG.MIN_SIZES", "(40, 72)", "TEST.AUG.MAX_SIZE",
       "200", "INPUT.BUCKETS", "[64, 96]"]


@pytest.fixture(autouse=True)
def recorder_off():
    """Each test starts and ends with the recorder off and empty."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def _cfg(*extra):
    cfg = drn_wsod_torch.get_cfg()
    cfg.merge_from_file(FLAGSHIP)
    cfg.merge_from_list(TOY + list(extra))
    return cfg


@pytest.fixture(scope="module")
def toy_model():
    cfg = _cfg()
    return cfg, build_model(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0))


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_nesting_parents_ids_and_threads():
    tracing.enable()
    with tracing.span("root", id=7) as root:
        with tracing.span("child"):
            with tracing.span("grandchild"):
                pass
        with tracing.span("sibling", id=9):
            pass
    t0 = time.perf_counter_ns()
    tracing.record("recorded", t0, t0 + 1000)

    def other():
        with tracing.span("other.root", id=3):
            with tracing.span("other.child"):
                pass

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    spans, counters = tracing.drain()
    by = {s.name: s for s in spans}
    assert set(by) == {"root", "child", "grandchild", "sibling", "recorded",
                       "other.root", "other.child"}
    assert counters == {}
    assert by["root"].parent is None and by["root"].serial == root.serial
    assert by["child"].parent == by["root"].serial
    assert by["grandchild"].parent == by["child"].serial
    assert by["sibling"].parent == by["root"].serial
    assert by["recorded"].parent is None
    assert by["recorded"].end_ns - by["recorded"].start_ns == 1000
    # the root sets the identifier and its children inherit it
    assert [by[n].id for n in ("root", "child", "grandchild", "sibling",
                               "recorded", "other.root", "other.child")] \
        == [7, 7, 7, 9, None, 3, 3]
    assert by["other.child"].parent == by["other.root"].serial
    mine = {by[n].tid for n in ("root", "child", "grandchild", "sibling")}
    assert mine == {threading.get_native_id()}
    assert by["other.root"].tid not in mine
    assert by["other.root"].tid == by["other.child"].tid
    assert by["root"].ident == threading.get_ident()
    for s in spans:
        assert s.start_ns <= s.end_ns
    assert by["root"].start_ns <= by["child"].start_ns
    assert by["child"].end_ns <= by["sibling"].start_ns
    assert by["sibling"].end_ns <= by["root"].end_ns
    # drained once
    assert tracing.drain() == ([], {})


def test_record_takes_the_open_span_as_parent():
    tracing.enable()
    with tracing.span("outer", id=5):
        t0 = time.perf_counter_ns()
        tracing.record("inner", t0, t0 + 10)
    by = {s.name: s for s in tracing.drain()[0]}
    assert by["inner"].parent == by["outer"].serial and by["inner"].id == 5


def test_off_records_nothing_through_one_shared_noop():
    assert not tracing.enabled()
    a, b = tracing.span("a"), tracing.span("b", id=1)
    assert a is b
    with a as entered:
        tracing.record("r", 0, 1)
        tracing.count("c", 3)
    assert entered is a
    assert tracing.drain() == ([], {})
    tracing.enable()
    with tracing.span("on"):
        tracing.count("c", 2)
        tracing.count("c")
    tracing.disable()
    with tracing.span("off"):
        tracing.count("c")
    spans, counters = tracing.drain()
    assert [s.name for s in spans] == ["on"] and counters == {"c": 3}


def test_a_span_open_when_disabled_still_closes_into_the_buffer():
    tracing.enable()
    with tracing.span("kept"):
        tracing.disable()
        with tracing.span("dropped"):
            pass
    assert [s.name for s in tracing.drain()[0]] == ["kept"]


def test_spans_of_many_threads_are_all_drained():
    """Threads that record at once, each in its own buffer with no lock:
    every span arrives, once, with its own thread's parent chain."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        tracing.enable()

        def work(i):
            for j in range(200):
                with tracing.span("t.outer", id=i):
                    with tracing.span("t.inner"):
                        pass

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        got = []
        while any(t.is_alive() for t in threads):
            got += tracing.drain()[0]
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        got += tracing.drain()[0]
    finally:
        sys.setswitchinterval(old)
    assert len(got) == 16 * 200 * 2
    assert len({s.serial for s in got}) == len(got)
    outer = {s.serial: s for s in got if s.name == "t.outer"}
    for s in got:
        if s.name == "t.inner":
            p = outer[s.parent]
            assert p.tid == s.tid and p.id == s.id


def test_span_clock_is_the_profilers():
    """A ``record_function`` inside a span, under a CPU profiler: its
    kineto start and end lie within the span's converted interval, to
    1 ms."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracing.enable()
        with tracing.span("outer"):
            time.sleep(0.002)
            with record_function("inside"):
                torch.ones(64).sum()
            time.sleep(0.002)
        tracing.disable()
    (span,), _ = tracing.drain()
    inside = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "inside"]
    assert len(inside) == 1
    start, end = inside[0].start_ns(), inside[0].end_ns()
    tol = 1_000_000
    assert span.start_ns - tol <= start and end <= span.end_ns + tol
    assert start - span.start_ns >= 1_000_000     # after the first sleep


def _train(cfg, model, steps, k):
    tx = build_optimizer(cfg, model)
    state = ptrainer.create_train_state(model, tx)
    step = ptrainer.make_train_step(model, tx)
    batches = iter([drn_wsod_torch.synthetic_batch(2, 64, 64, 64, 20,
                                                   seed=i, device="cpu")
                    for i in range(steps)])
    tr = ptrainer.Trainer(step, state, batches, seed=1, log_period=1,
                          multi_step_fn=(ptrainer.make_multi_train_step(step)
                                         if k > 1 else None),
                          steps_per_dispatch=k, device="cpu")
    tracing.enable()
    tr.train(0, steps)
    tracing.disable()
    return tr, tracing.drain()


@pytest.mark.parametrize("k", [1, 2])
def test_trainer_spans(toy_model, k):
    cfg, model = toy_model
    tr, (spans, counters) = _train(cfg, model, 2, k)
    by = _by_name(spans)
    for name in ("train.step", "train.data_wait", "train.forward",
                 "train.backward", "train.update", "train.flush",
                 "prefetch.pull", "prefetch.copy", "model.backbone",
                 "model.pool", "model.box_head", "model.predictor",
                 "model.refine", "model.refine.mine", "model.refine.loss"):
        assert name in by, name
    assert len(by["train.step"]) == 2
    assert len(by["model.refine"]) == 2 * 3
    assert len(by.get("train.chunk", [])) == (1 if k == 2 else 0)
    # identifiers: each step's spans carry the step
    steps = {s.serial: s.id for s in by["train.step"]}
    assert sorted(steps.values()) == [0, 1]
    for name in ("train.forward", "train.backward", "train.update"):
        assert sorted(s.id for s in by[name]) == [0, 1]
        assert all(s.parent in steps for s in by[name])
    # the loop's spans and the prefetch thread's
    loop = {s.tid for s in by["train.step"]}
    assert loop == {threading.get_native_id()}
    assert {s.tid for s in by["prefetch.pull"]} - loop
    # data_time is the data_wait span's duration, over the steps it fed
    waits = sorted(by["train.data_wait"], key=lambda s: s.start_ns)
    assert len(waits) == 2 // k
    data_time = [v for v, _ in tr.storage.history("data_time").values()]
    want = [(w.end_ns - w.start_ns) * 1e-9 / k for w in waits
            for _ in range(k)]
    np.testing.assert_allclose(data_time, want, rtol=0, atol=1e-15)
    # about 40 spans a step at most
    on_loop = [s for s in spans if s.tid in loop]
    assert len(on_loop) / 2 <= 40


def test_trainer_records_nothing_while_off(toy_model):
    cfg, model = toy_model
    tx = build_optimizer(cfg, model)
    state = ptrainer.create_train_state(model, tx)
    tr = ptrainer.Trainer(
        ptrainer.make_train_step(model, tx), state,
        iter([drn_wsod_torch.synthetic_batch(2, 64, 64, 64, 20, seed=0,
                                             device="cpu")]),
        seed=1, log_period=1, device="cpu")
    tr.train(0, 1)
    assert tracing.drain() == ([], {})
    assert not hasattr(tr, "last_prefetch_profile")
    assert not [n for n in tr.storage.histories() if n.startswith("prefetch")]


def _record(h=45, w=61, n=40, seed=0):
    rs = np.random.RandomState(seed)
    x1, y1 = rs.uniform(0, w - 12, n), rs.uniform(0, h - 12, n)
    boxes = np.stack([x1, y1, np.minimum(x1 + rs.uniform(4, 30, n), w - 1),
                      np.minimum(y1 + rs.uniform(4, 30, n), h - 1)], 1)
    return {"image_id": 1234, "height": h, "width": w,
            "image": rs.randint(0, 256, (h, w, 3)).astype(np.uint8),
            "proposal_boxes": boxes.astype(np.float32),
            "proposal_objectness_logits": rs.uniform(-1, 1, n).astype(
                np.float32),
            "annotations": [{"category_id": 3, "bbox": [1, 1, 20, 20],
                             "bbox_mode": 0}]}


@pytest.mark.parametrize("device_views", [True, False])
def test_tta_image_spans(device_views):
    cfg = _cfg("TEST.AUG.DEVICE_VIEWS", str(device_views))
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    tta = GeneralizedRCNNWithTTAAVG(cfg, model, device="cpu")
    record = _record()
    tta(record)                       # the shapes' first calls
    tracing.enable()
    dets = tta(record)
    tracing.disable()
    assert dets["scores"].shape[0] == cfg.TEST.DETECTIONS_PER_IMAGE
    spans, counters = tracing.drain()
    by = _by_name(spans)
    groups = len(tta.groups((45, 61)))
    assert len(by["tta.image"]) == 1
    assert len(by["tta.group"]) == len(by["tta.view_build"]) == groups
    assert len(by["model.backbone"]) == groups
    for name in ("tta.finalize", "tta.readback", "model.pool",
                 "model.box_head", "model.refine"):
        assert name in by, name
    assert {s.id for s in spans} == {1234}
    image = by["tta.image"][0]
    assert image.parent is None
    group_serials = {g.serial for g in by["tta.group"]}
    assert all(v.parent in group_serials for v in by["tta.view_build"])
    assert all(s.start_ns >= image.start_ns and s.end_ns <= image.end_ns
               for s in spans)
    assert counters == {}


def test_first_shape_counts_a_new_bucket_once(toy_model):
    _, model = toy_model
    model._seen_shapes.clear()

    def forward(side, B=1):
        with torch.no_grad():
            model.features(torch.zeros(B, side, side, 3))

    forward(64)                       # seen before the recorder is on
    tracing.enable()
    forward(64)
    forward(96)
    forward(96)
    forward(96, B=2)
    tracing.disable()
    assert tracing.drain()[1] == {"model.first_shape": 2}
