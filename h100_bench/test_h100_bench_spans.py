"""``spans.py`` on synthetic kineto-like events: device operations joined
to their launches by correlation id and put down to the launching thread's
innermost span, the backward's launches (a thread without spans) to the
loop thread's span, idle gaps to the loop's and the prefetch thread's
spans, every reading ``None`` without spans. Then whole small runs on the
CPU: the drivers never turn the program's recorder on, and the probe reads
the spans of a traced sub-window."""

import pytest

from drn_wsod_torch.utils.tracing import Span
from h100_bench import spans as S

CUDA, CPU = "cuda", "cpu"
LOOP, PREFETCH, AUTOGRAD = 0x7F00A1B2C000, 0x7F00D4E5F000, 0x7F0012345000


class Event:
    def __init__(self, name, dev, start, dur, corr, linked=0, thread=0):
        self._v = (name, dev, start, dur, corr, linked, thread)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def device_resource_id(self):
        return S.int32(self._v[6])


def _spans():
    """A step on the loop thread (native id 100) and a copy on the prefetch
    thread (200)."""
    rows = [("train.step", 0, 1000, 1, None, 100, LOOP, 0),
            ("train.forward", 10, 400, 2, 1, 100, LOOP, 0),
            ("model.backbone", 20, 200, 3, 2, 100, LOOP, 0),
            ("train.backward", 400, 800, 4, 1, 100, LOOP, 0),
            ("train.update", 800, 950, 5, 1, 100, LOOP, 0),
            ("prefetch.copy", 300, 700, 6, None, 200, PREFETCH, None)]
    return [Span(*r) for r in rows]


def _events():
    return [
        Event("Activity Buffer Request", CPU, 25, 5, 1),      # not a launch
        Event("cudaLaunchKernel", CPU, 30, 5, 1, thread=LOOP),
        Event("conv", CUDA, 40, 60, 1),                       # backbone
        Event("cudaLaunchKernel", CPU, 250, 5, 2, thread=LOOP),
        Event("gemm", CUDA, 260, 40, 2),                      # forward
        Event("cudaLaunchKernel", CPU, 450, 5, 3, thread=AUTOGRAD),
        Event("gemm_grad", CUDA, 460, 140, 3),                # backward
        Event("cudaMemcpyAsync", CPU, 310, 5, 4, thread=PREFETCH),
        Event("Memcpy HtoD", CUDA, 320, 10, 4),               # the copy
        Event("orphan", CUDA, 620, 10, 5),                    # no launch
        Event("cudaLaunchKernel", CPU, 1100, 5, 6, thread=LOOP),
        Event("late", CUDA, 1110, 10, 0, linked=6),           # linked id
        Event("cudaStreamSynchronize", CPU, 1115, 400, 7, thread=LOOP),
        Event("orphan2", CUDA, 1500, 10, 8),
    ]


def _linked():
    ops, calls = S.kineto_rows(_events(), CUDA)
    return S.Linked(_spans(), ops), calls


def test_linked_through_correlation_ids():
    ln, calls = _linked()
    got = {op.name: ln.path(s) for op, s in zip(ln.ops, ln.span_of)}
    assert got == {
        "conv": "train.step/train.forward/model.backbone",
        "gemm": "train.step/train.forward",
        "gemm_grad": "train.step/train.backward",
        "Memcpy HtoD": "prefetch.copy",
        "orphan": S.OUTSIDE,
        "late": S.OUTSIDE,
        "orphan2": S.OUTSIDE}
    assert [c.name for c in calls] == ["cudaLaunchKernel"] * 3 + [
        "cudaMemcpyAsync", "cudaLaunchKernel", "cudaStreamSynchronize"]
    assert ln.loop == 100 and ln.prefetch == 200
    assert ln.matched == 4          # the backward's thread has no spans


def test_backward_launches_fall_to_the_loop_span():
    ln, _ = _linked()
    assert ln.device_ns("train.backward") == 140
    assert ln.device_ns("model.backbone") == 60
    rows = dict(map(tuple, ln.device_by_span()))
    assert rows["train.step/train.backward"] == pytest.approx(140e-9)
    assert rows[S.OUTSIDE] == pytest.approx(30e-9)
    busy = 60 + 40 + 140 + 10 + 10 + 10 + 10
    assert ln.busy_ns() == busy
    assert ln.named_share() == pytest.approx((busy - 30) / busy)


def test_without_matching_threads_everything_falls_to_the_loop():
    """Where no launch's thread key is a thread of the spans, each
    operation is put down by time on the loop thread alone."""
    spans = [s._replace(ident=s.ident + 1) for s in _spans()]
    ops, _ = S.kineto_rows(_events(), CUDA)
    ln = S.Linked(spans, ops)
    assert ln.matched == 0
    got = {op.name: ln.path(s) for op, s in zip(ln.ops, ln.span_of)}
    assert got["Memcpy HtoD"] == "train.step/train.forward"
    assert got["gemm_grad"] == "train.step/train.backward"


def test_idle_gaps_put_down_to_spans():
    ln, calls = _linked()
    # device intervals 40-100, 260-300, 320-330, 460-600, 620-630,
    # 1110-1120, 1500-1510: gaps at 100, 300, 330, 600, 630 and 1120
    rows = dict(map(tuple, ln.idle_by_span()))
    assert rows == pytest.approx({
        "train.step/train.forward/model.backbone": 160e-9,
        "train.step/train.forward | prefetch.copy": 150e-9,
        "train.step/train.backward | prefetch.copy": 500e-9,
        S.OUTSIDE: 380e-9}, abs=1e-15)
    assert ln.idle_named_share() == pytest.approx(810 / 1190)
    gaps = ln.longest_gaps(calls, top=2)
    assert [g["s"] for g in gaps] == pytest.approx([480e-9, 380e-9])
    assert gaps[0] == {"s": gaps[0]["s"], "call": None, "thread": None,
                       "loop_span": "train.step/train.backward",
                       "prefetch_span": "prefetch.copy"}
    assert gaps[1] == {"s": gaps[1]["s"], "call": "cudaStreamSynchronize",
                       "thread": "loop", "loop_span": S.OUTSIDE,
                       "prefetch_span": None}


def test_readings_none_without_spans():
    for name, read in S.READINGS.items():
        assert read({}) is None, name
        assert read({"kind": "train"}) is None, name
        assert read({"kind": "eval", "spans": []}) is None, name
    assert S.breakdown({}) == {"device_by_span": [], "idle_by_span": [],
                               "counters": {}}


def test_readings_from_spans():
    ops, _ = S.kineto_rows(_events(), CUDA)
    ctx = {"kind": "train", "spans": _spans(), "device_ops": ops,
           "counters": {"model.first_shape": 0}}
    r = {k: f(ctx) for k, f in S.READINGS.items()}
    assert r["backbone_device_ms.train_busy"] == pytest.approx(60e-6)
    assert r["backward_device_ms.train_busy"] == pytest.approx(140e-6)
    assert r["backbone_device_ms.eval"] is None
    assert r["mining_host_share.train"] is None     # no mining span
    mine = Span("model.refine.mine", 100, 350, 9, 2, 100, LOOP, 0)
    ctx = {"kind": "train", "spans": _spans() + [mine]}
    assert S.READINGS["mining_host_share.train"](ctx) == pytest.approx(25.0)
    assert S.breakdown({"counters": {"model.first_shape": 0}})[
        "counters"] == {"model.first_shape": 0}


SMALL_CELLS = ["oicr_r50.train_voc07", "oicr_r50.tta_eval_voc07"]


@pytest.mark.parametrize("workload", SMALL_CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_drivers_never_turn_the_recorder_on(monkeypatch, workload, trace):
    from drn_wsod_torch.utils import tracing
    from h100_bench.run import run_cell
    from h100_bench.small import RECORDS, SMALL

    calls = []
    monkeypatch.setattr(tracing, "enable", lambda: calls.append(1))
    result, _ = run_cell(workload, 2 ** 31 + 17, 1.0, bool(trace), "cpu",
                         extra=SMALL, n_records=RECORDS)
    assert result["correct"]
    assert calls == [] and not tracing.enabled()
    assert tracing.drain() == ([], {})


@pytest.mark.parametrize("workload", SMALL_CELLS)
def test_probe_reads_the_traced_windows_spans(workload):
    from drn_wsod_torch.utils import tracing
    from h100_bench.span_probe import probe
    from h100_bench.small import RECORDS, SMALL

    result, _, out = probe(workload, 2 ** 31 + 17, 1.0, "cpu", extra=SMALL,
                           n_records=RECORDS)
    assert result["correct"] and not tracing.enabled()
    assert out["units"] > 0 and out["spans"] >= 10 * out["units"]
    assert out["spans_per_unit"] <= 40
    assert out["counters"] == {}             # nothing new in the window
    assert out["device_ops"] == 0            # no CUDA device here
    r = out["readings"]
    assert all(r[k] is None for k in r if "device_ms" in k)
    assert (r["mining_host_share.train"] is not None) == \
        (out["kind"] == "train")
