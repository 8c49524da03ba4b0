"""The port's host loop against the JAX package's, on the CPU: the metric
storage and ``metrics.json`` for the same puts; the hooks' order and
iterations, the state each sees, the writes and the checkpoints over a
counting step, eager and chunked, from a start iteration and with a tail
chunk; the NaN guard's iteration; and what the port does that the JAX
package does not (a second ``train`` call, chunks of mixed size buckets,
the writers without tensorboard, the profiler's trace). Everything must be
equal; wall times are left out of the comparison."""

import json
import logging
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drn_wsod_torch import engine as peng
from drn_wsod_torch.engine import trainer as ptrainer
from drn_wsod_torch.structures import WSODBatch
from drn_wsod_torch.utils import tracing
from drn_wsod_tpu import engine as jeng
from drn_wsod_tpu.engine import hooks as jhooks


def _puts(seed=0, n=45):
    rs = np.random.RandomState(seed)
    return [(str(rs.choice(["loss_a", "loss_b", "lr", "acc"])),
             float(np.round(rs.randn(), 3)), bool(rs.rand() < 0.7),
             bool(rs.rand() < 0.3)) for _ in range(n)]


def test_history_and_storage_equal():
    stores = []
    for E in (peng, jeng):
        with E.EventStorage(7) as s:
            assert E.get_event_storage() is s
            for name, v, hint, step in _puts():
                s.put_scalar(name, v, smoothing_hint=hint)
                if step:
                    s.step()
            s.put_scalars(loss_c=1.5, acc=0.25, smoothing_hint=False)
        stores.append(s)
    p, j = stores
    assert p.iter == j.iter and p.latest() == j.latest()
    assert p.latest_with_smoothing_hint(5) == j.latest_with_smoothing_hint(5)
    assert p.histories().keys() == j.histories().keys()
    for k in j.histories():
        hp, hj = p.history(k), j.history(k)
        assert hp.values() == hj.values()
        for w in (1, 3, 20):
            assert hp.median(w) == hj.median(w)
            assert hp.avg(w) == hj.avg(w)
        assert hp.global_avg() == hj.global_avg() and \
            hp.latest() == hj.latest()
    with pytest.raises(RuntimeError, match="EventStorage"):
        peng.get_event_storage()


def test_json_writer_lines_equal(tmp_path):
    texts = []
    for E, name in ((peng, "p"), (jeng, "j")):
        path = str(tmp_path / name / "metrics.json")
        w = E.JSONWriter(path, window=4)
        with E.EventStorage(0) as s:
            for i, (k, v, hint, step) in enumerate(_puts(1, 60)):
                s.put_scalar(k, v, smoothing_hint=hint)
                if step:
                    s.step()
                if i % 7 == 6:
                    w.write(s)
        w.close()
        texts.append(open(path).read())
    assert texts[0] == texts[1] and texts[0].count("\n") == 8


class _Recorder:
    """A hook recording (phase, iteration, state.step) for each call."""

    def __init__(self, base):
        class Hook(base):
            def __init__(self):
                self.events = []

            def _ev(self, phase):
                self.events.append((phase, int(self.trainer.iter),
                                    int(self.trainer.state.step)))

            def before_train(self):
                self._ev("before_train")

            def before_step(self):
                self._ev("before_step")

            def after_step(self):
                self._ev("after_step")

            def after_train(self):
                self._ev("after_train")

        self.hook = Hook()


class _Saves:
    def __init__(self):
        self.saved = []

    def save(self, state, step):
        self.saved.append((int(step), int(state.step)))


class _PortState:
    def __init__(self, step=0):
        self.step = step


def _jax_run(values, start, max_iter, k, log_period, out, prefetch=2):
    from drn_wsod_tpu.engine.trainer import TrainState

    def step(state, batch, rng):
        v = jnp.asarray(batch, jnp.float32)
        return state.replace(step=state.step + 1), {
            "total_loss": v, "loss_b": v * 2.0}

    def multi(state, stacked, rng):
        ms = []
        for b in np.asarray(stacked):
            state, m = step(state, b, rng)
            ms.append(m)
        return state, {key: jnp.stack([m[key] for m in ms]) for key in ms[0]}

    state = TrainState(step=jnp.asarray(start, jnp.int32), params={},
                       opt_state={})
    tr = jeng.Trainer(step, state, iter(values), None,
                      lr_schedule=lambda it: 0.01 * (it + 1),
                      log_period=log_period, multi_step_fn=multi,
                      steps_per_dispatch=k, prefetch_chunks=prefetch)
    return tr, _hooks(jhooks, jeng, tr, out, max_iter)


def _port_run(values, start, max_iter, k, log_period, out, prefetch=2):
    def step(state, batch, seed):
        state.step += 1
        v = torch.tensor(batch, dtype=torch.float32)
        return state, {"total_loss": v, "loss_b": v * 2.0}

    tr = peng.Trainer(step, _PortState(start), iter(values), 0,
                      lr_schedule=lambda it: 0.01 * (it + 1),
                      log_period=log_period,
                      multi_step_fn=ptrainer.make_multi_train_step(step),
                      steps_per_dispatch=k, prefetch_chunks=prefetch,
                      device="cpu")
    from drn_wsod_torch.engine import hooks as phooks

    return tr, _hooks(phooks, peng, tr, out, max_iter)


def _hooks(H, E, tr, out, max_iter):
    rec = _Recorder(H.HookBase).hook
    saves = _Saves()
    evals = []
    hooks = [H.IterationTimer(warmup_iter=1), rec,
             H.PeriodicWriter([E.JSONWriter(out)], period=3),
             H.PeriodicCheckpointer(saves, 4),
             H.EvalHook(6, lambda: evals.append(int(tr.iter)) or
                        {"bbox": {"AP50": float(len(evals))}, "n": 1})]
    tr.register_hooks(hooks)
    return rec, saves, evals


def _metrics(path):
    lines = [json.loads(line) for line in open(path)]
    return [{k: v for k, v in line.items()
             if k not in ("time", "data_time") and "prefetch" not in k}
            for line in lines]


@pytest.mark.parametrize("k,start,max_iter,prefetch", [
    (1, 0, 10, 2), (1, 0, 10, 0), (1, 3, 11, 2), (4, 0, 10, 2),
    (4, 0, 10, 0), (4, 2, 13, 2), (2, 0, 12, 2)],
    ids=["eager", "eager-inline", "eager-resumed", "chunked",
         "chunked-inline", "chunked-resumed-tail", "chunked-k2"])
def test_hooks_order_and_state_equal(tmp_path, k, start, max_iter, prefetch):
    """Both trainers over the same values: every hook call (phase,
    iteration, state.step), the checkpoints, the evaluations and
    metrics.json line for line, and the storage's histories."""
    values = [float(v) for v in np.random.RandomState(k).randn(40)]
    log_period = 4
    runs = []
    for run, name in ((_port_run, "p"), (_jax_run, "j")):
        tr, (rec, saves, evals) = run(
            values, start, max_iter, k, log_period,
            str(tmp_path / name / "metrics.json"), prefetch)
        tr.train(start, max_iter)
        hist = {key: h.values() for key, h in tr.storage.histories().items()
                if key not in ("time", "data_time")
                and "prefetch" not in key}
        runs.append((rec.events, saves.saved, evals, hist, int(tr.iter),
                     int(tr.state.step),
                     _metrics(str(tmp_path / name / "metrics.json"))))
    assert runs[0] == runs[1]
    events = runs[0][0]
    assert events[0][0] == "before_train" and events[-1][0] == "after_train"
    assert runs[0][5] == max_iter and runs[0][1]


@pytest.mark.parametrize("k", [1, 4], ids=["eager", "chunked"])
@pytest.mark.parametrize("bad", [4, 5, 10])
def test_nan_guard_same_iteration(tmp_path, k, bad):
    values = [1.0] * 12
    values[bad] = float("nan")
    messages = []
    for run, name in ((_port_run, "p"), (_jax_run, "j")):
        tr, _ = run(values, 0, 12, k, 3, str(tmp_path / name / "m.json"))
        try:
            tr.train(0, 12)
            messages.append(None)
        except FloatingPointError as e:
            messages.append(str(e).split(":")[0])
    assert messages[0] == messages[1]


def test_train_twice():
    """A second ``train`` call on one Trainer draws on from the original
    iterator; the JAX package's raises there (its first call replaced the
    iterator with a prefetch stream bounded to that call)."""
    values = [float(i) for i in range(10)]

    def step(state, batch, seed):
        state.step += 1
        return state, {"total_loss": torch.tensor(batch)}

    tr = peng.Trainer(step, _PortState(), iter(values), 0, log_period=2,
                      device="cpu")
    tr.train(0, 4)
    tr.train(4, 9)
    assert int(tr.state.step) == 9
    assert tr.storage.history("total_loss").values()[-1] == (8.0, 8)
    jtr = jeng.Trainer(lambda st, b, rng: (st + 1, {"total_loss": b}), 0,
                       iter(values), None, log_period=2)
    jtr.train(0, 4)
    with pytest.raises(RuntimeError, match="exhausted"):
        jtr.train(4, 9)


def _batch(size, value):
    return WSODBatch(
        image=torch.full((1, size, size, 3), value, dtype=torch.uint8),
        image_hw=torch.full((1, 2), size, dtype=torch.int32),
        orig_hw=torch.full((1, 2), size, dtype=torch.int32),
        proposals=torch.zeros(1, 4, 4), proposal_mask=torch.ones(1, 4,
                                                                 dtype=bool),
        objectness=torch.zeros(1, 4), labels=torch.zeros(1, 20),
        image_id=torch.zeros(1, dtype=torch.int32))


def test_chunks_of_mixed_buckets():
    """Chunks whose batches differ in size bucket run in the port; the JAX
    package's chunk stacking raises on them."""
    sizes = [64, 96, 64, 128, 96, 96]
    seen = []

    def step(state, batch, seed):
        seen.append((batch.image.shape[1], int(batch.image[0, 0, 0, 0])))
        state.step += 1
        return state, {"total_loss": batch.image.float().mean()}

    tr = peng.Trainer(step, _PortState(), iter(
        [_batch(s, i) for i, s in enumerate(sizes)]), 0, log_period=2,
        multi_step_fn=ptrainer.make_multi_train_step(step),
        steps_per_dispatch=3, device="cpu")
    tr.train(0, 6)
    assert seen == list(zip(sizes, range(6)))
    assert tr.storage.history("total_loss").values()[-1] == (5.0, 5)

    jtr, _ = _jax_run([np.zeros(s) for s in (2, 3, 2, 2)], 0, 4, 2, 2,
                      "/dev/null", prefetch=0)
    with pytest.raises(ValueError):
        jtr.train(0, 4)


def test_multi_step_takes_batches_of_different_buckets():
    """A chunk is a list: its batches need not share a size."""
    batches = [_batch(s, i) for i, s in enumerate((64, 96, 64))]

    def step(state, batch, seed):
        state.step += 1
        return state, {"v": batch.image.float().mean(),
                       "h": torch.tensor(float(batch.image.shape[1]))}

    state, m = ptrainer.make_multi_train_step(step)(_PortState(), batches, 0)
    assert state.step == 3
    assert m["v"].tolist() == [0.0, 1.0, 2.0]
    assert m["h"].tolist() == [64.0, 96.0, 64.0]


def test_trainer_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        peng.Trainer(lambda *a: a, _PortState(), iter([]), 0)


def test_profiler_hook_writes_chrome_trace(tmp_path):
    def step(state, batch, seed):
        state.step += 1
        x = torch.randn(32, 32)
        return state, {"total_loss": (x @ x).mean()}

    tr = peng.Trainer(step, _PortState(), iter([0.0] * 6), 0, log_period=2,
                      device="cpu")
    tr.register_hooks([peng.ProfilerHook(str(tmp_path), start_iter=1,
                                         num_iters=2)])
    tr.train(0, 6)
    trace = json.loads((tmp_path / "trace_iter1.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mm" in n for n in names)
    # the program's spans of the same window (the prefetch thread may have
    # pulled every batch before it), on their threads and on the trace's
    # clock: each data wait and read-back inside the operators' range
    spans = [e for e in trace["traceEvents"]
             if e.get("cat") == "program_span"]
    by = {}
    for e in spans:
        by.setdefault(e["name"], []).append(e)
    assert {"train.step", "train.data_wait", "train.flush"} <= set(by) <= {
        "train.step", "train.data_wait", "train.flush", "prefetch.pull",
        "prefetch.copy"}
    assert [e["args"]["id"] for e in by["train.step"]] == [1, 2]
    assert len(by["train.data_wait"]) == 2 and len(by["train.flush"]) == 1
    assert {e["tid"] for e in by["train.data_wait"]} == \
        {threading.get_native_id()}
    ops = [e for e in trace["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") != "program_span"]
    lo = min(e["ts"] for e in ops) - 1e3
    hi = max(e["ts"] + e["dur"] for e in ops) + 1e3
    for e in by["train.data_wait"] + by["train.flush"]:
        assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi
    assert trace["programCounters"] == {}
    assert not tracing.enabled() and tracing.drain() == ([], {})


def test_writers_without_tensorboard(tmp_path, monkeypatch, caplog):
    """Where the tensorboard package is missing, do_train's writers leave
    TensorBoard out with one warning that names it; metrics.json and the
    printer stay."""
    from drn_wsod_torch.config import get_cfg
    from drn_wsod_torch.tools import train_net

    cfg = get_cfg()
    cfg.OUTPUT_DIR = str(tmp_path)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with caplog.at_level(logging.WARNING, logger="drn_wsod_torch"):
        writers = train_net._writers(cfg)
    assert [type(w).__name__ for w in writers] == ["CommonMetricPrinter",
                                                   "JSONWriter"]
    warned = [r.message for r in caplog.records
              if "TensorboardWriter" in r.message]
    assert len(warned) == 1 and "tensorboard" in warned[0]
    for w in writers:
        w.close()


def test_printer_logs_losses_lr_and_eta(caplog):
    with caplog.at_level(logging.INFO, logger="drn_wsod_torch"):
        with peng.EventStorage(3) as s:
            s.put_scalars(loss_cls=0.5, time=0.25, data_time=0.01)
            s.put_scalar("lr", 0.02, smoothing_hint=False)
            peng.CommonMetricPrinter(10).write(s)
    line = caplog.records[-1].message
    assert "loss_cls: 0.5" in line and "lr: 0.02" in line
    assert "eta: 0:00:01" in line and "iter: 3" in line


@pytest.mark.parametrize("workers", [0, 4, 8, 2])
def test_auto_scale_workers_equal(workers):
    """The config rescaled to a device count, as the JAX package's."""
    from drn_wsod_torch.config import get_cfg as pget_cfg
    from drn_wsod_torch.engine.defaults import auto_scale_workers as pscale
    from drn_wsod_tpu.config import get_cfg as jget_cfg
    from drn_wsod_tpu.engine.defaults import auto_scale_workers as jscale

    out = []
    for get_cfg, scale in ((pget_cfg, pscale), (jget_cfg, jscale)):
        cfg = get_cfg()
        cfg.SOLVER.REFERENCE_WORLD_SIZE = 4
        cfg.SOLVER.IMS_PER_BATCH = 8
        cfg.SOLVER.STEPS = (35000, 45000)
        cfg.TEST.EVAL_PERIOD = 5000
        cfg.freeze()
        got = scale(cfg, workers) if workers else cfg
        out.append((got.SOLVER.IMS_PER_BATCH, got.SOLVER.BASE_LR,
                    got.SOLVER.MAX_ITER, got.SOLVER.WARMUP_ITERS,
                    tuple(got.SOLVER.STEPS), got.TEST.EVAL_PERIOD,
                    got.SOLVER.REFERENCE_WORLD_SIZE, got.is_frozen()))
    assert out[0] == out[1]
