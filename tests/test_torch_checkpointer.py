"""The port's ``Checkpointer`` on the CPU, at the toy flagship config (R18,
DAN [64, 64], P = 64, float32) after two real train steps: a save and a load
give back every parameter, buffer, momentum trace and the step bit for bit;
``max_to_keep`` keeps the newest; ``resume_or_load`` resumes from the latest
checkpoint, else loads ``MODEL.WEIGHTS`` (a Detectron2 ``.pkl``), else
leaves the state as it is, and returns ``start_iter == state.step``."""

import pickle

import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch.checkpoint import Checkpointer
from test_torch_common import TOY, cfg_pair, d2_state_dict

torch.set_num_threads(1)


def _state(seed=0, steps=0):
    _, cfg = cfg_pair(*TOY, "MODEL.ROI_BOX_HEAD.DROPOUT", 0.0)
    model = drn_wsod_torch.build_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    tx = drn_wsod_torch.build_optimizer(cfg, model)
    state = drn_wsod_torch.create_train_state(model, tx)
    step = drn_wsod_torch.make_train_step(model, tx)
    for s in range(steps):
        state, _ = step(state, drn_wsod_torch.synthetic_batch(
            1, 64, 64, 64, 20, seed=s, device="cpu"), 0)
    return state


def _flat(state):
    out = {f"model.{k}": v.clone() for k, v in state.model.state_dict().items()}
    for k, v in state.opt_state["trace"].items():
        out[f"trace.{k}"] = v.clone()
    out["count"] = state.opt_state["count"]
    out["step"] = state.step
    return out


def _assert_bit_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype, k
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_save_load_round_trip(tmp_path):
    trained = _state(steps=2)
    want = _flat(trained)
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(trained, 2)
    assert ck.latest_step() == 2
    assert [p.name for p in (tmp_path / "ck").iterdir()] == \
        ["model_0000002.pth"]
    fresh = _state(seed=1)
    assert not torch.equal(fresh.model.box_head.fc1.weight,
                           trained.model.box_head.fc1.weight)
    traces = fresh.opt_state["trace"]
    loaded = ck.load(fresh)
    assert loaded is fresh and loaded.opt_state["trace"] is traces
    _assert_bit_equal(_flat(loaded), want)
    assert loaded.step == 2 and loaded.opt_state["count"] == 2
    # the loaded state trains on exactly as the saved one
    batch = drn_wsod_torch.synthetic_batch(1, 64, 64, 64, 20, seed=9,
                                           device="cpu")
    _, cfg = cfg_pair(*TOY, "MODEL.ROI_BOX_HEAD.DROPOUT", 0.0)
    for st in (trained, loaded):
        tx = drn_wsod_torch.build_optimizer(cfg, st.model)
        drn_wsod_torch.make_train_step(st.model, tx)(st, batch, 0)
    _assert_bit_equal(_flat(loaded), _flat(trained))
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).load(fresh)


def test_max_to_keep(tmp_path):
    state = _state()
    ck = Checkpointer(str(tmp_path), max_to_keep=3)
    for s in (2, 4, 6, 8, 10):
        state.step = s
        ck.save(state, s)
    assert ck.all_steps() == [6, 8, 10] and ck.latest_step() == 10
    assert Checkpointer(str(tmp_path)).all_steps() == [6, 8, 10]
    assert not [p for p in tmp_path.iterdir() if ".tmp" in p.name]
    assert ck.load(state, 8).step == 8


def test_resume_or_load_branches(tmp_path):
    trained = _state(steps=2)
    weights = tmp_path / "model_final.pkl"
    with open(weights, "wb") as f:
        pickle.dump({"model": d2_state_dict(trained.model.state_dict())}, f)

    # 1. nothing to resume, no weights: the state as it is, start 0
    fresh = _state(seed=1)
    want = _flat(fresh)
    ck = Checkpointer(str(tmp_path / "ck"))
    state, start = ck.resume_or_load(fresh, "", resume=True)
    assert state is fresh and start == 0
    _assert_bit_equal(_flat(state), want)

    # 2. no checkpoint (or resume off): MODEL.WEIGHTS into the model only
    for resume in (True, False):
        state, start = ck.resume_or_load(_state(seed=1), str(weights),
                                         resume=resume)
        assert start == 0 == state.step
        for k, v in trained.model.state_dict().items():
            assert torch.equal(state.model.state_dict()[k], v), k
        assert all(not t.any() for t in state.opt_state["trace"].values())

    # 3. a checkpoint and resume: the latest one, weights ignored
    ck.save(trained, 2)
    later = _state(steps=3)
    ck.save(later, 3)
    state, start = ck.resume_or_load(_state(seed=1), str(weights),
                                     resume=True)
    assert start == 3 == state.step
    _assert_bit_equal(_flat(state), _flat(later))
    # resume off: the weights again, the checkpoints ignored
    state, start = ck.resume_or_load(_state(seed=1), str(weights),
                                     resume=False)
    assert start == 0 and torch.equal(state.model.box_head.fc1.weight,
                                      trained.model.box_head.fc1.weight)
