"""The port's ``tools/`` CLIs against the JAX package's, each loaded by path
as ``tests/test_torch_train_net.py`` loads ``tools/train_net.py``, on the
CPU, on a VOC-layout tree the test writes (``write_voc``) with the toy
flagship config (R18-WS, DAN [64, 64], P = 64, float32, dropout 0) and one
Detectron2 ``.pkl`` of numpy weights:

* ``generate_pgt``: the same images; each image's pseudo boxes, classes
  (+1) and scores as the JAX tool's, boxes within 1e-4 of the largest,
  scores within rtol 1e-4;
* ``plain_train_net``: 3 steps, every loss within rtol 1e-4 / atol 1e-5
  (``test_torch_train_net.py``'s tolerance);
* ``visualize_data``, ``visualize_json_results``, ``PGTVisualization``:
  the files equal the JAX tool's with its labels drawn at the truncated
  origin (``test_torch_visualizer.py``'s contract), PNG decoded equal, JPEG
  byte for byte; ``train_net.do_train`` with ``VIS_PERIOD`` writes them;
* ``convert_weights``: the checkpoint loads into the model as
  ``load_reference_weights`` does, and equals the JAX conversion through
  ``params_from_jax``;
* ``proposal_convert``: the pickles of SS and MCG ``.mat`` files equal;
* ``filter_events``: the same printout and filtered file;
* ``analyze_model``: parameter counts by module equal the JAX tool's, at
  the flagship's full width (counted on the meta device);
* ``benchmark``: every task runs on the CPU at a toy size."""

import importlib.util
import json
import pickle
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import drn_wsod_torch
from drn_wsod_torch import data as pdata
from drn_wsod_torch.data.datasets import voc as pvoc
from drn_wsod_torch.data.png import read_png
from drn_wsod_torch.tools import (analyze_model, benchmark, convert_weights,
                                  filter_events, generate_pgt,
                                  plain_train_net, proposal_convert,
                                  train_net, visualize_data,
                                  visualize_json_results)
from drn_wsod_tpu import data as jdata
from drn_wsod_tpu.data.datasets import voc as jvoc
from drn_wsod_tpu.models import build_model as jax_build_model
from test_torch_common import (FLAGSHIP, TOY, cfg_pair, d2_state_dict,
                               flatten, jax_batch, param_shapes,
                               random_params, unflatten, write_voc)
from test_torch_visualizer import no_pillow, truncated_text

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TRAIN, TEST = "torch_cli_train", "torch_cli_test"
SIZES = [(40, 56), (64, 48), (33, 70), (50, 50), (61, 45), (47, 66)]


def _jax_tool(name: str):
    """``tools/<name>.py`` of the JAX package as a module (the JAX PRNG
    implementation a tool may switch at import is restored)."""
    impl = jax.config.jax_default_prng_impl
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    jax.config.update("jax_default_prng_impl", impl)
    return module


def _opts(pairs) -> list:
    out = []
    for k, v in zip(pairs[0::2], pairs[1::2]):
        out += [k, v if isinstance(v, str) else repr(v)]
    return out


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools_cli")
    d, props, _ = write_voc(root / "voc", SIZES, pvoc.VOC_CLASS_NAMES,
                            split="trainval", seed=31, n_props=70)
    for reg in (pvoc.register_pascal_voc, jvoc.register_pascal_voc):
        reg(TRAIN, d, "trainval", 2007)
        reg(TEST, d, "trainval", 2007)
    opts = (*TOY, "MODEL.PIXEL_STD", [57.4, 57.1, 58.4],
            "MODEL.ROI_BOX_HEAD.DROPOUT", 0.0,
            "INPUT.MIN_SIZE_TRAIN", (48, 64), "INPUT.MAX_SIZE_TRAIN", 90,
            "INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 90,
            "INPUT.BUCKETS", [96], "SOLVER.IMS_PER_BATCH", 2,
            "SOLVER.MAX_ITER", 3, "SOLVER.CHECKPOINT_PERIOD", 3,
            "SOLVER.STEPS_PER_DISPATCH", 1, "SEED", 0,
            "TEST.AUG.ENABLED", False, "TEST.EVAL_PERIOD", 0,
            "TEST.DETECTIONS_PER_IMAGE", 5,
            "DATASETS.TRAIN", (TRAIN,), "DATASETS.TEST", (TEST,),
            "DATASETS.PROPOSAL_FILES_TRAIN", (props,),
            "DATASETS.PROPOSAL_FILES_TEST", (props,),
            "DATALOADER.NUM_WORKERS", 0, "PARALLEL.MESH_SHAPE", [1])
    jc, _ = cfg_pair(*opts)
    jm = jax_build_model(jc)
    key = jax.random.PRNGKey(0)
    init = drn_wsod_torch.synthetic_batch(1, 64, 64, 64, 20, seed=3,
                                          device="cpu")
    flat = random_params(param_shapes(lambda: jm.init(
        {"params": key, "dropout": key}, jax_batch(init), train=False)),
        seed=7)
    weights = root / "model_init.pkl"
    with open(weights, "wb") as f:
        pickle.dump({"model": d2_state_dict(
            drn_wsod_torch.params_from_jax(flat))}, f)
    yield {"root": root, "voc": d, "opts": list(opts) + [
        "MODEL.WEIGHTS", str(weights)], "flat": flat, "weights": weights}
    for pkg in (pdata, jdata):
        pkg.DatasetCatalog.remove(TRAIN)
        pkg.DatasetCatalog.remove(TEST)


def _argv(tree, out_dir, *extra) -> list:
    return ["--config-file", FLAGSHIP, *extra,
            *_opts(tree["opts"] + ["OUTPUT_DIR", str(out_dir)])]


def _run_jax(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["tool", *argv])
    return module.main()


@pytest.fixture(scope="module")
def pgt(tree):
    """(JAX json, port json, their paths) of generate_pgt."""
    mp = pytest.MonkeyPatch()
    root = tree["root"]
    try:
        _run_jax(_jax_tool("generate_pgt"),
                 _argv(tree, root / "jax_out", "--out",
                       str(root / "jax_pgt.json")), mp)
    finally:
        mp.undo()
    generate_pgt.main(_argv(tree, root / "port_out", "--out",
                            str(root / "port_pgt.json")), device="cpu")
    return (json.loads((root / "jax_pgt.json").read_text()),
            json.loads((root / "port_pgt.json").read_text()))


def test_generate_pgt_equals_jax(pgt):
    want, got = pgt
    assert got["images"] == want["images"]
    assert got["categories"] == want["categories"]
    assert len(got["annotations"]) == len(want["annotations"]) > 0
    top = max(abs(v) for a in want["annotations"] for v in a["bbox"])
    for g, w in zip(got["annotations"], want["annotations"]):
        assert (g["id"], g["image_id"], g["category_id"], g["iscrowd"]) == \
            (w["id"], w["image_id"], w["category_id"], w["iscrowd"])
        np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1e-4 * top)
        np.testing.assert_allclose(g["score"], w["score"], rtol=1e-4)
    # one box a present class (the top-1 flag is always on)
    for img in got["images"]:
        cats = [a["category_id"] for a in got["annotations"]
                if a["image_id"] == img["id"]]
        assert len(cats) == len(set(cats))


def _losses_recorded(module, name, store):
    make = getattr(module, name)

    def wrapped(*a, **k):
        fn = make(*a, **k)

        def step(state, batch, rng):
            state, m = fn(state, batch, rng)
            store.append({n: float(np.asarray(v if not torch.is_tensor(v)
                                              else v.detach().cpu()))
                          for n, v in m.items()})
            return state, m
        return step
    return wrapped


def test_plain_train_net_equals_jax(tree, monkeypatch):
    from drn_wsod_torch.engine.defaults import default_argument_parser
    from drn_wsod_torch.parallel import train_parallel

    root = tree["root"]
    jt = _jax_tool("plain_train_net")
    want, got = [], []
    monkeypatch.setattr(jt, "make_sharded_train_step", _losses_recorded(
        jt, "make_sharded_train_step", want))
    impl = jax.config.jax_default_prng_impl
    try:
        jt.main(jt.default_argument_parser().parse_args(
            _argv(tree, root / "jax_plain")))
    finally:
        jax.config.update("jax_default_prng_impl", impl)
    monkeypatch.setattr(train_parallel, "make_sharded_train_step",
                        _losses_recorded(train_parallel,
                                         "make_sharded_train_step", got))
    state = plain_train_net.main(default_argument_parser().parse_args(
        _argv(tree, root / "port_plain")), device="cpu")
    assert len(got) == len(want) == 3 and state.step == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    assert (root / "port_plain" / "checkpoints" / "model_0000003.pth").exists()


def _read(path: Path) -> np.ndarray:
    if path.suffix == ".png":
        return read_png(str(path))
    return np.asarray(Image.open(path))


def test_visualize_data_equals_jax(tree, monkeypatch):
    root = tree["root"]
    jt = _jax_tool("visualize_data")
    with truncated_text():
        _run_jax(jt, ["--config-file", FLAGSHIP, "--output",
                      str(root / "jax_vis"), "--n", "4",
                      *_opts(tree["opts"])], monkeypatch)
    with no_pillow():
        n = visualize_data.main(["--config-file", FLAGSHIP, "--output",
                                 str(root / "port_vis"), "--n", "4",
                                 *_opts(tree["opts"])])
    assert n == 4
    for i in range(4):
        name = f"sample_{i:04d}.png"
        assert np.array_equal(_read(root / "port_vis" / name),
                              _read(root / "jax_vis" / name)), name


def test_visualize_json_results_equals_jax(tree, pgt, monkeypatch):
    root = tree["root"]
    src = str(root / "port_pgt.json")
    jt = _jax_tool("visualize_json_results")
    args = ["--input", src, "--image-root", str(Path(tree["voc"])
                                                / "JPEGImages"),
            "--conf", "0.0"]
    with truncated_text():
        _run_jax(jt, args + ["--output", str(root / "jax_json")],
                 monkeypatch)
    with no_pillow():
        written = visualize_json_results.main(
            args + ["--output", str(root / "port_json")])
    assert len(written) == len({a["image_id"]
                                for a in pgt[1]["annotations"]})
    for path in map(Path, written):
        assert path.suffix == ".jpg"
        assert path.read_bytes() == \
            (root / "jax_json" / path.name).read_bytes(), path.name


def test_pgt_visualization_hook_equals_jax(tree):
    from drn_wsod_torch.engine import PGTVisualization
    from drn_wsod_tpu.engine import PGTVisualization as JaxPGT

    root = tree["root"]
    jc, pc = cfg_pair(*tree["opts"])
    flat = tree["flat"]
    batch = drn_wsod_torch.synthetic_batch(2, 64, 64, 64, 20, seed=9,
                                           device="cpu")
    batch.image.round_()
    jm = jax_build_model(jc)
    pm = drn_wsod_torch.build_model(pc, device="cpu")
    pm.load_state_dict(drn_wsod_torch.params_from_jax(flat), strict=True)

    class Trainer:
        iter, storage = 4, None

    jtr, ptr = Trainer(), Trainer()
    jtr.last_batch, ptr.last_batch = jax_batch(batch), batch
    jtr.state = type("S", (), {"params": {"params": unflatten(flat)}})()
    hooks = (JaxPGT(5, jm, str(root / "jax_hook"), pvoc.VOC_CLASS_NAMES),
             PGTVisualization(5, pm, str(root / "port_hook"),
                              pvoc.VOC_CLASS_NAMES))
    hooks[0].trainer, hooks[1].trainer = jtr, ptr
    with truncated_text():
        hooks[0].after_step()
    with no_pillow():
        hooks[1].after_step()
    names = sorted(p.name for p in (root / "port_hook" / "pgt_vis").iterdir())
    assert names == ["iter0000005_im0.png", "iter0000005_im1.png"]
    for name in names:
        assert np.array_equal(_read(root / "port_hook" / "pgt_vis" / name),
                              _read(root / "jax_hook" / "pgt_vis" / name))


def test_do_train_writes_pgt_visualizations(tree):
    root = tree["root"]
    _, pc = cfg_pair(*tree["opts"], "VIS_PERIOD", 2, "SOLVER.MAX_ITER", 2,
                     "OUTPUT_DIR", str(root / "vis_train"))
    pc.MODEL.WEIGHTS = ""
    model = drn_wsod_torch.build_model(pc, device="cpu")
    with no_pillow():
        train_net.do_train(pc, model, device="cpu")
    out = root / "vis_train" / "pgt_vis"
    assert sorted(p.name for p in out.iterdir()) == \
        ["iter0000002_im0.png", "iter0000002_im1.png"]
    assert read_png(str(out / "iter0000002_im0.png")).shape[2] == 3


def test_convert_weights(tree):
    from drn_wsod_torch.checkpoint import (Checkpointer,
                                           load_reference_weights)
    from drn_wsod_torch.engine import create_train_state
    from drn_wsod_torch.solver import build_optimizer
    from drn_wsod_tpu.checkpoint import \
        load_reference_weights as jax_load_reference
    from drn_wsod_tpu.engine.defaults import _init_variables

    root = tree["root"]
    path = convert_weights.main(["--config-file", FLAGSHIP, "--weights",
                                 str(tree["weights"]), "--out",
                                 str(root / "converted"),
                                 *_opts(tree["opts"])], device="cpu")
    assert Path(path).name == "model_0000000.pth"
    jc, pc = cfg_pair(*tree["opts"])
    model = drn_wsod_torch.build_model(pc, device="cpu")
    state = Checkpointer(str(root / "converted")).load(
        create_train_state(model, build_optimizer(pc, model)))
    want = drn_wsod_torch.build_model(pc, device="cpu")
    load_reference_weights(str(tree["weights"]), want)
    for k, v in want.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k
    jm = jax_build_model(jc)
    jv = jax_load_reference(str(tree["weights"]), _init_variables(jm, jc))
    jsd = drn_wsod_torch.params_from_jax(
        {k: np.asarray(v) for k, v in flatten(jv["params"]).items()})
    for k, v in jsd.items():
        assert torch.equal(state.model.state_dict()[k], v), k


def test_proposal_convert_equals_jax(tree, tmp_path):
    from scipy.io import savemat

    jt = _jax_tool("proposal_convert")
    records = pdata.DatasetCatalog.get(TRAIN)
    rs = np.random.RandomState(4)
    boxes = np.empty(len(records), object)
    for i in range(len(records)):
        b = rs.randint(1, 40, (5 + i, 4)).astype(np.float64)
        b[:, 2:] += b[:, :2]
        boxes[i] = b
    images = np.array([[r["image_id"]] for r in records[::-1]], object)
    savemat(tmp_path / "ss.mat", {"boxes": boxes[::-1], "images": images})
    (tmp_path / "mcg").mkdir()
    for i, r in enumerate(records):
        savemat(tmp_path / "mcg" / f"{r['image_id']}.mat",
                {"boxes": boxes[i], "scores": rs.rand(len(boxes[i]), 1)})
    for method, src in (("ss", tmp_path / "ss.mat"),
                        ("mcg", tmp_path / "mcg")):
        getattr(jt, f"convert_{method}_box")(TRAIN, str(src),
                                             str(tmp_path / f"j_{method}.pkl"))
        proposal_convert.main([method, TRAIN, str(src),
                               str(tmp_path / f"p_{method}.pkl")])
        with open(tmp_path / f"j_{method}.pkl", "rb") as f:
            want = pickle.load(f)
        with open(tmp_path / f"p_{method}.pkl", "rb") as f:
            got = pickle.load(f)
        assert got["ids"] == want["ids"] and got["bbox_mode"] == 0
        for key in ("boxes", "objectness_logits"):
            for g, w in zip(got[key], want[key]):
                assert g.dtype == w.dtype and np.array_equal(g, w)


def test_filter_events_equals_jax(tmp_path, capsys, monkeypatch):
    rs = np.random.RandomState(0)
    lines = [json.dumps({"iteration": i, "total_loss": float(rs.rand()),
                         "loss_cls": float(rs.rand()), "lr": 0.01,
                         "note": "x"}) for i in range(7)]
    (tmp_path / "metrics.json").write_text("\n".join(lines) + "\n\n")
    jt = _jax_tool("filter_events")
    for keys in ([], ["loss"], ["lr", "cls"]):
        args = [str(tmp_path / "metrics.json"), "--keys", *keys]
        _run_jax(jt, args + ["--out", str(tmp_path / "j.json")], monkeypatch)
        want = capsys.readouterr().out
        series = filter_events.main(args + ["--out", str(tmp_path / "p.json")])
        assert capsys.readouterr().out == want
        assert (tmp_path / "p.json").read_text() == \
            (tmp_path / "j.json").read_text()
        assert all(len(v) == 7 for v in series.values())


def test_analyze_model_counts_equal_jax(monkeypatch):
    """The flagship at full width: the JAX tool's counting loop over
    abstract params, the port on the meta device (no memory, no time)."""
    from drn_wsod_tpu.config import get_cfg as jax_get_cfg

    cfg = jax_get_cfg()
    cfg.merge_from_file(FLAGSHIP)
    jm = jax_build_model(cfg)
    batch = drn_wsod_torch.synthetic_batch(1, 64, 64, 64, 20,
                                           device="cpu")
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": key, "dropout": key}, jax_batch(batch), train=False))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            shapes["params"])[0]:
        top = [p.key for p in path if hasattr(p, "key")][0]
        want[top] = want.get(top, 0) + int(np.prod(leaf.shape))
    counts, flops = analyze_model.main(
        ["--config-file", FLAGSHIP, "--image-size", "64"], device="meta")
    assert counts == want
    assert flops > 0


def test_benchmark_tasks_run(tree):
    from drn_wsod_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(FLAGSHIP)
    cfg.merge_from_list(_opts(tree["opts"]) + [
        "TEST.AUG.MIN_SIZES", "(48, 64)", "TEST.AUG.MAX_SIZE", "90"])
    out = benchmark.benchmark_train_synthetic(cfg, iters=1, device="cpu",
                                              size=64)
    assert out["ms_per_iter"] > 0
    out = benchmark.benchmark_eval_synthetic(cfg, iters=1, batch_size=2,
                                             device="cpu", size=64)
    assert out["ms_per_img"] > 0
    with no_pillow():
        out = benchmark.benchmark_tta_synthetic(cfg, iters=1, device="cpu")
    assert out["views"] == 4 and out["ms_per_img"] > 0
    out = benchmark.benchmark_data(cfg, iters=2)
    assert out["ms_per_batch"] > 0
