"""The port stands alone: no module of ``drn_wsod_torch`` (its ``tools``
included, nor ``chip_smoke.py``) imports JAX, flax, optax or the JAX
package, none imports Pillow at module level, the modules of the mask and
keypoint paths and of the dense paths import it nowhere (the mapper's
masks and label maps, the structures, the heads, the pasting, the COCO
evaluator and the panoptic PNGs run with Pillow blocked; the PNG reader
imports it only to fall back on), its JPEG decoder needs no libjpeg, and
its entry points refuse to fall back to the CPU silently."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import drn_wsod_torch
from test_torch_common import TOY, cfg_pair

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "drn_wsod_tpu")
SOURCES = sorted(str(p.relative_to(ROOT))
                 for p in (ROOT / "drn_wsod_torch").rglob("*.py")) \
    + ["chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("source", SOURCES)
def test_source_imports_no_jax(source):
    bad = sorted(set(_imported_roots(ROOT / source)) & set(FORBIDDEN))
    assert not bad, f"{source} imports {bad}"


@pytest.mark.parametrize("source", SOURCES)
def test_source_imports_no_pillow_at_module_level(source):
    """Pillow may be missing on the GPU machine: a module imports it, where
    it needs it, inside the function that uses it."""
    tree = ast.parse((ROOT / source).read_text(), source)
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    roots = {a.name.split(".")[0] for n in top if isinstance(n, ast.Import)
             for a in n.names}
    roots |= {n.module.split(".")[0] for n in top
              if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert "PIL" not in roots, f"{source} imports PIL at module level"


# the modules the mask and keypoint paths (chip_smoke.py's phase 23) and
# the dense paths (phases 24 and 25: RetinaNet, the semantic and panoptic
# models, their evaluators, the panoptic loader, the label maps' resize)
# run through, which import Pillow nowhere
NO_PILLOW = ("structures/masks.py", "structures/keypoints.py",
             "ops/mask_ops.py", "models/heads/keypoint.py",
             "models/heads/seg.py", "models/meta_arch.py",
             "evaluation/coco_eval.py", "evaluation/evaluator.py",
             "models/retinanet.py", "models/proposal_generator.py",
             "models/dense.py", "models/semantic_seg.py",
             "models/panoptic.py", "evaluation/sem_seg_eval.py",
             "evaluation/panoptic_eval.py", "data/datasets/coco.py",
             "data/transforms.py", "ops/resize.py")


@pytest.mark.parametrize("module", NO_PILLOW)
def test_mask_path_imports_no_pillow(module):
    path = ROOT / "drn_wsod_torch" / module
    assert "PIL" not in set(_imported_roots(path)), module


def test_mask_path_runs_with_pillow_blocked():
    """The Mask R-CNN YAML's training mapper on a fixture record (its
    masks to their digests), pasting and the COCO segm evaluator, in a
    process where ``import PIL`` fails."""
    code = """
import sys
sys.modules["PIL"] = None
import numpy as np
from drn_wsod_torch.data import DatasetMapper
from drn_wsod_torch.evaluation.coco_eval import COCODetectionEvaluator
from drn_wsod_torch.ops.mask_ops import paste_masks_in_image
from drn_wsod_torch.tools import make_mask_fixtures as F
m = F.load_manifest()
r = F.coco_records(m["coco"]["train"])[2]
e = m["mapper"][2]
out = DatasetMapper(F.mask_mapper_cfg(), True)(r, np.random.RandomState(e["seed"]))
assert [F.mask_digest(x) for x in out["gt_masks"][:len(e["masks_sha256"])]] == e["masks_sha256"]
gt = {"1": r["annotations"]}
masks = paste_masks_in_image(np.full((1, 28, 28), 0.9, np.float32),
                             np.array([[10, 10, 200, 150]], np.float32),
                             (r["height"], r["width"]))
ev = COCODetectionEvaluator(["c"] * 80, gt, tasks=("bbox", "segm"))
ev.process_single("1", np.array([[10, 10, 200, 150]]), np.array([0.5]),
                  np.array([r["annotations"][0]["category_id"]]), masks=masks)
print(sorted(ev.evaluate()), "PIL" in sys.modules and sys.modules["PIL"])
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['bbox', 'segm'] None"


def test_png_reader_imports_pillow_only_to_fall_back():
    """``data/png.py`` imports Pillow nowhere: it decodes every PNG
    (Adam7 and 16-bit files too), so it has nothing to fall back on it
    for."""
    tree = ast.parse((ROOT / "drn_wsod_torch" / "data" / "png.py")
                     .read_text())
    imports = {n.module.split(".")[0] for n in ast.walk(tree)
               if isinstance(n, ast.ImportFrom) and n.module} | \
        {a.name.split(".")[0] for n in ast.walk(tree)
         if isinstance(n, ast.Import) for a in n.names}
    assert "PIL" not in imports


def test_dense_path_runs_with_pillow_blocked():
    """The semantic YAML's training mapper on the PNG fixtures' tree (a
    canvas to its digest), a panoptic PNG's segment ids and the label
    reader, in a process where ``import PIL`` fails."""
    code = """
import sys
sys.modules["PIL"] = None
import numpy as np
from drn_wsod_torch.data import DatasetMapper
from drn_wsod_torch.data.datasets.coco import load_coco_panoptic_separated
from drn_wsod_torch.evaluation import decode_panoptic_png
from drn_wsod_torch.tools import make_png_fixtures as F
m = F.load_manifest()
root = F.FIXTURE_DIR / "panoptic"
recs = load_coco_panoptic_separated(
    str(root / "annotations/panoptic_train2017.json"), str(root),
    str(root / "panoptic_train2017"), str(root / "panoptic_stuff_train2017"),
    str(root / "annotations/instances_train2017.json"))
r, e = recs[3], m["mapper"][3]
r = dict(r, image=np.zeros((r["height"], r["width"], 3), np.uint8))
out = DatasetMapper(F.sem_mapper_cfg(), True)(r, np.random.RandomState(e["seed"]))
assert F.digest(out["sem_seg"]) == e["sha256"]
ids = decode_panoptic_png(r["pan_seg_file_name"])
assert set(np.unique(ids)) - {0} == {s["id"] for s in r["segments_info"]}
print("ok", "PIL" in sys.modules and sys.modules["PIL"])
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok None"


def test_jpeg_decoder_needs_no_libjpeg():
    csrc = ROOT / "drn_wsod_torch" / "ops" / "csrc"
    sources = sorted(csrc.glob("*.c*"))
    assert any(p.name == "jpeg_decode.cpp" for p in sources)
    for p in sources:
        assert "jpeglib.h" not in p.read_text(), p.name
    build = (ROOT / "drn_wsod_torch" / "ops" / "_build.py").read_text()
    assert "-ljpeg" not in build and "jpeglib" not in build


def test_jpeg_fixtures_committed_and_small():
    import json

    d = ROOT / "drn_wsod_torch" / "data" / "jpeg_fixtures"
    manifest = json.loads((d / "manifest.json").read_text())
    total = 0
    for name, entry in manifest["files"].items():
        assert (d / name).stat().st_size == entry["bytes"]
        total += entry["bytes"]
    total += (d / "manifest.json").stat().st_size
    assert total < 256 * 1024, total
    assert sorted(p.relative_to(d).as_posix() for p in d.rglob("*")
                  if p.is_file()) == sorted(
        [*manifest["files"], "manifest.json"])


def test_import_pulls_in_no_jax():
    code = ("import sys, drn_wsod_torch, drn_wsod_torch.ops._build, "
            "drn_wsod_torch.ops.narrow_max, "
            "drn_wsod_torch.tools.ablate_bench, "
            "drn_wsod_torch.tools.pool_banded_probe, "
            "drn_wsod_torch.tools.mosaic_dtype_probe, "
            "drn_wsod_torch.tools.train_net, drn_wsod_torch.tools.demo, "
            "drn_wsod_torch.tools.pack_dataset, drn_wsod_torch.native, "
            "drn_wsod_torch.tools.make_jpeg_fixtures, "
            "drn_wsod_torch.tools.make_mask_fixtures, "
            "drn_wsod_torch.structures.masks, "
            "drn_wsod_torch.structures.keypoints; "
            "print(sorted(m for m in sys.modules "
            f"if m.split('.')[0] in {FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_refuse_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = cfg_pair(*TOY)
    with pytest.raises(RuntimeError, match="CUDA"):
        drn_wsod_torch.build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        drn_wsod_torch.synthetic_batch(1, 64, 64, 8, 20)
    model = drn_wsod_torch.build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        drn_wsod_torch.make_detect_fn(model, 1e-5, 0.3, 10)


def test_eval_entry_points_refuse_missing_cuda(monkeypatch):
    from drn_wsod_torch.tools import train_net

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = cfg_pair(*TOY, "TEST.AUG.ENABLED", True)
    model = drn_wsod_torch.build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        drn_wsod_torch.GeneralizedRCNNWithTTAAVG(cfg, model)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_net.do_test(cfg, model)
    args = train_net.argument_parser().parse_args(["--eval-only"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_net.main(args)


def test_tools_are_covered():
    for tool in ("ablate_bench", "pool_banded_probe", "mosaic_dtype_probe",
                 "train_net", "demo", "pack_dataset", "make_jpeg_fixtures",
                 "make_mask_fixtures"):
        assert f"drn_wsod_torch/tools/{tool}.py" in SOURCES
    for module in ("ops/narrow_max.py", "ops/crf.py", "models/heads/seg.py",
                   "models/backbones/vgg.py", "native.py"):
        assert f"drn_wsod_torch/{module}" in SOURCES


def test_ablate_bench_refuses_missing_cuda(monkeypatch, capsys):
    from drn_wsod_torch.tools import ablate_bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ablate_bench.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="CUDA"):
        ablate_bench.run(1)


# the visualizers, the image writers, export and the CLIs of the last
# slice (chip_smoke.py's phase 28), which import Pillow nowhere
NO_PILLOW_TOOLS = ("utils/visualizer.py", "utils/video_visualizer.py",
                   "native.py", "export.py", "engine/hooks.py",
                   "engine/events.py", "tools/export_model.py",
                   "tools/generate_pgt.py", "tools/convert_weights.py",
                   "tools/proposal_convert.py", "tools/filter_events.py",
                   "tools/analyze_model.py", "tools/benchmark.py",
                   "tools/plain_train_net.py", "tools/imagenet.py",
                   "tools/visualize_data.py",
                   "tools/visualize_json_results.py", "tools/demo.py")


@pytest.mark.parametrize("module", NO_PILLOW_TOOLS)
def test_last_slice_imports_no_pillow(module):
    path = ROOT / "drn_wsod_torch" / module
    assert "PIL" not in set(_imported_roots(path)), module


def test_visualizers_and_writers_run_with_pillow_blocked(tmp_path):
    """Every drawing method, the video visualizer, the PNG writer and the
    JPEG encoder (each file read back by the port's own readers), in a
    process where ``import PIL`` fails."""
    code = f"""
import sys
sys.modules["PIL"] = None
import numpy as np
from drn_wsod_torch.data.mapper import read_image
from drn_wsod_torch.data.png import read_png
from drn_wsod_torch.utils.video_visualizer import VideoVisualizer
from drn_wsod_torch.utils.visualizer import Visualizer, save_pgt_visualization
rs = np.random.RandomState(0)
img = rs.randint(0, 256, (60, 80, 3)).astype(np.uint8)
v = Visualizer(img, ["a", "b", "c"])
v.draw_instance_predictions(np.array([[3.5, 14.2, 40, 50]]), [0.9], [1],
                            masks=rs.rand(1, 60, 80) > 0.5,
                            keypoints=rs.uniform(0, 60, (1, 17, 3)))
v.draw_rotated_box([40, 30, 20, 10, 30], 2, 0.5)
v.draw_panoptic_seg(rs.randint(0, 3, (60, 80)),
                    [{{"id": 1, "category_id": 0, "isthing": True}}])
v.draw_dataset_dict({{"annotations": [{{"category_id": 0, "bbox": [1, 2, 9, 9],
                     "segmentation": [[1, 1, 20, 2, 9, 30]]}}],
                     "sem_seg": rs.randint(0, 3, (60, 80))}})
v.save(r"{tmp_path}/a.png")
v.save(r"{tmp_path}/a.jpg")
assert np.array_equal(read_png(r"{tmp_path}/a.png"), v.get_image())
assert read_image(r"{tmp_path}/a.jpg", "RGB").shape == (60, 80, 3)
frame = VideoVisualizer(["a", "b"]).draw_frame(img, [[1, 2, 30, 40]], [0.7], [1])
save_pgt_visualization(img, np.array([[1, 2, 30, 40]]), [True], ["a"],
                       r"{tmp_path}", "p", "")
print(frame.shape, read_png(r"{tmp_path}/p.png").shape,
      "PIL" in sys.modules and sys.modules["PIL"])
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "(60, 80, 3) (60, 80, 3) None"


def test_last_slice_tools_are_covered():
    for tool in ("export_model", "generate_pgt", "convert_weights",
                 "proposal_convert", "filter_events", "analyze_model",
                 "benchmark", "plain_train_net", "imagenet",
                 "visualize_data", "visualize_json_results",
                 "make_font_fixtures"):
        assert f"drn_wsod_torch/tools/{tool}.py" in SOURCES
    for module in ("export.py", "utils/visualizer.py",
                   "utils/video_visualizer.py"):
        assert f"drn_wsod_torch/{module}" in SOURCES


def test_last_slice_entry_points_refuse_missing_cuda(monkeypatch, tmp_path):
    from drn_wsod_torch.tools import (analyze_model, benchmark,
                                      convert_weights, export_model,
                                      generate_pgt, imagenet)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ["--config-file", str(ROOT / "configs" / "PascalVOC-Detection"
                                / "oicr_WSR_50_DC5_1x.yaml")]
    for call in (
            lambda: export_model.main(cfg + ["--output",
                                             str(tmp_path / "m.pt2")]),
            lambda: generate_pgt.main(cfg + ["--out", str(tmp_path / "p"),
                                             "OUTPUT_DIR", str(tmp_path)]),
            lambda: imagenet.main(["--synthetic", "--iters", "1"]),
            lambda: benchmark.main(["--task", "eval"]),
            lambda: analyze_model.main(cfg),
            lambda: convert_weights.main(cfg + ["--weights", "w.pkl",
                                                "--out", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_closing_slice_modules_are_covered():
    """The evaluation core's source builds with no native/ file, and the
    probes and the core's binding are among the sources checked above."""
    for tool in ("pool_sweep", "dispatch_probe", "scan_k_probe",
                 "scan_variants_probe", "cli_throughput", "tta_probe"):
        assert f"drn_wsod_torch/tools/{tool}.py" in SOURCES
    for module in ("native.py", "evaluation/voc_eval.py", "ops/_build.py"):
        assert f"drn_wsod_torch/{module}" in SOURCES
    core = (ROOT / "drn_wsod_torch" / "ops" / "csrc" / "eval_core.cpp")
    assert "#include \"" not in core.read_text()
    assert "native/" not in (ROOT / "drn_wsod_torch" / "ops"
                             / "_build.py").read_text()
