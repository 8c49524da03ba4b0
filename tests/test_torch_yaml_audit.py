"""Which YAMLs of the config zoo the port runs: each non-base YAML under
``configs/`` goes through the port's ``models/build.py:build_model`` (on
the meta device: no weights are drawn; its meta-architecture's builder,
``_build_rcnn_wsl`` for the WSOD and supervised heads) and the function
that makes its backbone (``tools/train_net.py`` refuses nothing since the
visualizers were ported), and its datasets are looked up in the catalog ``train_net.main``
fills (``data/datasets/builtin.py:register_all``: VOC, COCO with its
panoptic-separated splits, and the web and VOC-SBD sets whose json
exists). Every YAML passes all three except those listed in ``BLOCKED``
with what stops them (the ROADMAP.md item that raises, or the catalog's
missing names). Run on its own, this file prints nothing; its cases are
the audit ROADMAP.md section 1 cites."""

from pathlib import Path

import pytest

import drn_wsod_torch
from drn_wsod_torch.data import DatasetCatalog
from drn_wsod_torch.data.datasets import register_all
from test_torch_common import CONFIGS

YAMLS = sorted(str(p.relative_to(CONFIGS)) for p in CONFIGS.rglob("*.yaml")
               if not p.name.startswith("Base"))
ITEM15 = "item 15"
BLOCKED = {
    # the web json is optional and absent here, as in the JAX package
    "Flickr/oicr_WSR_50_DC5_1x.yaml": "flickr_voc",
}
DENSE = {"COCO-Detection/retinanet_R_50_FPN_1x.yaml": "RetinaNet",
         "quick_schedules/retinanet_R_50_instant_test.yaml": "RetinaNet",
         "Misc/panoptic_fpn_R_50_1x.yaml": "PanopticFPN",
         "Misc/semantic_R_50_FPN_1x.yaml": "SemanticSegmentor"}


def _audit(path: str) -> str:
    """"pass", or what stops the YAML."""
    cfg = drn_wsod_torch.get_cfg()
    cfg.merge_from_file(str(CONFIGS / path))
    try:
        model = drn_wsod_torch.build_model(cfg, device="meta")
        if type(model).__name__ != DENSE.get(path, "GeneralizedRCNNWSL"):
            return f"built a {type(model).__name__}"
    except NotImplementedError as e:
        return str(e)
    missing = [n for n in (*cfg.DATASETS.TRAIN, *cfg.DATASETS.TEST)
               if n not in DatasetCatalog]
    return f"not in the catalog: {missing}" if missing else "pass"


def _registered_under(root):
    names = set(DatasetCatalog.list())
    register_all(str(root))
    return set(DatasetCatalog.list()) - names


@pytest.fixture(scope="module", autouse=True)
def builtin_catalog(tmp_path_factory):
    """The catalog ``train_net.main`` fills from a root without the web
    json (a fresh directory: the repository's own ``datasets/`` may hold
    one)."""
    added = _registered_under(tmp_path_factory.mktemp("no_web_json"))
    yield
    for name in added:
        DatasetCatalog.remove(name)


@pytest.mark.parametrize("path", YAMLS)
def test_yaml_runs_or_names_its_blocker(path):
    got = _audit(path)
    if path in BLOCKED:
        assert BLOCKED[path] in got and got != "pass", got
    else:
        assert got == "pass", got


def test_flickr_runs_once_its_json_exists(tmp_path):
    """The Flickr YAML stops at ``flickr_voc`` only while the web json is
    absent: with it under the root, it passes."""
    path = "Flickr/oicr_WSR_50_DC5_1x.yaml"
    jf = tmp_path / "flickr_voc" / "annotations" / "instances.json"
    jf.parent.mkdir(parents=True)
    jf.write_text('{"images": [], "annotations": [], "categories": []}')
    assert "flickr_voc" in _audit(path)
    added = _registered_under(tmp_path)
    try:
        assert added == {"flickr_voc"}
        assert _audit(path) == "pass"
    finally:
        for name in added:
            DatasetCatalog.remove(name)
    assert "flickr_voc" in _audit(path)


def test_audit_counts():
    """62 YAMLs: 61 run (30 before VGG-16, the plain ResNet and WSJDS, 50
    before the COCO data, 52 before the supervised and pyramid paths, 56
    before the mask and keypoint arms, 57 before RetinaNet, SemanticSegmentor
    and PanopticFPN), 1 is blocked: the Flickr one, by its absent json. None
    raises item 15 (the 4 dense YAMLs did until they were ported)."""
    assert len(YAMLS) == 62 and set(BLOCKED) <= set(YAMLS)
    assert len(YAMLS) - len(BLOCKED) == 61
    assert not any(ITEM15 in _audit(p) for p in YAMLS)
    assert set(DENSE) <= set(YAMLS)
    item14 = [p for p in YAMLS if p not in BLOCKED and p not in DENSE and (
        "fpn" in p or "rcnn" in p or "deform" in p)]
    assert len(item14) == 5, item14
    assert "Misc/mask_rcnn_R_50_FPN_1x.yaml" in item14
    vgg_plain_wsjds = [p for p in YAMLS if p not in BLOCKED and (
        "_V_16_" in p or "/wsddn_R_" in p or "ws_jds" in p)]
    assert len(vgg_plain_wsjds) == 20, vgg_plain_wsjds
    assert Path(CONFIGS / "PascalVOC-DetectionSegmentation"
                / "ws_jds_V_16_DC5_1x.yaml").exists()
