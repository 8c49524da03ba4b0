"""Which YAMLs of the config zoo the port runs: each non-base YAML under
``configs/`` goes through the port's ``models/build.py:_build_rcnn_wsl``
(on the meta device: no weights are drawn), its backbone builder and
``tools/train_net.py:_refuse_unported``, and its datasets are looked up
in the catalog ``train_net.main`` fills (``data/datasets/builtin.py:
register_all``: VOC, COCO, and the web and VOC-SBD sets whose json
exists). Every YAML passes all four except those listed in ``BLOCKED``
with the ROADMAP.md item that raises for them (or the catalog's missing
names). Run on its own, this file prints nothing; its cases are the audit
ROADMAP.md section 1 cites."""

from pathlib import Path

import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch.data import DatasetCatalog
from drn_wsod_torch.data.datasets import register_all
from drn_wsod_torch.models.build import _build_rcnn_wsl
from drn_wsod_torch.tools import train_net
from test_torch_common import CONFIGS

YAMLS = sorted(str(p.relative_to(CONFIGS)) for p in CONFIGS.rglob("*.yaml")
               if not p.name.startswith("Base"))
ITEM15 = "item 15"
BLOCKED = {
    "COCO-Detection/retinanet_R_50_FPN_1x.yaml": ITEM15,
    "quick_schedules/retinanet_R_50_instant_test.yaml": ITEM15,
    "Misc/panoptic_fpn_R_50_1x.yaml": ITEM15,
    "Misc/semantic_R_50_FPN_1x.yaml": ITEM15,
    # the web json is optional and absent here, as in the JAX package
    "Flickr/oicr_WSR_50_DC5_1x.yaml": "flickr_voc",
}


def _audit(path: str) -> str:
    """"pass", or what stops the YAML."""
    cfg = drn_wsod_torch.get_cfg()
    cfg.merge_from_file(str(CONFIGS / path))
    try:
        if cfg.MODEL.META_ARCHITECTURE != "GeneralizedRCNNWSL":
            drn_wsod_torch.build_model(cfg, device="meta")
        with torch.device("meta"):
            _build_rcnn_wsl(cfg)
        train_net._refuse_unported(cfg)
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
    """62 YAMLs: 57 run (30 before VGG-16, the plain ResNet and WSJDS, 50
    before the COCO data, 52 before the supervised and pyramid paths, 56
    before the mask and keypoint arms), 5 are blocked: 4 by item 15, the
    Flickr one by its absent json."""
    assert len(YAMLS) == 62 and set(BLOCKED) <= set(YAMLS)
    assert len(YAMLS) - len(BLOCKED) == 57
    assert sum(v == ITEM15 for v in BLOCKED.values()) == 4
    item14 = [p for p in YAMLS if p not in BLOCKED and (
        "fpn" in p or "rcnn" in p or "deform" in p)]
    assert len(item14) == 5, item14
    assert "Misc/mask_rcnn_R_50_FPN_1x.yaml" in item14
    vgg_plain_wsjds = [p for p in YAMLS if p not in BLOCKED and (
        "_V_16_" in p or "/wsddn_R_" in p or "ws_jds" in p)]
    assert len(vgg_plain_wsjds) == 20, vgg_plain_wsjds
    assert Path(CONFIGS / "PascalVOC-DetectionSegmentation"
                / "ws_jds_V_16_DC5_1x.yaml").exists()
