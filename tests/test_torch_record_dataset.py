"""The port's record shards against the JAX package's native ones
(``native/record_io.cpp`` through ``drn_wsod_tpu/data/record_dataset.py``):
a shard written by either package reads in the other, the same records give
byte-identical files, and ``pack_dataset`` and the packing tool embed the
decoded pixels the JAX package's packer embeds."""

import numpy as np
import pytest

from drn_wsod_torch import data as pdata
from drn_wsod_torch.data import record_dataset as prec
from drn_wsod_torch.data.datasets import voc as pvoc
from drn_wsod_torch.tools import pack_dataset as ptool
from drn_wsod_tpu.data import record_dataset as jrec
from test_torch_common import write_voc


def _records(n=6, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        h, w = rs.randint(5, 40, 2)
        out.append({
            "image_id": f"{i:06d}", "height": int(h), "width": int(w),
            "image": rs.randint(0, 256, (h, w, 3)).astype(np.uint8),
            "proposal_boxes": rs.uniform(0, 30, (rs.randint(0, 9), 4))
            .astype(np.float32),
            "annotations": [{"category_id": int(rs.randint(20)),
                             "bbox": [1.0, 2.0, 3.0, 4.0], "difficult": 0}]})
    return out


def _assert_same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype
            np.testing.assert_array_equal(got[k], v)
        else:
            assert got[k] == v


@pytest.mark.parametrize("n", [0, 1, 6])
def test_shards_byte_identical(tmp_path, n):
    records = _records(n)
    assert prec.write_records(str(tmp_path / "p.rec"), records) == n
    assert jrec.write_records(str(tmp_path / "j.rec"), records) == n
    assert (tmp_path / "p.rec").read_bytes() == \
        (tmp_path / "j.rec").read_bytes()
    assert not [p for p in tmp_path.iterdir() if ".tmp" in p.name]


def test_jax_shard_reads_in_port(tmp_path):
    records = _records(7, seed=1)
    jrec.write_records(str(tmp_path / "j.rec"), records)
    ds = prec.RecordDataset(str(tmp_path / "j.rec"))
    assert len(ds) == 7
    for i in (3, 0, 6, 3):
        _assert_same(ds[i], records[i])
    assert [r["image_id"] for r in ds] == [r["image_id"] for r in records]
    with pytest.raises(IndexError):
        ds[7]
    with pytest.raises(IndexError):
        ds[-1]
    ds.close()


def test_port_shard_reads_in_jax(tmp_path):
    records = _records(5, seed=2)
    path = str(tmp_path / "sub" / "p.rec")
    prec.write_records(path, records)
    ds = jrec.RecordDataset(path)
    assert len(ds) == 5
    for i in range(5):
        _assert_same(ds[i], records[i])


def test_not_a_shard(tmp_path):
    (tmp_path / "bad.rec").write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="magic"):
        prec.RecordDataset(str(tmp_path / "bad.rec"))
    (tmp_path / "short.rec").write_bytes(b"\0" * 8)
    with pytest.raises(ValueError, match="short"):
        prec.RecordDataset(str(tmp_path / "short.rec"))


def test_pack_dataset_equal(tmp_path):
    """Records of a VOC directory, decoded by each package's packer: the
    same pixels and fields (the JAX package decodes with its libjpeg
    binding, the port with its own decoder; the two are bit-exact)."""
    d, prop_file, images = write_voc(tmp_path, [(30, 41), (44, 36)],
                                     pvoc.VOC_CLASS_NAMES, seed=4)
    records = pdata.load_proposals_into_dataset(
        pvoc.load_voc_instances(d, "test"), prop_file)
    prec.pack_dataset(records, str(tmp_path / "p.rec"))
    jrec.pack_dataset(records, str(tmp_path / "j.rec"))
    got = list(prec.RecordDataset(str(tmp_path / "p.rec")))
    want = list(jrec.RecordDataset(str(tmp_path / "j.rec")))
    for g, w in zip(got, want):
        _assert_same(g, w)
        assert g["image"].shape[:2] == images[g["image_id"]].shape[:2]
    prec.pack_dataset(records, str(tmp_path / "n.rec"), decode_images=False)
    assert "image" not in prec.RecordDataset(str(tmp_path / "n.rec"))[0]


def test_pack_tool(tmp_path, monkeypatch, capsys):
    """``python -m drn_wsod_torch.tools.pack_dataset`` on
    $DETECTRON2_DATASETS/VOC2007: every annotated image of the split, with
    its proposals and pixels."""
    d, prop_file, images = write_voc(tmp_path, [(30, 41), (44, 36), (25, 25)],
                                     pvoc.VOC_CLASS_NAMES, split="train",
                                     seed=5)
    monkeypatch.setenv("DETECTRON2_DATASETS", str(tmp_path))
    monkeypatch.setattr(pdata.DatasetCatalog, "_registry", {})
    out = str(tmp_path / "packed" / "train.rec")
    n = ptool.main(["--dataset", "voc_2007_train", "--proposals", prop_file,
                    "--out", out])
    assert n == 2                                 # the third has no XML
    assert "Packed 2 records" in capsys.readouterr().out
    ds = prec.RecordDataset(out)
    for r in ds:
        np.testing.assert_array_equal(
            r["image"], pdata.read_image(f"{d}/JPEGImages/{r['image_id']}.jpg"))
        assert r["image"].shape[:2] == images[r["image_id"]].shape[:2]
        assert r["proposal_boxes"].shape[1] == 4


def test_tta_evaluates_packed_records(tmp_path):
    """TTA-AVG on a packed record (pixels in the record) gives what it
    gives on the same record read from its JPEG: the pixels are the
    decode's."""
    import torch

    import drn_wsod_torch
    from drn_wsod_torch.config import get_cfg

    d, prop_file, _ = write_voc(tmp_path, [(40, 52)], pvoc.VOC_CLASS_NAMES,
                                split="test", seed=6)
    records = pdata.load_proposals_into_dataset(
        pvoc.load_voc_instances(d, "test"), prop_file)
    prec.pack_dataset(records, str(tmp_path / "p.rec"))
    packed = prec.RecordDataset(str(tmp_path / "p.rec"))[0]
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.RESNETS.DEPTH", "18",
                         "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
                         "MODEL.ROI_BOX_HEAD.DAN_DIM", "[64, 64]",
                         "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "64",
                         "MODEL.DTYPE", "float32",
                         "TEST.AUG.MIN_SIZES", "(48,)", "INPUT.BUCKETS",
                         "[64]"])
    torch.set_num_threads(1)
    tta = drn_wsod_torch.GeneralizedRCNNWithTTAAVG(
        cfg, drn_wsod_torch.build_model(cfg, device="cpu"), device="cpu")
    got = tta(packed)
    want = tta(records[0])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
