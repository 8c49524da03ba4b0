"""The architecture the benchmark builds its weights for, read from a
configuration's merged YAML (a plain dict): the WS-ResNet's layers (the
stage rule of DRN-WSOD's ``resnet_ws.py``, as the program's
``models/backbones/resnet_ws.py:stage_specs`` has it at commit 84b8633),
the DAN and the heads, with Detectron2's parameter names. The reference,
the FLOP count and the weight generator all read this one description.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

NUM_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
# The stem's first FrozenBN scale. The tower without biases is positively
# homogeneous, so this one factor sets the scale of every map: at 1 the
# res5 features of the benchmark's images have an rms of about 57 and every
# head saturates (its softmaxes one-hot, the losses jumping 20-fold in a
# step); at 1/64 about 0.9, near a pretrained backbone's.
STEM_SCALE = 1.0 / 64.0


@dataclasses.dataclass(frozen=True)
class Conv:
    name: str           # Detectron2's, without ".weight"
    cin: int
    cout: int
    k: int
    stride: int = 1
    dilation: int = 1


@dataclasses.dataclass(frozen=True)
class Block:
    convs: Tuple[Conv, ...]          # conv1, conv2, conv3
    shortcut: object                 # Conv or None
    pool_stride: int                 # 0: no trailing 2x2 max-pool


@dataclasses.dataclass(frozen=True)
class Arch:
    stem: Tuple[Conv, ...]
    blocks: Tuple[Block, ...]
    out_channels: int
    num_classes: int
    head: str                        # "OICR" or "PCL"
    refine_k: int
    dan: Tuple[int, ...]
    resolution: int
    feature_stride: int
    pixel_mean: Tuple[float, ...]
    pixel_std: Tuple[float, ...]
    use_objectness: bool
    dropout: float
    mean_loss: bool

    def feature_size(self, size: int) -> int:
        """The map's side for an input side of ``size`` pixels."""
        s = size
        for c in self.stem:
            s = (s + 2 * (c.k // 2) - c.k) // c.stride + 1
        s //= 2
        for b in self.blocks:
            if b.pool_stride:
                s = (s - 2) // b.pool_stride + 1
        return s

    def backbone_convs(self) -> List[Conv]:
        out = list(self.stem)
        for b in self.blocks:
            out.extend(b.convs)
            if b.shortcut is not None:
                out.append(b.shortcut)
        return out


def _get(d: dict, path: str, default):
    for key in path.split("."):
        if not isinstance(d, dict) or key not in d:
            return default
        d = d[key]
    return d


def from_config(cfg: dict) -> Arch:
    """The architecture of a merged config dict (the program's defaults
    where the YAML names no value, as the config file records them)."""
    r = "MODEL.RESNETS."
    depth = int(_get(cfg, r + "DEPTH", 50))
    if depth not in NUM_BLOCKS:
        raise ValueError(f"the reference builds bottleneck WS-ResNets "
                         f"(depth 50, 101, 152), not {depth}")
    if int(_get(cfg, r + "NUM_GROUPS", 1)) != 1:
        raise ValueError("the reference builds NUM_GROUPS 1 only")
    stem_c = int(_get(cfg, r + "STEM_OUT_CHANNELS", 64))
    out_c = int(_get(cfg, r + "RES2_OUT_CHANNELS", 256))
    bc = int(_get(cfg, r + "WIDTH_PER_GROUP", 64))
    dil5 = int(_get(cfg, r + "RES5_DILATION", 2))
    stem = (Conv("backbone.stem.conv1", 3, stem_c, 3, stride=2),
            Conv("backbone.stem.conv2", stem_c, stem_c, 3),
            Conv("backbone.stem.conv3", stem_c, stem_c, 3))
    blocks, cin, stride = [], stem_c, 4
    for idx, stage in enumerate(range(2, 6)):
        dilation = dil5 if stage in (4, 5) else 1
        pool_stride = 2 if idx == 0 or (stage == 3 and dil5 == 1) else 1
        has_pool = stage in (2, 3)
        if has_pool:
            stride *= pool_stride
        n = NUM_BLOCKS[depth][idx]
        for b in range(n):
            p = f"backbone.res{stage}.{b}."
            convs = (Conv(p + "conv1", cin, bc, 1),
                     Conv(p + "conv2", bc, bc, 3, dilation=dilation),
                     Conv(p + "conv3", bc, out_c, 1))
            sc = Conv(p + "shortcut", cin, out_c, 1) if cin != out_c else None
            blocks.append(Block(convs, sc, pool_stride
                                if has_pool and b == n - 1 else 0))
            cin = out_c
        out_c, bc = out_c * 2, bc * 2
    heads = {"OICRROIHeads": "OICR", "PCLROIHeads": "PCL"}
    name = _get(cfg, "MODEL.ROI_HEADS.NAME", "")
    if name not in heads:
        raise ValueError(f"the reference has no ROI head {name!r}")
    return Arch(
        stem=stem, blocks=tuple(blocks), out_channels=cin,
        num_classes=int(_get(cfg, "MODEL.ROI_HEADS.NUM_CLASSES", 20)),
        head=heads[name],
        refine_k=int(_get(cfg, "WSL.REFINE_NUM", 3)),
        dan=tuple(int(v) for v in _get(cfg, "MODEL.ROI_BOX_HEAD.DAN_DIM",
                                       (4096, 4096))),
        resolution=int(_get(cfg, "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", 7)),
        feature_stride=stride,
        pixel_mean=tuple(float(v) for v in _get(
            cfg, "MODEL.PIXEL_MEAN", (103.530, 116.280, 123.675))),
        pixel_std=tuple(float(v) for v in _get(cfg, "MODEL.PIXEL_STD",
                                                   (1.0, 1.0, 1.0))),
        use_objectness=bool(_get(cfg, "WSL.USE_OBN", True)),
        dropout=float(_get(cfg, "MODEL.ROI_BOX_HEAD.DROPOUT", 0.5)),
        mean_loss=bool(_get(cfg, "WSL.MEAN_LOSS", True)),
    )


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str
    shape: Tuple[int, ...]
    init: str                 # "normal", "uniform", "const"
    scale: float              # std, bound or the constant
    trainable: bool


def leaves(arch: Arch) -> List[Leaf]:
    """Every parameter and persistent buffer of the model, with the rule the
    benchmark draws it by: backbone convs N(0, 1/fan_in), FrozenBN the
    identity (weight 1, bias 0, mean 0, variance 1) but for the stem's
    first, whose scale is ``STEM_SCALE``; the DAN's fcs N(0, 0.005) with
    bias 0.1, WSDDN's streams Xavier-uniform, each refinement branch's cls
    N(0, 0.01) and boxes N(0, 0.001), zero biases: DRN-WSOD's
    initialisation of the heads."""
    out = []
    for c in arch.backbone_convs():
        fan_in = c.cin * c.k * c.k
        out.append(Leaf(c.name + ".weight", (c.cout, c.cin, c.k, c.k),
                        "normal", fan_in ** -0.5, False))
        gamma = STEM_SCALE if c.name == "backbone.stem.conv1" else 1.0
        for buf, v in (("weight", gamma), ("bias", 0.0), ("running_mean", 0.0),
                       ("running_var", 1.0)):
            out.append(Leaf(f"{c.name}.norm.{buf}", (c.cout,), "const", v,
                            False))
    dims = [arch.resolution ** 2 * arch.out_channels, *arch.dan]
    for i in range(len(arch.dan)):
        out.append(Leaf(f"box_head.fc{i + 1}.weight", (dims[i + 1], dims[i]),
                        "normal", 0.005, True))
        out.append(Leaf(f"box_head.fc{i + 1}.bias", (dims[i + 1],), "const",
                        0.1, True))
    d, C = dims[-1], arch.num_classes
    bound = (6.0 / (d + C)) ** 0.5
    for s in ("cls", "det"):
        out.append(Leaf(f"box_predictor.{s}.weight", (C, d), "uniform",
                        bound, True))
        out.append(Leaf(f"box_predictor.{s}.bias", (C,), "const", 0.0, True))
    for k in range(arch.refine_k):
        p = f"box_refinery.{k}."
        out.append(Leaf(p + "cls_score.weight", (C + 1, d), "normal", 0.01,
                        True))
        out.append(Leaf(p + "cls_score.bias", (C + 1,), "const", 0.0, True))
        out.append(Leaf(p + "bbox_pred.weight", (4 * C, d), "normal", 0.001,
                        True))
        out.append(Leaf(p + "bbox_pred.bias", (4 * C,), "const", 0.0, True))
    return out
