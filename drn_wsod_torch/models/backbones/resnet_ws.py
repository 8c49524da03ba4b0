"""WS-ResNet backbone (counterpart of
``drn_wsod_tpu/models/backbones/resnet_ws.py``).

Residual blocks keep stride 1 and downsample with trailing 2x2 max-pools
(VALID padding). Under DC5 (RES5_DILATION 2) res3's trailing pool has
stride 1, so each side shrinks by one cell: a 704-pixel image gives an
87x87 res5 map.

Modules follow Detectron2's names (``stem.conv1``, ``res2.0.conv1.norm``),
so a Detectron2 state dict or the weight bridge
(:mod:`drn_wsod_torch.checkpoint.from_jax`) loads by name. The tower takes
NCHW tensors; the model feeds it ``channels_last`` memory so that cuDNN gets
its preferred layout and the NHWC view of the output is contiguous.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

NUM_BLOCKS_PER_STAGE = {
    18: [2, 2, 2, 2],
    34: [3, 4, 6, 3],
    50: [3, 4, 6, 3],
    101: [3, 4, 23, 3],
    152: [3, 8, 36, 3],
}


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics and affine, stored as buffers
    (weight, bias, running_mean, running_var). Scale and shift are folded in
    float32, then cast to the activation dtype."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return (x * scale.to(x.dtype)[:, None, None]
                + shift.to(x.dtype)[:, None, None])


class Conv2d(nn.Conv2d):
    """Bias-free conv with symmetric padding ``dilation * (k // 2)``
    followed by its FrozenBN (Detectron2's ``Conv2d(norm=...)`` layout)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, dilation: int = 1):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=dilation * (kernel // 2), dilation=dilation,
                         bias=False)
        self.norm = FrozenBatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(super().forward(x))


def _maxpool2(x: torch.Tensor, stride: int) -> torch.Tensor:
    return F.max_pool2d(x, kernel_size=2, stride=stride)


class BasicBlock(nn.Module):
    """Two 3x3 convs, a projection shortcut when the width changes, and an
    optional trailing 2x2 max-pool."""

    def __init__(self, in_channels: int, out_channels: int, dilation: int = 1,
                 has_pool: bool = False, pool_stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_channels, out_channels, 3, dilation=dilation)
        self.conv2 = Conv2d(out_channels, out_channels, 3, dilation=dilation)
        self.shortcut = (Conv2d(in_channels, out_channels, 1)
                         if in_channels != out_channels else None)
        self.has_pool, self.pool_stride = has_pool, pool_stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(F.relu(self.conv1(x)))
        sc = x if self.shortcut is None else self.shortcut(x)
        out = F.relu(out + sc)
        return _maxpool2(out, self.pool_stride) if self.has_pool else out


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (dilated) -> 1x1 bottleneck, stride-free, with an optional
    trailing 2x2 max-pool."""

    def __init__(self, in_channels: int, out_channels: int,
                 bottleneck_channels: int, dilation: int = 1,
                 has_pool: bool = False, pool_stride: int = 1):
        super().__init__()
        bc = bottleneck_channels
        self.conv1 = Conv2d(in_channels, bc, 1)
        self.conv2 = Conv2d(bc, bc, 3, dilation=dilation)
        self.conv3 = Conv2d(bc, out_channels, 1)
        self.shortcut = (Conv2d(in_channels, out_channels, 1)
                         if in_channels != out_channels else None)
        self.has_pool, self.pool_stride = has_pool, pool_stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        sc = x if self.shortcut is None else self.shortcut(x)
        out = F.relu(out + sc)
        return _maxpool2(out, self.pool_stride) if self.has_pool else out


class BasicStem(nn.Module):
    """3x3/s2 -> 3x3 -> 3x3 convs, then a 2x2/s2 max-pool. Output stride 4."""

    def __init__(self, out_channels: int = 64):
        super().__init__()
        self.conv1 = Conv2d(3, out_channels, 3, stride=2)
        self.conv2 = Conv2d(out_channels, out_channels, 3)
        self.conv3 = Conv2d(out_channels, out_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in (self.conv1, self.conv2, self.conv3):
            x = F.relu(conv(x))
        return _maxpool2(x, 2)


def stage_specs(depth: int, res5_dilation: int, res2_out_channels: int,
                bottleneck_channels: int, max_stage: int = 5) -> List[dict]:
    """Per-stage structure (``ResNetWS.stage_specs`` without the pyramid
    variant): res2 pools with stride 2; res3 pools with stride 2 unless
    res5 is dilated, then with stride 1; res4 and res5 take the dilation."""
    num_blocks = NUM_BLOCKS_PER_STAGE[depth]
    specs = []
    out_channels, bc = res2_out_channels, bottleneck_channels
    for idx, stage_idx in enumerate(range(2, max_stage + 1)):
        specs.append(dict(
            stage=f"res{stage_idx}",
            num_blocks=num_blocks[idx],
            dilation=res5_dilation if stage_idx in (4, 5) else 1,
            pool_stride=(2 if idx == 0 or (stage_idx == 3 and res5_dilation == 1)
                         else 1),
            has_pool=stage_idx in (2, 3),
            out_channels=out_channels,
            bottleneck_channels=bc,
        ))
        out_channels *= 2
        bc *= 2
    return specs


class ResNetWS(nn.Module):
    """The WS-ResNet tower; returns {stage: NCHW map} for ``out_features``."""

    def __init__(self, depth: int = 50, width_per_group: int = 64,
                 stem_out_channels: int = 64, res2_out_channels: int = 256,
                 res5_dilation: int = 2, out_features=("res5",)):
        super().__init__()
        basic = depth in (18, 34)
        if basic and res2_out_channels != 64:
            raise ValueError("R18/R34 need RES2_OUT_CHANNELS=64")
        self.out_features = tuple(out_features)
        self.stem = BasicStem(stem_out_channels)
        max_stage = max(int(f[-1]) for f in self.out_features)
        self.specs = stage_specs(depth, res5_dilation, res2_out_channels,
                                 width_per_group, max_stage=max_stage)
        in_ch = stem_out_channels
        self.stage_names = []
        for spec in self.specs:
            blocks = []
            for b in range(spec["num_blocks"]):
                kwargs = dict(dilation=spec["dilation"],
                              has_pool=spec["has_pool"]
                              and b == spec["num_blocks"] - 1,
                              pool_stride=spec["pool_stride"])
                if basic:
                    blocks.append(BasicBlock(in_ch, spec["out_channels"],
                                             **kwargs))
                else:
                    blocks.append(BottleneckBlock(
                        in_ch, spec["out_channels"],
                        spec["bottleneck_channels"], **kwargs))
                in_ch = spec["out_channels"]
            self.add_module(spec["stage"], nn.Sequential(*blocks))
            self.stage_names.append(spec["stage"])

    @property
    def feature_strides(self) -> Dict[str, int]:
        stride, strides = 4, {}
        for spec in self.specs:
            if spec["has_pool"]:
                stride *= spec["pool_stride"]
            strides[spec["stage"]] = stride
        return strides

    @property
    def feature_channels(self) -> Dict[str, int]:
        return {s["stage"]: s["out_channels"] for s in self.specs}

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem(x)
        outputs = {}
        for name in self.stage_names:
            x = getattr(self, name)(x)
            if name in self.out_features:
                outputs[name] = x
        return outputs


def build_ws_resnet_backbone(cfg) -> ResNetWS:
    """Config-driven builder (``resnet_ws.py:build_ws_resnet_backbone``).
    Deformable blocks, grouped convs and trainable BN come with later
    slices of the port and raise here."""
    r = cfg.MODEL.RESNETS
    if any(r.DEFORM_ON_PER_STAGE):
        raise NotImplementedError(
            "deformable WS-ResNet blocks are not ported yet")
    if r.NUM_GROUPS != 1:
        raise NotImplementedError("grouped WS-ResNet convs are not ported yet")
    if r.NORM != "FrozenBN":
        raise NotImplementedError(
            f"NORM {r.NORM!r}: only FrozenBN is ported (trainable BN comes "
            "with the training slice)")
    return ResNetWS(
        depth=r.DEPTH,
        width_per_group=r.WIDTH_PER_GROUP,
        stem_out_channels=r.STEM_OUT_CHANNELS,
        res2_out_channels=r.RES2_OUT_CHANNELS,
        res5_dilation=r.RES5_DILATION,
        out_features=tuple(r.OUT_FEATURES),
    )
