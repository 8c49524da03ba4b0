"""WS-ResNet and plain ResNet backbones (counterpart of
``drn_wsod_tpu/models/backbones/resnet_ws.py``).

Residual blocks keep stride 1 and downsample with trailing 2x2 max-pools
(VALID padding). Under DC5 (RES5_DILATION 2) res3's trailing pool has
stride 1, so each side shrinks by one cell: a 704-pixel image gives an
87x87 res5 map. The pyramid variant (``pyramid=True``, the FPN's bottom-up
tower) pools after res3, res4 and res5 with stride 2 and no dilation, for
strides 4/8/16/32. The plain ResNet (``ResNetPlain``) strides its blocks
instead, from a 7x7 stem; under DC5 its res5 is at stride 16.

``NUM_GROUPS`` > 1 groups the bottlenecks' 3x3 convs (ResNeXt), in both
towers. ``DEFORM_ON_PER_STAGE`` makes a WS stage's bottlenecks deformable
(:class:`DeformBottleneckBlock`, modulated under ``DEFORM_MODULATED``); the
plain ResNet and the pyramid tower ignore it, as the JAX package's builders
do.

Modules follow Detectron2's names (``stem.conv1``, ``res2.0.conv1.norm``),
so a Detectron2 state dict or the weight bridge
(:mod:`drn_wsod_torch.checkpoint.from_jax`) loads by name. The tower takes
NCHW tensors; the model feeds it ``channels_last`` memory so that cuDNN gets
its preferred layout and the NHWC view of the output is contiguous.

``MODEL.RESNETS.NORM`` "BN", "SyncBN" or "naiveSyncBN" gives
:class:`BatchNorm`, every other value FrozenBN, as in the JAX package
("GN" too). Like the JAX package's, that BatchNorm always normalises with
its running statistics and returns float32, so each following conv casts
its input back to ``MODEL.DTYPE`` and the tower's output is float32.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.deform_conv import deform_conv2d

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


class BatchNorm(nn.Module):
    """BatchNorm as the JAX package runs it (flax's ``nn.BatchNorm``). The
    detection models use its running statistics always, never updated
    (``use_running_average=True``: their backbone is never called in
    train mode). The affine (``weight``, ``bias``) is a float32 parameter
    the optimizer labels frozen; the statistics are float32 buffers,
    written only by PreciseBN. Computed in flax's order in float32,
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias``, and returned in
    float32.

    ``batch_stats = True`` (set by :func:`use_batch_stats`; the ImageNet
    tool alone sets it) is flax's train mode: the mean and the fast
    variance ``max(0, E[x^2] - E[x]^2)`` of the batch over (N, H, W) in
    float32 normalise, and the running statistics take
    ``momentum * running + (1 - momentum) * batch`` (momentum 0.9)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.batch_stats = False
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.batch_stats:
            mean = x.mean((0, 2, 3))
            var = ((x * x).mean((0, 2, 3)) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


def use_batch_stats(module: nn.Module, on: bool = True) -> None:
    """Put every :class:`BatchNorm` under ``module`` in flax's train mode
    (``on``) or back to its running statistics."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.batch_stats = on


BATCH_NORMS = ("BN", "SyncBN", "naiveSyncBN")


def norm_layer(norm: str, num_features: int) -> nn.Module:
    """BatchNorm for ``BATCH_NORMS``, FrozenBN for every other ``norm``
    (the JAX package's ``_norm_layer``)."""
    if norm in BATCH_NORMS:
        return BatchNorm(num_features)
    return FrozenBatchNorm(num_features)


class Conv2d(nn.Conv2d):
    """Bias-free conv with symmetric padding ``dilation * (k // 2)``
    followed by its norm (Detectron2's ``Conv2d(norm=...)`` layout). Input
    and weight are cast to ``dtype`` (the input's own where None) at each
    use: a trainable stage keeps float32 masters and computes in the
    model's dtype, as flax's ``nn.Conv(dtype=..., param_dtype=float32)``
    does; a frozen stage's weight is stored in that dtype already."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, dilation: int = 1, norm: str = "FrozenBN",
                 dtype: Optional[torch.dtype] = None, groups: int = 1):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=dilation * (kernel // 2), dilation=dilation,
                         groups=groups, bias=False)
        self.norm = norm_layer(norm, out_channels)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or x.dtype
        return self.norm(self._conv_forward(x.to(dt), self.weight.to(dt),
                                            None))


def _maxpool2(x: torch.Tensor, stride: int) -> torch.Tensor:
    return F.max_pool2d(x, kernel_size=2, stride=stride)


class BasicBlock(nn.Module):
    """Two 3x3 convs, a projection shortcut when the width changes or the
    block strides, and an optional trailing 2x2 max-pool. ``stride`` > 1 is
    the plain ResNet's downsampling (on conv1 and the shortcut); the WS
    blocks keep stride 1 and pool instead."""

    def __init__(self, in_channels: int, out_channels: int, dilation: int = 1,
                 has_pool: bool = False, pool_stride: int = 1,
                 stride: int = 1, norm: str = "FrozenBN",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        conv = functools.partial(Conv2d, norm=norm, dtype=dtype)
        self.conv1 = conv(in_channels, out_channels, 3, stride=stride,
                          dilation=dilation)
        self.conv2 = conv(out_channels, out_channels, 3, dilation=dilation)
        self.shortcut = (conv(in_channels, out_channels, 1, stride=stride)
                         if in_channels != out_channels or stride > 1
                         else None)
        self.has_pool, self.pool_stride = has_pool, pool_stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(F.relu(self.conv1(x)))
        sc = x if self.shortcut is None else self.shortcut(x)
        out = F.relu(out + sc)
        return _maxpool2(out, self.pool_stride) if self.has_pool else out


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (dilated, in ``num_groups`` groups) -> 1x1 bottleneck with
    an optional trailing 2x2 max-pool. ``stride`` > 1 (the plain ResNet)
    strides the first 1x1 where ``stride_in_1x1``, else the 3x3, and the
    shortcut."""

    def __init__(self, in_channels: int, out_channels: int,
                 bottleneck_channels: int, dilation: int = 1,
                 has_pool: bool = False, pool_stride: int = 1,
                 stride: int = 1, stride_in_1x1: bool = True,
                 num_groups: int = 1, norm: str = "FrozenBN",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        bc = bottleneck_channels
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        conv = functools.partial(Conv2d, norm=norm, dtype=dtype)
        self.conv1 = conv(in_channels, bc, 1, stride=s1)
        self.conv2 = conv(bc, bc, 3, stride=s3, dilation=dilation,
                          groups=num_groups)
        self.conv3 = conv(bc, out_channels, 1)
        self.shortcut = (conv(in_channels, out_channels, 1, stride=stride)
                         if in_channels != out_channels or stride > 1
                         else None)
        self.has_pool, self.pool_stride = has_pool, pool_stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        sc = x if self.shortcut is None else self.shortcut(x)
        out = F.relu(out + sc)
        return _maxpool2(out, self.pool_stride) if self.has_pool else out


class DeformConv2d(Conv2d):
    """The deformable 3x3 conv of :class:`DeformBottleneckBlock` and its
    norm: ``weight`` (the JAX package's ``conv2_deform_weight``) is cast to
    ``dtype`` at each use, and :func:`drn_wsod_torch.ops.deform_conv.
    deform_conv2d` samples and contracts."""

    def forward(self, x: torch.Tensor, offsets: torch.Tensor,
                modulation: Optional[torch.Tensor]) -> torch.Tensor:
        """x (B, C, H, W); offsets (B, H, W, 2*K*K) and modulation (B, H,
        W, K*K) float32, or None."""
        dt = self.compute_dtype or x.dtype
        out = deform_conv2d(x.to(dt).permute(0, 2, 3, 1), offsets,
                            self.weight.to(dt), modulation,
                            dilation=self.dilation[0])
        return self.norm(out.permute(0, 3, 1, 2))


class DeformBottleneckBlock(nn.Module):
    """A bottleneck whose 3x3 conv is deformable (v1) or modulated
    deformable (v2): ``conv2_offset`` (a 3x3 conv with bias, 18 channels,
    or 27 modulated) gives each position's per-tap offsets. It runs in
    float32 on the upcast input, whatever the model's dtype: in the JAX
    package flax promotes the bfloat16 input with its float32 parameters.
    The modulated layout is x offsets, y offsets, mask, re-interleaved as
    (dy, dx) per tap, the mask through a sigmoid. The shortcut projects
    where the width changes; the block never strides."""

    def __init__(self, in_channels: int, out_channels: int,
                 bottleneck_channels: int, dilation: int = 1,
                 has_pool: bool = False, pool_stride: int = 1,
                 deform_modulated: bool = False, norm: str = "FrozenBN",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        bc = bottleneck_channels
        conv = functools.partial(Conv2d, norm=norm, dtype=dtype)
        self.conv1 = conv(in_channels, bc, 1)
        self.modulated = deform_modulated
        self.conv2_offset = nn.Conv2d(bc, 27 if deform_modulated else 18, 3,
                                      padding=dilation, dilation=dilation)
        self.conv2 = DeformConv2d(bc, bc, 3, dilation=dilation, norm=norm,
                                  dtype=dtype)
        self.conv3 = conv(bc, out_channels, 1)
        self.shortcut = (conv(in_channels, out_channels, 1)
                         if in_channels != out_channels else None)
        self.has_pool, self.pool_stride = has_pool, pool_stride

    def offsets(self, x: torch.Tensor):
        """(offsets, modulation or None) of conv1's output ``x``, float32,
        channels last: the conv's product, then its bias."""
        c = self.conv2_offset
        off = F.conv2d(x.float(), c.weight.float(), None, padding=c.padding,
                       dilation=c.dilation) + c.bias.float()[:, None, None]
        off = off.permute(0, 2, 3, 1)
        if not self.modulated:
            return off, None
        off_x, off_y, mask = off.chunk(3, dim=-1)
        offsets = torch.stack([off_y, off_x], -1).flatten(-2)
        return offsets, torch.sigmoid(mask)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out, *self.offsets(out)))
        out = self.conv3(out)
        sc = x if self.shortcut is None else self.shortcut(x)
        out = F.relu(out + sc)
        return _maxpool2(out, self.pool_stride) if self.has_pool else out


class BasicStem(nn.Module):
    """3x3/s2 -> 3x3 -> 3x3 convs, then a 2x2/s2 max-pool. Output stride 4."""

    def __init__(self, out_channels: int = 64, norm: str = "FrozenBN",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        conv = functools.partial(Conv2d, norm=norm, dtype=dtype)
        self.conv1 = conv(3, out_channels, 3, stride=2)
        self.conv2 = conv(out_channels, out_channels, 3)
        self.conv3 = conv(out_channels, out_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in (self.conv1, self.conv2, self.conv3):
            x = F.relu(conv(x))
        return _maxpool2(x, 2)


def stage_specs(depth: int, res5_dilation: int, res2_out_channels: int,
                bottleneck_channels: int, max_stage: int = 5,
                pyramid: bool = False) -> List[dict]:
    """Per-stage structure (``ResNetWS.stage_specs``): res2 pools with
    stride 2; res3 pools with stride 2 unless res5 is dilated, then with
    stride 1; res4 and res5 take the dilation. ``pyramid``: no dilation,
    and res3, res4 and res5 each pool with stride 2 (res2 does not)."""
    num_blocks = NUM_BLOCKS_PER_STAGE[depth]
    specs = []
    out_channels, bc = res2_out_channels, bottleneck_channels
    for idx, stage_idx in enumerate(range(2, max_stage + 1)):
        if pyramid:
            dilation, pool_stride, has_pool = 1, 2, stage_idx >= 3
        else:
            dilation = res5_dilation if stage_idx in (4, 5) else 1
            pool_stride = (2 if idx == 0 or (stage_idx == 3
                                             and res5_dilation == 1) else 1)
            has_pool = stage_idx in (2, 3)
        specs.append(dict(
            stage=f"res{stage_idx}",
            num_blocks=num_blocks[idx],
            dilation=dilation,
            pool_stride=pool_stride,
            has_pool=has_pool,
            out_channels=out_channels,
            bottleneck_channels=bc,
        ))
        out_channels *= 2
        bc *= 2
    return specs


class ResNetWS(nn.Module):
    """The WS-ResNet tower; returns {stage: NCHW map} for ``out_features``.
    ``deform_on_per_stage[i]`` makes stage res{i+2}'s bottlenecks
    deformable (not with ``num_groups`` > 1, which the JAX package's
    deformable block asserts against)."""

    def __init__(self, depth: int = 50, num_groups: int = 1,
                 width_per_group: int = 64, stem_out_channels: int = 64,
                 res2_out_channels: int = 256, res5_dilation: int = 2,
                 out_features=("res5",), pyramid: bool = False,
                 norm: str = "FrozenBN",
                 deform_on_per_stage=(False,) * 4,
                 deform_modulated: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        basic = depth in (18, 34)
        if basic and res2_out_channels != 64:
            raise ValueError("R18/R34 need RES2_OUT_CHANNELS=64")
        self.out_features = tuple(out_features)
        self.stem = BasicStem(stem_out_channels, norm=norm, dtype=dtype)
        max_stage = max(int(f[-1]) for f in self.out_features)
        self.specs = stage_specs(depth, res5_dilation, res2_out_channels,
                                 num_groups * width_per_group,
                                 max_stage=max_stage, pyramid=pyramid)
        in_ch = stem_out_channels
        self.stage_names = []
        for i, spec in enumerate(self.specs):
            deform = (not basic and i < len(deform_on_per_stage)
                      and deform_on_per_stage[i])
            if deform and num_groups != 1:
                raise ValueError("the deformable bottleneck supports "
                                 "NUM_GROUPS 1 only")
            blocks = []
            for b in range(spec["num_blocks"]):
                kwargs = dict(dilation=spec["dilation"],
                              has_pool=spec["has_pool"]
                              and b == spec["num_blocks"] - 1,
                              pool_stride=spec["pool_stride"], norm=norm,
                              dtype=dtype)
                if basic:
                    blocks.append(BasicBlock(in_ch, spec["out_channels"],
                                             **kwargs))
                elif deform:
                    blocks.append(DeformBottleneckBlock(
                        in_ch, spec["out_channels"],
                        spec["bottleneck_channels"],
                        deform_modulated=deform_modulated, **kwargs))
                else:
                    blocks.append(BottleneckBlock(
                        in_ch, spec["out_channels"],
                        spec["bottleneck_channels"], num_groups=num_groups,
                        **kwargs))
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


def model_dtype(cfg) -> torch.dtype:
    """``MODEL.DTYPE`` as a torch dtype."""
    return torch.bfloat16 if cfg.MODEL.DTYPE == "bfloat16" else torch.float32


def build_ws_resnet_backbone(cfg) -> ResNetWS:
    """Config-driven builder (``resnet_ws.py:build_ws_resnet_backbone``)."""
    r = cfg.MODEL.RESNETS
    return ResNetWS(
        depth=r.DEPTH,
        num_groups=r.NUM_GROUPS,
        width_per_group=r.WIDTH_PER_GROUP,
        stem_out_channels=r.STEM_OUT_CHANNELS,
        res2_out_channels=r.RES2_OUT_CHANNELS,
        res5_dilation=r.RES5_DILATION,
        out_features=tuple(r.OUT_FEATURES),
        norm=r.NORM,
        deform_on_per_stage=tuple(r.DEFORM_ON_PER_STAGE),
        deform_modulated=r.DEFORM_MODULATED,
        dtype=model_dtype(cfg),
    )


class PlainStem(nn.Module):
    """The standard ResNet stem: a 7x7/s2 conv, its norm and ReLU, then a
    3x3/s2 max-pool padded by 1 (with -inf, as flax pads it). Output
    stride 4."""

    def __init__(self, out_channels: int = 64, norm: str = "FrozenBN",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv2d(3, out_channels, 7, stride=2, norm=norm,
                            dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(F.relu(self.conv1(x)), kernel_size=3, stride=2,
                            padding=1)


class ResNetPlain(nn.Module):
    """The standard strided ResNet (``resnet_ws.py:ResNetPlain``; the
    ``wsddn_R_*`` configs): the first block of res3 and res4 strides by 2,
    and res5's too unless ``res5_dilation`` is 2 (DC5), where every res5
    block is dilated and res5 stays at stride 16."""

    def __init__(self, depth: int = 50, num_groups: int = 1,
                 width_per_group: int = 64,
                 stem_out_channels: int = 64, res2_out_channels: int = 256,
                 res5_dilation: int = 2, stride_in_1x1: bool = True,
                 out_features=("res5",), norm: str = "FrozenBN",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        basic = depth in (18, 34)
        if basic and res2_out_channels != 64:
            raise ValueError("R18/R34 need RES2_OUT_CHANNELS=64")
        self.res5_dilation = res5_dilation
        self.res2_out_channels = res2_out_channels
        self.out_features = tuple(out_features)
        self.stem = PlainStem(stem_out_channels, norm=norm, dtype=dtype)
        num_blocks = NUM_BLOCKS_PER_STAGE[depth]
        max_stage = max(int(f[-1]) for f in self.out_features)
        in_ch, out_ch, bc = stem_out_channels, res2_out_channels, \
            num_groups * width_per_group
        self.stage_names = []
        for idx, stage_idx in enumerate(range(2, max_stage + 1)):
            dilation = res5_dilation if stage_idx == 5 else 1
            first_stride = (1 if idx == 0 or (stage_idx == 5
                                             and dilation == 2) else 2)
            blocks = []
            for b in range(num_blocks[idx]):
                stride = first_stride if b == 0 else 1
                if basic:
                    blocks.append(BasicBlock(in_ch, out_ch, dilation=dilation,
                                             stride=stride, norm=norm,
                                             dtype=dtype))
                else:
                    blocks.append(BottleneckBlock(
                        in_ch, out_ch, bc, dilation=dilation, stride=stride,
                        stride_in_1x1=stride_in_1x1, num_groups=num_groups,
                        norm=norm, dtype=dtype))
                in_ch = out_ch
            self.add_module(f"res{stage_idx}", nn.Sequential(*blocks))
            self.stage_names.append(f"res{stage_idx}")
            out_ch *= 2
            bc *= 2

    @property
    def feature_strides(self) -> Dict[str, int]:
        strides, s = {}, 4
        for i, stage in enumerate(("res2", "res3", "res4", "res5")):
            if i > 0 and not (stage == "res5" and self.res5_dilation == 2):
                s *= 2
            strides[stage] = s
        return strides

    @property
    def feature_channels(self) -> Dict[str, int]:
        return {stage: self.res2_out_channels * 2 ** i
                for i, stage in enumerate(("res2", "res3", "res4", "res5"))}

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem(x)
        outputs = {}
        for name in self.stage_names:
            x = getattr(self, name)(x)
            if name in self.out_features:
                outputs[name] = x
        return outputs


def build_resnet_backbone(cfg) -> ResNetPlain:
    """The plain (strided) ResNet builder (``resnet_ws.py:
    build_resnet_backbone``, Detectron2's ``build_resnet_backbone``); it
    ignores ``DEFORM_ON_PER_STAGE``, as the JAX package's does."""
    r = cfg.MODEL.RESNETS
    return ResNetPlain(
        depth=r.DEPTH,
        num_groups=r.NUM_GROUPS,
        width_per_group=r.WIDTH_PER_GROUP,
        stem_out_channels=r.STEM_OUT_CHANNELS,
        res2_out_channels=r.RES2_OUT_CHANNELS,
        res5_dilation=r.RES5_DILATION,
        stride_in_1x1=r.STRIDE_IN_1X1,
        out_features=tuple(r.OUT_FEATURES),
        norm=r.NORM,
        dtype=model_dtype(cfg),
    )
