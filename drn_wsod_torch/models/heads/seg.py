"""The segmentation heads (counterpart of ``drn_wsod_tpu/models/heads/
seg.py``): the WSJDS branch (the ASPP semantic head over the backbone's
feature map, its loss from the CPG maps, the CRF constrain-to-boundary
targets and loss), ``MaskRCNNHead`` with ``mask_loss``, and the
PanopticFPN semantic head ``SemSegFPNHead`` with ``sem_seg_loss``.

Maps are NHWC, as the JAX package holds them: the head takes the
(B, Hf, Wf, C) feature map and returns (B, Hf, Wf, C+1) float32 logits,
background in channel 0.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.crf import crf_forward
from ...ops.resize import resize_linear
from ...parallel import context
from ..layers import Conv2d, ConvTranspose2d, lecun_normal_


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: a 1x1 conv, dilated 3x3 convs and a
    global-pool branch, each with ReLU, concatenated and projected by a 1x1
    conv with ReLU. Takes and returns NCHW."""

    def __init__(self, in_channels: int, out_channels: int = 256,
                 dilations: Sequence[int] = (6, 12, 18),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dilations = tuple(dilations)
        self.conv1x1 = Conv2d(in_channels, out_channels, 1, dtype=dtype)
        for d in self.dilations:
            self.add_module(f"conv3x3_d{d}", Conv2d(
                in_channels, out_channels, 3, dilation=d, dtype=dtype))
        self.pool_conv = Conv2d(in_channels, out_channels, 1, dtype=dtype)
        self.project = Conv2d(out_channels * (len(self.dilations) + 2),
                              out_channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [self.conv1x1(x)] + [
            getattr(self, f"conv3x3_d{d}")(x) for d in self.dilations]
        gp = self.pool_conv(x.mean(dim=(2, 3), keepdim=True))
        gp = gp.expand_as(branches[0])
        out = torch.cat([F.relu(b) for b in branches] + [F.relu(gp)], dim=1)
        return F.relu(self.project(out))


class ASPPSegHead(nn.Module):
    """ASPP, then a float32 1x1 classifier over C+1 classes (background
    channel 0, weights N(0, 0.01)): (B, Hf, Wf, Cin) -> (B, Hf, Wf, C+1)
    float32 logits."""

    def __init__(self, in_channels: int, num_classes: int,
                 aspp_channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.aspp = ASPP(in_channels, aspp_channels, dtype=dtype)
        self.predictor = Conv2d(aspp_channels, num_classes + 1, 1,
                                dtype=torch.float32)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """ASPP convs N(0, 1/fan_in), the predictor N(0, 0.01); biases 0."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                std = 0.01 if m is self.predictor else \
                    m.weight[0].numel() ** -0.5
                m.weight.normal_(0.0, std, generator=generator)
                m.bias.zero_()

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = self.aspp(features.permute(0, 3, 1, 2))
        return self.predictor(x).float().permute(0, 2, 3, 1)


def seg_targets(cpg_small: torch.Tensor, labels: torch.Tensor,
                fg_threshold: float = 0.5, bg_threshold: float = 0.1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pseudo pixel labels from (B, Hf, Wf, C) CPG maps at the seg
    resolution: a pixel whose map reaches ``fg_threshold`` for a present
    class takes the largest such class + 1; one below ``bg_threshold`` for
    every present class is background (0); the rest are ignored. Returns
    (target (B, Hf, Wf) int64, valid (B, Hf, Wf) bool)."""
    present = labels[:, None, None, :] > 0.5
    fg = (cpg_small >= fg_threshold) & present
    any_fg = fg.any(-1)
    bg = torch.where(present, cpg_small < bg_threshold,
                     torch.ones_like(fg)).all(-1) & ~any_fg
    fg_cls = torch.where(fg, cpg_small, -1.0).argmax(-1)
    target = torch.where(any_fg, fg_cls + 1, 0)
    return target, any_fg | bg


def seg_loss_from_cpg(seg_logits: torch.Tensor, cpg: torch.Tensor,
                      labels: torch.Tensor, fg_threshold: float = 0.5,
                      bg_threshold: float = 0.1) -> torch.Tensor:
    """The seg loss from (B, C, H, W) CPG maps: the maps are resized to the
    logits' (Hf, Wf) as ``jax.image.resize(..., "linear")`` does (with
    antialiasing), labelled by ``seg_targets``, and the cross entropy of
    (B, Hf, Wf, C+1) ``seg_logits`` is averaged over the valid pixels."""
    B, Hf, Wf, C1 = seg_logits.shape
    cpg_small = resize_linear(cpg, (B, C1 - 1, Hf, Wf)).permute(0, 2, 3, 1)
    target, valid = seg_targets(cpg_small, labels, fg_threshold,
                                bg_threshold)
    logp = torch.log_softmax(seg_logits, -1)
    ce = -torch.gather(logp, -1, target[..., None])[..., 0]
    ce = torch.where(valid, ce, 0.0)
    return ce.sum() / context.global_sum(valid.float().sum()).clamp(min=1.0)


def resize_images(image: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W, 3) pixels -> (B, h, w, 3) float32, each image resized as
    ``jax.image.resize(im.astype(float32), (h, w, 3), "linear")``."""
    B, _, _, C = image.shape
    return resize_linear(image.float(), (B, h, w, C))


@torch.no_grad()
def crf_constraint(seg_fg_probs: torch.Tensor, image: torch.Tensor,
                   fg_threshold: float = 0.5, bg_threshold: float = 0.5,
                   max_iter: int = 10
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CRF-refined targets and balanced weights of the constrain-to-boundary
    loss: background ``1 - max_c fg`` stacked before the (B, h, w, C)
    sigmoid foreground probabilities, refined by ``crf_forward`` against
    the (B, H, W, 3) raw-pixel image resized to (h, w); the refined
    foreground thresholded into positive and negative pixels, each weighted
    by the reciprocal of its count in its (image, class) plane. Returns
    (crf_fg, weights), both (B, h, w, C), without autograd history."""
    B, h, w, C = seg_fg_probs.shape
    img_small = resize_images(image, h, w)
    bg = 1.0 - seg_fg_probs.amax(-1, keepdim=True)
    stack = torch.cat([bg, seg_fg_probs], -1)
    crf_fg = crf_forward(stack, img_small, max_iter=max_iter)[..., 1:]
    pos = crf_fg >= fg_threshold
    neg = crf_fg < bg_threshold
    pos_cnt = pos.sum((1, 2), keepdim=True)
    neg_cnt = neg.sum((1, 2), keepdim=True)
    weights = torch.where(
        pos, 1.0 / pos_cnt.clamp(min=1),
        torch.where(neg, 1.0 / neg_cnt.clamp(min=1), 0.0))
    return crf_fg, weights.float()


def crf_constraint_loss(seg_fg_probs: torch.Tensor, crf_fg: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """Weighted KL(crf || prediction), as the reference computes it: its KL
    input is ``log(sigmoid(p))`` of the already-sigmoided prediction ``p``
    (a double sigmoid), terms above 1000 are zeroed, and the loss is a
    sum."""
    inp = torch.log(torch.sigmoid(seg_fg_probs).clamp(min=1e-12))
    kl = crf_fg * (torch.log(crf_fg.clamp(min=1e-12)) - inp)
    kl = kl * weights
    return torch.where(kl > 1000.0, 0.0, kl).sum()


class MaskRCNNHead(nn.Module):
    """Mask R-CNN's per-RoI head: ``num_conv`` 3x3 convs of ``conv_dim``
    with ReLU (``mask_fcn{i}``), a 2x2 stride-2 transposed conv with ReLU
    (``deconv``), all in ``dtype``, and a float32 1x1 ``predictor`` over
    the classes: (N, r, r, Cin) -> (N, 2r, 2r, num_classes) float32
    logits."""

    def __init__(self, in_channels: int, num_classes: int,
                 num_conv: int = 4, conv_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_conv = num_conv
        for i in range(1, num_conv + 1):
            self.add_module(f"mask_fcn{i}", Conv2d(
                in_channels if i == 1 else conv_dim, conv_dim, 3,
                dtype=dtype))
        self.deconv = ConvTranspose2d(conv_dim, conv_dim, 2, 2, dtype=dtype)
        self.predictor = Conv2d(conv_dim, num_classes, 1, dtype=torch.float32)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """As flax draws them: the convs and the deconv ``lecun_normal``
        (fan in = k * k * in), the predictor N(0, 0.001); biases 0."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                if m is self.predictor:
                    m.weight.normal_(0.0, 0.001, generator=generator)
                else:
                    k = m.kernel_size[0] * m.kernel_size[1]
                    lecun_normal_(m.weight, k * m.in_channels, generator)
                m.bias.zero_()

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        x = roi_feats.permute(0, 3, 1, 2)
        for i in range(1, self.num_conv + 1):
            x = F.relu(getattr(self, f"mask_fcn{i}")(x))
        x = F.relu(self.deconv(x))
        return self.predictor(x).float().permute(0, 2, 3, 1)


def optax_sigmoid_bce(logits: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
    """Elementwise sigmoid binary cross entropy, as the JAX package writes
    it: ``-(t * log_sigmoid(x) + (1 - t) * log_sigmoid(-x))``."""
    return -(targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))


def mask_loss(mask_logits: torch.Tensor, gt_class: torch.Tensor,
              target_masks: torch.Tensor, fg_mask: torch.Tensor
              ) -> torch.Tensor:
    """Mask R-CNN's loss: per RoI the BCE of the logits of its class
    (clamped into [0, C - 1]) against its (m, m) target, summed over the
    foreground RoIs ``fg_mask`` and divided by their count times m * m
    (at least 1). mask_logits (N, m, m, C), gt_class (N,), target_masks
    (N, m, m), fg_mask (N,)."""
    N, m, _, C = mask_logits.shape
    cls = gt_class.long().clamp(0, C - 1)
    sel = torch.gather(mask_logits, -1,
                       cls[:, None, None, None].expand(N, m, m, 1))[..., 0]
    bce = optax_sigmoid_bce(sel, target_masks)
    bce = torch.where(fg_mask[:, None, None], bce, 0.0)
    denom = (context.global_sum(fg_mask.float().sum()) * (m * m)).clamp(
        min=1.0)
    return bce.sum() / denom


class GroupNorm(nn.Module):
    """Flax's ``nn.GroupNorm(num_groups, dtype=float32)`` over an NCHW map:
    float32 statistics of each group with its fast variance,
    ``max(0, E[x^2] - E[x]^2)``, epsilon 1e-6, then ``(x - mean) *
    (rsqrt(var + eps) * weight) + bias``. (``F.group_norm`` takes the
    two-pass variance at epsilon 1e-5.) Returns float32, ``channels_last``
    where the input is."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        G = self.num_groups
        g = x.permute(0, 2, 3, 1).float().reshape(B, H, W, G, C // G)
        mean = g.mean((1, 2, 4), keepdim=True)
        var = ((g * g).mean((1, 2, 4), keepdim=True)
               - mean * mean).clamp(min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(G, C // G)
        y = (g - mean) * mul + self.bias.reshape(G, C // G)
        return y.reshape(B, H, W, C).permute(0, 3, 1, 2)


class ConvGN(Conv2d):
    """A 3x3 conv without bias in ``dtype``, then ``norm``, a float32
    :class:`GroupNorm`, then ReLU (Detectron2's ``Conv2d`` with ``norm``
    and ``activation``)."""

    def __init__(self, in_channels: int, out_channels: int, num_groups: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, 3, dtype=dtype,
                         bias=False)
        self.norm = GroupNorm(num_groups, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.norm(super().forward(x)))


class Upsample2x(nn.Module):
    """2x bilinear upsampling of an NCHW map, as ``jax.image.resize(x,
    (B, 2H, 2W, C), "bilinear")`` (``ops/resize.py:resize_linear``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        return resize_linear(x, (B, C, 2 * H, 2 * W))


class SemSegFPNHead(nn.Module):
    """PanopticFPN's semantic head: per FPN level (finest first) a scale
    head of [3x3 conv (no bias, ``dtype``) + float32 GroupNorm + ReLU, 2x
    bilinear upsampling] repeated until the level reaches
    ``common_stride`` (one conv at least); the levels summed in float32
    and a float32 1x1 ``predictor`` gives the class logits. Takes NCHW
    maps, returns (B, H/cs, W/cs, num_classes) float32 NHWC logits.

    Detectron2's names: the scale head of level ``pN`` is ``pN``, its convs
    at the even indices (``sem_seg_head.p4.2.norm.weight``), the
    upsamplings, which hold nothing, at the odd ones (a level at
    ``common_stride`` has none). Flax's
    ``scale_head_{i}_conv{k}`` and ``_gn{k}`` (levels numbered from 0)
    reach them through ``checkpoint/from_jax.py``."""

    def __init__(self, in_channels: Sequence[int], in_features: Sequence[str],
                 in_strides: Sequence[int], num_classes: int,
                 common_stride: int = 4, conv_dim: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_features = tuple(in_features)
        groups = min(32, conv_dim)
        for f, cin, stride in zip(self.in_features, in_channels, in_strides):
            length = max(1, int(np.log2(stride) - np.log2(common_stride)))
            ops = []
            for k in range(length):
                ops.append(ConvGN(cin if k == 0 else conv_dim, conv_dim,
                                  groups, dtype=dtype))
                if stride != common_stride:
                    ops.append(Upsample2x())
                    stride //= 2
            self.add_module(f, nn.Sequential(*ops))
        self.predictor = Conv2d(conv_dim, num_classes, 1, dtype=torch.float32)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """As flax draws them: convs and the predictor ``lecun_normal``,
        the predictor's bias 0, GroupNorm's weight 1 and bias 0."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                k = m.kernel_size[0] * m.kernel_size[1]
                lecun_normal_(m.weight, k * m.in_channels, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        summed = None
        for f, x in zip(self.in_features, feats):
            x = getattr(self, f)(x)
            summed = x if summed is None else summed + x
        return self.predictor(summed).permute(0, 2, 3, 1)


def sem_seg_loss(logits: torch.Tensor, targets: torch.Tensor,
                 ignore_value: int = 255) -> torch.Tensor:
    """Pixelwise cross entropy of (B, h, w, C) logits at their own
    resolution against (B, h, w) integer targets, averaged over the pixels
    that are not ``ignore_value`` (the caller strides the targets down to
    the logits)."""
    valid = targets != ignore_value
    tgt = torch.where(valid, targets, 0).long()
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    ce = torch.where(valid, ce, 0.0)
    return ce.sum() / context.global_sum(valid.sum()).clamp(min=1)
