"""Keypoint R-CNN head (counterpart of
``drn_wsod_tpu/models/heads/keypoint.py``): per-RoI keypoint heatmaps, the
targets' discretisation, the spatial cross entropy and the argmax decode.
Shapes are fixed: every RoI carries K keypoint slots with a validity."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.resize import resize_linear
from ...parallel import context
from ..layers import Conv2d, ConvTranspose2d, lecun_normal_


class KRCNNConvDeconvUpsampleHead(nn.Module):
    """Eight 3x3 convs of 512 with ReLU (``conv_fcn{i}``) in ``dtype``, a
    float32 4x4 stride-2 transposed conv to K (``score_lowres``), then a
    2x bilinear resize (``jax.image.resize(..., "bilinear")``, through
    ``ops/resize.py:resize_linear``): (N, r, r, Cin) -> (N, 4r, 4r, K)
    float32 heatmap logits."""

    def __init__(self, in_channels: int, num_keypoints: int = 17,
                 conv_dims: Sequence[int] = (512,) * 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_conv = len(conv_dims)
        c = in_channels
        for i, d in enumerate(conv_dims, start=1):
            self.add_module(f"conv_fcn{i}", Conv2d(c, d, 3, dtype=dtype))
            c = d
        self.score_lowres = ConvTranspose2d(c, num_keypoints, 4, 2,
                                            dtype=torch.float32)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """As flax draws them: every kernel ``lecun_normal`` (fan in = k *
        k * in), biases 0."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                k = m.kernel_size[0] * m.kernel_size[1]
                lecun_normal_(m.weight, k * m.in_channels, generator)
                m.bias.zero_()

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        x = roi_feats.permute(0, 3, 1, 2)
        for i in range(1, self.num_conv + 1):
            x = F.relu(getattr(self, f"conv_fcn{i}")(x))
        x = self.score_lowres(x).permute(0, 2, 3, 1)
        N, H, W, K = x.shape
        return resize_linear(x.contiguous(), (N, H * 2, W * 2, K))


def keypoints_to_heatmap_targets(keypoints: torch.Tensor, boxes: torch.Tensor,
                                 heatmap_size: int
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., K, 3) keypoints (x, y, visibility) and (..., 4) boxes -> the
    flat heatmap cell index of each keypoint inside its box, clipped into
    the map, (..., K) int64, and its validity (labelled, visibility > 0,
    and inside the box), (..., K) bool."""
    x1, y1 = boxes[..., 0:1], boxes[..., 1:2]
    w = (boxes[..., 2:3] - x1).clamp(min=1e-6)
    h = (boxes[..., 3:4] - y1).clamp(min=1e-6)
    px = (keypoints[..., 0] - x1) / w * heatmap_size
    py = (keypoints[..., 1] - y1) / h * heatmap_size
    xi = torch.floor(px).clamp(0, heatmap_size - 1).long()
    yi = torch.floor(py).clamp(0, heatmap_size - 1).long()
    inside = (px >= 0) & (px < heatmap_size) & (py >= 0) & \
        (py < heatmap_size)
    valid = (keypoints[..., 2] > 0) & inside
    return yi * heatmap_size + xi, valid


def keypoint_rcnn_loss(heatmap_logits: torch.Tensor, targets: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """Cross entropy over the S * S cells of each valid keypoint, averaged
    over the valid keypoints (at least 1). heatmap_logits (N, S, S, K);
    targets, valid (N, K)."""
    N, S, _, K = heatmap_logits.shape
    flat = heatmap_logits.reshape(N, S * S, K).transpose(1, 2)
    logp = torch.log_softmax(flat, -1)
    ce = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    ce = torch.where(valid, ce, 0.0)
    return ce.sum() / context.global_sum(valid.float().sum()).clamp(min=1.0)


def heatmaps_to_keypoints(heatmap_logits: torch.Tensor, boxes: torch.Tensor
                          ) -> torch.Tensor:
    """The argmax cell of each heatmap (the first on a tie) back to image
    coordinates through its (N, 4) box, with its softmax probability:
    (N, K, 3) as (x, y, score)."""
    N, S, _, K = heatmap_logits.shape
    flat = heatmap_logits.reshape(N, S * S, K)
    idx = flat.argmax(1)                                    # (N, K)
    score = torch.gather(torch.softmax(flat, 1), 1, idx[:, None])[:, 0]
    yi = torch.div(idx, S, rounding_mode="floor").float() + 0.5
    xi = (idx % S).float() + 0.5
    x1, y1 = boxes[:, 0:1], boxes[:, 1:2]
    w, h = boxes[:, 2:3] - x1, boxes[:, 3:4] - y1
    return torch.stack([x1 + xi / S * w, y1 + yi / S * h, score], -1)
