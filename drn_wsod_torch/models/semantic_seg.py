"""SemanticSegmentor, plain semantic segmentation (counterpart of
``drn_wsod_tpu/models/semantic_seg.py``): the FPN backbone, the
``SemSegFPNHead`` and a per-pixel cross entropy at the head's resolution.
The dense evaluation loop upsamples and takes the argmax
(``evaluation/evaluator.py:make_sem_seg_fn``)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..structures.batch import WSODBatch
from .dense import PyramidModel, nchw
from .heads.seg import SemSegFPNHead, sem_seg_loss


class SemanticSegmentor(PyramidModel):
    def __init__(self, backbone: nn.Module, *,
                 sem_in_features: Sequence[str] = ("p2", "p3", "p4", "p5"),
                 sem_strides: Sequence[int] = (4, 8, 16, 32),
                 num_classes: int = 54, common_stride: int = 4,
                 conv_dim: int = 128, loss_weight: float = 1.0,
                 ignore_value: int = 255,
                 pixel_mean: Sequence[float] = (103.53, 116.28, 123.675),
                 pixel_std: Sequence[float] = (57.375, 57.12, 58.395),
                 dtype: torch.dtype = torch.float32):
        super().__init__(backbone, pixel_mean, pixel_std, dtype)
        self.sem_in_features = tuple(sem_in_features)
        self.common_stride = common_stride
        self.loss_weight = loss_weight
        self.ignore_value = ignore_value
        self.sem_seg_head = SemSegFPNHead(
            [backbone.feature_channels[f] for f in self.sem_in_features],
            self.sem_in_features, sem_strides, num_classes, common_stride,
            conv_dim, dtype=dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.init_backbone(generator)
        self.sem_seg_head.init_weights(generator)

    def sem_logits(self, feats: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B, H/cs, W/cs, C) float32 logits of the features."""
        return self.sem_seg_head([nchw(feats[f])
                                  for f in self.sem_in_features])

    @torch.inference_mode()
    def semantic_logits(self, batch: WSODBatch) -> torch.Tensor:
        return self.sem_logits(self.features(batch.image))

    def forward(self, batch: WSODBatch, *, train: bool = True,
                generator: Optional[torch.Generator] = None, **_
                ) -> Dict[str, torch.Tensor]:
        """``loss_sem_seg`` (times ``loss_weight``) where the batch has
        ``sem_seg``, whose target is the label map strided by
        ``common_stride`` (not resized) and cut to the logits' size."""
        logits = self.sem_logits(self.features(batch.image))
        if batch.sem_seg is None:
            return {}
        return {"loss_sem_seg": self.loss_weight * sem_seg_loss(
            logits, stride_targets(batch.sem_seg, logits, self.common_stride),
            ignore_value=self.ignore_value)}


def stride_targets(sem_seg: torch.Tensor, logits: torch.Tensor,
                   common_stride: int) -> torch.Tensor:
    """``sem_seg[:, ::cs, ::cs][:, :h, :w]`` for (B, h, w, C) logits."""
    h, w = logits.shape[1:3]
    cs = common_stride
    return sem_seg[:, ::cs, ::cs][:, :h, :w]
