"""The part that RetinaNet, SemanticSegmentor and PanopticFPN share: raw
NHWC pixels normalised by ``PIXEL_MEAN`` / ``PIXEL_STD``, cast to the
compute dtype and run through the FPN backbone, whose stages train (the
JAX package runs these three models' backbones without
``stop_gradient``)."""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from .meta_arch import GeneralizedRCNNWSL


class PyramidModel(nn.Module):
    """A backbone over raw pixels whose ``features`` are the NHWC maps of
    its pyramid levels."""

    def __init__(self, backbone: nn.Module, pixel_mean: Sequence[float],
                 pixel_std: Sequence[float], dtype: torch.dtype):
        super().__init__()
        self.backbone = backbone
        self.dtype = dtype
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean),
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std),
                             persistent=False)

    sanitize = staticmethod(GeneralizedRCNNWSL.sanitize)

    def preprocess(self, image: torch.Tensor) -> torch.Tensor:
        return ((image - self.pixel_mean) / self.pixel_std).to(self.dtype)

    def features(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, H, W, 3) raw pixels -> {level: (B, Hl, Wl, C)} contiguous
        NHWC maps (their NCHW views are ``channels_last``)."""
        out = self.backbone(self.preprocess(image).permute(0, 3, 1, 2))
        return {n: f.permute(0, 2, 3, 1).contiguous() for n, f in out.items()}

    @torch.no_grad()
    def init_backbone(self, generator: torch.Generator) -> None:
        """Backbone convs N(0, 1/fan_in), their biases 0."""
        for m in self.backbone.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5,
                                 generator=generator)
                if m.bias is not None:
                    m.bias.zero_()


def nchw(x: torch.Tensor) -> torch.Tensor:
    """The NCHW (``channels_last``) view of an NHWC map."""
    return x.permute(0, 3, 1, 2)
