"""WS-backbone ImageNet classification pretraining (counterpart of
``tools/imagenet.py``): the backbone, a 2x2 max pool, the DAN neck and a
``num_classes``-way linear layer, trained with SGD.

    python -m drn_wsod_torch.tools.imagenet [--data ROOT | --synthetic] \\
        [--depth 50] [--batch-size 128] [--lr 0.05] [--iters 500000] \\
        [--num-classes 1000] [--out output/imagenet_ws]

The backbone is the WS-ResNet of ``--depth`` with ``RES5_DILATION`` 1 and
``NORM`` BN, whose BatchNorm trains on batch statistics (flax's train
mode: ``models/backbones/resnet_ws.py:use_batch_stats``, momentum 0.9,
epsilon 1e-5). Every parameter trains; the update is the JAX tool's optax
chain: weight decay 1e-4 added to the gradient, a momentum trace
(decay 0.9), and the learning rate, cut by 10 at a third and at two
thirds of ``--iters``. The loss is the softmax cross-entropy, mean over
the batch, on ``image - [102.9801, 115.9465, 122.7717]`` (BGR).

``--data`` is an image-folder root (a folder of JPEGs per class), read
through the port's JPEG decoder and resized to 224x224 by the port's
Pillow-equal bilinear filter, flipped at random; ``--synthetic`` (or no
``--data``) draws 112x112 images. Every 20 iterations the loss, accuracy
and img/s are printed (a read back, the fence); the end state is saved by
``checkpoint/checkpointer.py`` as the step ``--iters`` under ``--out``.
Runs on the CUDA device unless ``main`` is given another one.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

PIXEL_MEAN = (102.9801, 115.9465, 122.7717)


class ResNetWSClassifier(nn.Module):
    """backbone -> 2x2 max pool -> DAN -> linear(num_classes). The pooled
    map is flattened in (H, W, C) order, as the JAX model's NHWC map is,
    so ``in_features`` is the pooled map's H * W * C."""

    def __init__(self, backbone: nn.Module, in_features: int,
                 dan_dims: Sequence[int] = (2048, 4096),
                 num_classes: int = 1000, dropout: float = 0.5):
        from ..models.heads.box_head import DiscriminativeAdaptionNeck
        from ..models.layers import Dense

        super().__init__()
        self.backbone = backbone
        self.neck = DiscriminativeAdaptionNeck(in_features, dan_dims,
                                               dropout)
        self.fc = Dense(dan_dims[-1], num_classes)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """x: (N, H, W, 3) float32 BGR, mean subtracted. Dropout runs where
        a ``generator`` is given."""
        feats = self.backbone(x.permute(0, 3, 1, 2))
        f = F.max_pool2d(list(feats.values())[-1], 2, 2)
        f = f.permute(0, 2, 3, 1).reshape(f.shape[0], -1)
        return self.fc(self.neck(f, generator))


def pooled_features(backbone: nn.Module, size: int) -> int:
    """H * W * C of the pooled last map of a ``size`` x ``size`` image."""
    dev = next(backbone.parameters()).device
    with torch.no_grad():
        out = backbone(torch.zeros(1, 3, size, size, device=dev))
    _, c, h, w = list(out.values())[-1].shape
    return (h // 2) * (w // 2) * c


def build_classifier(depth: int = 50, num_classes: int = 1000,
                     size: int = 112, dropout: float = 0.5, device=None
                     ) -> ResNetWSClassifier:
    """The tool's model on ``device`` (CUDA unless the caller names
    another): the config's WS-ResNet of ``depth``, ``NORM`` BN in train
    mode, a DAN of (res5 channels, 4096), weights drawn from a generator
    seeded with 0."""
    from ..config import get_cfg
    from ..device import resolve_device
    from ..models.backbones.resnet_ws import (build_ws_resnet_backbone,
                                              use_batch_stats)

    dev = resolve_device(device)
    cfg = get_cfg()
    cfg.MODEL.RESNETS.DEPTH = depth
    if depth in (18, 34):
        cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 64
    cfg.MODEL.RESNETS.RES5_DILATION = 1
    cfg.MODEL.RESNETS.NORM = "BN"
    with torch.device("meta"):
        probe = build_ws_resnet_backbone(cfg)
    in_features = pooled_features(probe, size)
    channels = probe.feature_channels[list(probe.feature_channels)[-1]]
    with torch.device(dev):
        backbone = build_ws_resnet_backbone(cfg)
        model = ResNetWSClassifier(backbone, in_features, (channels, 4096),
                                   num_classes, dropout)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() > 1:
                fan_in = p[0].numel()
                p.normal_(0.0, fan_in ** -0.5, generator=gen)
    for p in model.parameters():
        p.requires_grad_(True)
    use_batch_stats(model, True)
    return model


def synthetic_batches(batch_size: int, size: int = 112,
                      num_classes: int = 1000, seed: int = 0
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """The JAX tool's draws: uniform [0, 255) images, uniform labels."""
    rng = np.random.RandomState(seed)
    while True:
        x = rng.uniform(0, 255, (batch_size, size, size, 3)).astype(
            np.float32)
        y = rng.randint(0, num_classes, batch_size)
        yield x, y


def imagefolder_batches(root: str, batch_size: int, size: int = 224,
                        seed: int = 0
                        ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Shuffled epochs over ``root/<class>/<image>``: decoded by the
    port's JPEG decoder (``data/mapper.py:read_image``), resized to
    ``size`` square by Pillow's bilinear filter in numpy, BGR, flipped
    with probability 1/2."""
    from ..data.mapper import read_image
    from ..data.transforms import resize_bilinear

    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    samples = [(os.path.join(root, c, f), i)
               for i, c in enumerate(classes)
               for f in sorted(os.listdir(os.path.join(root, c)))]
    rng = np.random.RandomState(seed)
    while True:
        idx = rng.permutation(len(samples))
        for s in range(0, len(idx) - batch_size + 1, batch_size):
            xs, ys = [], []
            for j in idx[s:s + batch_size]:
                path, label = samples[j]
                img = resize_bilinear(read_image(path, "RGB"), size, size)
                arr = img.astype(np.float32)[:, :, ::-1]  # BGR
                if rng.rand() < 0.5:
                    arr = arr[:, ::-1]
                xs.append(arr)
                ys.append(label)
            yield np.ascontiguousarray(np.stack(xs)), np.asarray(ys)


def lr_at(base_lr: float, iters: int, it: int) -> float:
    """optax's piecewise-constant schedule: x0.1 at int(0.33 iters) and at
    int(0.67 iters)."""
    lr = np.float32(base_lr)
    for boundary in (int(iters * 0.33), int(iters * 0.67)):
        if it >= boundary:
            lr = lr * np.float32(0.1)
    return float(lr)


def make_step(model: ResNetWSClassifier, base_lr: float, iters: int):
    """``step(trace, x, y, it, generator) -> (loss, acc)``: the forward
    in train mode, the mean cross-entropy, gradients of every parameter,
    then per parameter ``g + 1e-4 p``, ``trace = g + 0.9 trace``,
    ``p += -lr * trace`` (in place; ``trace`` a dict by name)."""
    mean = None

    def step(trace: Dict[str, torch.Tensor], x: torch.Tensor,
             y: torch.Tensor, it: int,
             generator: Optional[torch.Generator] = None):
        nonlocal mean
        if mean is None:
            mean = torch.tensor(PIXEL_MEAN, device=x.device)
        params = dict(model.named_parameters())
        logits = model(x - mean, generator)
        loss = F.cross_entropy(logits.float(), y)
        acc = (logits.argmax(-1) == y).float().mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        scale = torch.tensor(-lr_at(base_lr, iters, it), device=x.device)
        with torch.no_grad():
            for (name, p), g in zip(params.items(), grads):
                g = g + 1e-4 * p
                t = trace.get(name)
                trace[name] = g if t is None else g + 0.9 * t
                p.add_(scale * trace[name])
        return loss.detach(), acc.detach()

    return step


def argument_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="drn_wsod_torch imagenet")
    p.add_argument("--data", default="", help="imagefolder root")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--iters", type=int, default=500000)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--out", default="output/imagenet_ws")
    return p


def main(argv=None, device=None) -> Dict[str, float]:
    """Train; returns the last logged loss and accuracy."""
    from ..checkpoint import Checkpointer
    from ..device import resolve_device
    from ..engine.trainer import TrainState

    args = argument_parser().parse_args(argv)
    dev = resolve_device(device)
    synthetic = args.synthetic or not args.data
    size = 112 if synthetic else 224
    data = (synthetic_batches(args.batch_size, size, args.num_classes)
            if synthetic else imagefolder_batches(args.data, args.batch_size,
                                                  size))
    model = build_classifier(args.depth, args.num_classes, size, device=dev)
    step = make_step(model, args.lr, args.iters)
    trace: Dict[str, torch.Tensor] = {}
    last = {}
    t0 = time.perf_counter()
    for it in range(args.iters):
        x, y = next(data)
        gen = torch.Generator(device=dev).manual_seed(it)
        loss, acc = step(trace, torch.from_numpy(x).to(dev),
                         torch.from_numpy(y).to(dev), it, gen)
        if (it + 1) % 20 == 0 or it + 1 == args.iters:
            last = {"loss": float(loss), "acc": float(acc)}
            print(f"iter {it + 1}: loss {last['loss']:.4f} "
                  f"acc {last['acc']:.4f} "
                  f"({(it + 1) * args.batch_size / (time.perf_counter() - t0):.1f} img/s)")
    os.makedirs(args.out, exist_ok=True)
    Checkpointer(args.out).save(TrainState(step=args.iters, model=model,
                                           opt_state={"trace": trace}),
                                args.iters)
    return last


if __name__ == "__main__":
    main()
