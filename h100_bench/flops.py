"""Model FLOPs the benchmark's inputs need, from shapes alone.

* The backbone's convolutions at each image's own (resized) height and
  width, each rounded up to 32, not at its square bucket: padding shows as
  lost utilization. The backbone is frozen, so it has no backward.
* fc1, fc2, WSDDN's two streams (training only: inference scores by the
  branches) and each refinement branch's classifier over the image's
  valid proposals, not its padded slots. The branches' box outputs are
  left out: with ``WSL.REFINE_REG`` off nothing reads them.
* Training adds the backward products the update needs: every trainable
  layer's weight gradient, and the input gradients down to fc1's output
  (fc1 takes no input gradient: the pool is forward-only).
* The RoIPool's comparisons, the losses and PCL's mining count none.

A multiply-add counts two FLOPs, as ``torch.utils.flop_counter`` counts.
"""

from __future__ import annotations

from .reference.arch import Arch


def _out(size: int, k: int, stride: int, dilation: int) -> int:
    pad = dilation * (k // 2)
    return (size + 2 * pad - dilation * (k - 1) - 1) // stride + 1


def backbone_flops(arch: Arch, h: int, w: int) -> int:
    h, w = -(-h // 32) * 32, -(-w // 32) * 32
    total = 0

    def conv(c, h, w):
        ho = _out(h, c.k, c.stride, c.dilation)
        wo = _out(w, c.k, c.stride, c.dilation)
        return 2 * c.cin * c.cout * c.k * c.k * ho * wo, ho, wo

    for c in arch.stem:
        f, h, w = conv(c, h, w)
        total += f
    h, w = h // 2, w // 2
    for b in arch.blocks:
        for c in b.convs:
            f, _, _ = conv(c, h, w)
            total += f
        if b.shortcut is not None:
            total += conv(b.shortcut, h, w)[0]
        if b.pool_stride:
            h = (h - 2) // b.pool_stride + 1
            w = (w - 2) // b.pool_stride + 1
    return total


def head_flops(arch: Arch, n_valid: int, train: bool) -> int:
    """Training runs WSDDN's streams and the branches; inference scores by
    the branches alone."""
    dims = [arch.resolution ** 2 * arch.out_channels, *arch.dan]
    C = arch.num_classes
    fcs = [2 * dims[i] * dims[i + 1] for i in range(len(arch.dan))]
    heads = arch.refine_k * 2 * dims[-1] * (C + 1)
    if not train:
        return n_valid * (sum(fcs) + heads)
    fwd = sum(fcs) + heads + 2 * (2 * dims[-1] * C)
    # weight gradients of every layer, input gradients of all but fc1
    return n_valid * (fwd + fwd + (fwd - fcs[0]))


def image_flops(arch: Arch, h: int, w: int, n_valid: int, train: bool) -> int:
    return backbone_flops(arch, h, w) + head_flops(arch, n_valid, train)
