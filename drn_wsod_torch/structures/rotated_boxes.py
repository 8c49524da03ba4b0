"""Rotated boxes, (cx, cy, w, h, angle_deg) with the angle counter-clockwise
(counterpart of ``drn_wsod_tpu/structures/rotated_boxes.py``).

The intersection of two boxes is the JAX package's fixed-shape convex
formula, batched over pairs:

    candidates = corners of A inside B + corners of B inside A
                 + the 16 edge-edge intersections       (24 slots, masked)
    area       = shoelace over the candidates sorted by angle about their
                 mean

The angle sort is stable, as ``jnp.argsort`` is, so that equal angles
(identical boxes, shared corners, collinear edges) fall in the same order.
Torch's ``cos`` and ``sin`` are not XLA's (they differ by an ulp on about
one angle in twenty), so corners, IoUs and everything after them agree
with the JAX functions within a tolerance, not bit for bit.

``pairwise_iou_rotated`` works in chunks of pairs, so that the (pairs, 24)
intermediates stay bounded whatever N x M is, and computes only the pairs
whose corner extents come within one unit of each other: the others have
no candidate point (each test's tolerance is below 1e-6 of a unit), so
the full formula gives them exactly 0, as they get here.
"""

from __future__ import annotations

import math

import torch

# pairs computed at once by pairwise_iou_rotated: about 2 KiB of
# intermediates a pair
DEFAULT_CHUNK = 1 << 20

_DEFAULT_SCALE_CLAMP = math.log(1000.0 / 16)


def rotated_to_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) -> (..., 4, 2) corners, counter-clockwise from
    (-w/2, -h/2) in the box's frame."""
    cx, cy, w, h, a = boxes.unbind(-1)
    t = torch.deg2rad(a)
    cos, sin = torch.cos(t), torch.sin(t)
    dx = torch.stack([-w, w, w, -w], -1) / 2.0
    dy = torch.stack([-h, -h, h, h], -1) / 2.0
    x = cx[..., None] + dx * cos[..., None] - dy * sin[..., None]
    y = cy[..., None] + dx * sin[..., None] + dy * cos[..., None]
    return torch.stack([x, y], -1)


def _inside(points: torch.Tensor, poly: torch.Tensor) -> torch.Tensor:
    """(..., K, 2) points inside the convex (..., 4, 2) poly? Half-plane
    tests signed by the poly's centroid, with a tolerance of 1e-9. No
    point is inside a poly with a zero-length edge (a box whose side
    rounds away, as a decoded proposal's can): its edge's sign is 0. The
    JAX function op by op counts every point inside such a poly, so its
    IoU with any box it crosses comes out in the millions; jitted, as the
    JAX package runs it, XLA's contracted multiply-adds give 0, as here
    and as the float64 clip of ``evaluation/rotated_coco_eval.py``."""
    cen = poly.mean(dim=-2)
    q0 = poly
    q1 = torch.roll(poly, -1, dims=-2)
    a = q1[..., 1] - q0[..., 1]
    b = q0[..., 0] - q1[..., 0]
    c = -(a * q0[..., 0] + b * q0[..., 1])
    sign = torch.sign(a * cen[..., None, 0] + b * cen[..., None, 1] + c)
    f = (points[..., :, None, 0] * a[..., None, :]
         + points[..., :, None, 1] * b[..., None, :]
         + c[..., None, :]) * sign[..., None, :]
    return ((f >= -1e-9) & (sign[..., None, :] != 0)).all(dim=-1)


def _segment_intersections(pa: torch.Tensor, pb: torch.Tensor):
    """The 16 edge-pair intersections of the quads pa and pb (..., 4, 2):
    (..., 16, 2) points, edge of pa major, and their (..., 16) validity."""
    a0 = pa.repeat_interleave(4, dim=-2)
    a1 = torch.roll(pa, -1, dims=-2).repeat_interleave(4, dim=-2)
    b0 = pb.repeat(*([1] * (pb.dim() - 2)), 4, 1)
    b1 = torch.roll(pb, -1, dims=-2).repeat(*([1] * (pb.dim() - 2)), 4, 1)
    d1 = a1 - a0
    d2 = b1 - b0
    denom = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    ok = denom.abs() > 1e-12
    denom = torch.where(ok, denom, torch.ones_like(denom))
    diff = b0 - a0
    t = (diff[..., 0] * d2[..., 1] - diff[..., 1] * d2[..., 0]) / denom
    u = (diff[..., 0] * d1[..., 1] - diff[..., 1] * d1[..., 0]) / denom
    valid = ok & (t >= -1e-9) & (t <= 1 + 1e-9) & (u >= -1e-9) & \
        (u <= 1 + 1e-9)
    return a0 + t[..., None] * d1, valid


def convex_intersection_area(pa: torch.Tensor,
                             pb: torch.Tensor) -> torch.Tensor:
    """Intersection areas of convex quads (..., 4, 2) and (..., 4, 2)."""
    va = _inside(pa, pb)
    vb = _inside(pb, pa)
    pi, vi = _segment_intersections(pa, pb)
    pts = torch.cat([pa, pb, pi], dim=-2)                  # (..., 24, 2)
    valid = torch.cat([va, vb, vi], dim=-1)

    n = valid.sum(-1)
    cen = torch.where(valid[..., None], pts, 0.0).sum(-2) / \
        n.clamp(min=1)[..., None]
    ang = torch.atan2(pts[..., 1] - cen[..., None, 1],
                      pts[..., 0] - cen[..., None, 0])
    ang = torch.where(valid, ang, math.inf)                # invalid last
    order = torch.sort(ang, dim=-1, stable=True).indices
    sp = pts.gather(-2, order[..., None].expand_as(pts)) - cen[..., None, :]

    K = pts.shape[-2]
    idx = torch.arange(K, device=pts.device)
    nxt = torch.where(idx + 1 < n[..., None], idx + 1, 0)
    q = sp.gather(-2, nxt[..., None].expand_as(sp))
    cross = sp[..., 0] * q[..., 1] - sp[..., 1] * q[..., 0]
    area = torch.where(idx < n[..., None], cross, 0.0).sum(-1).abs() / 2.0
    return torch.where(n >= 3, area, 0.0)


def pairwise_iou_rotated(boxes1: torch.Tensor, boxes2: torch.Tensor,
                         chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """(N, 5) x (M, 5) -> (N, M) IoU, ``chunk`` pairs at a time (a chunk
    size changes no number)."""
    N, M = boxes1.shape[0], boxes2.shape[0]
    c1 = rotated_to_corners(boxes1)
    c2 = rotated_to_corners(boxes2)
    a1 = boxes1[:, 2] * boxes1[:, 3]
    a2 = boxes2[:, 2] * boxes2[:, 3]
    inter = boxes1.new_zeros((N, M))
    if N and M:
        lo1, hi1 = c1.amin(-2), c1.amax(-2)                   # (N, 2)
        lo2, hi2 = c2.amin(-2), c2.amax(-2)
        near = ((lo1[:, None] <= hi2[None] + 1.0)
                & (lo2[None] <= hi1[:, None] + 1.0)).all(-1)  # (N, M)
        pairs = near.reshape(-1).nonzero()[:, 0]
        flat = inter.view(-1)
        for s in range(0, pairs.numel(), chunk):
            p = pairs[s:s + chunk]
            flat[p] = convex_intersection_area(c1[p // M], c2[p % M])
    union = a1[:, None] + a2[None, :] - inter
    iou = inter / union.clamp(min=1e-12)
    return torch.where(union > 0, iou, torch.zeros_like(iou))


def nms_rotated(boxes: torch.Tensor, scores: torch.Tensor,
                valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep-mask of (N, 5) boxes: ``ops/nms.py:nms_mask`` on
    the rotated IoU matrix."""
    from ..ops.nms import nms_mask

    iou = pairwise_iou_rotated(boxes, boxes)
    return nms_mask(boxes[:, :4], scores, valid, iou_threshold, iou=iou)


def get_deltas_rotated(src: torch.Tensor, target: torch.Tensor,
                       weights=(1.0, 1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """(N, 5) boxes -> (dx, dy, dw, dh, da) deltas of ``target`` against
    ``src``: box angles in degrees, the angle delta in radians, wrapped to
    [-180, 180) degrees first."""
    wx, wy, ww, wh, wa = weights
    dx = wx * (target[:, 0] - src[:, 0]) / src[:, 2]
    dy = wy * (target[:, 1] - src[:, 1]) / src[:, 3]
    dw = ww * torch.log(target[:, 2] / src[:, 2])
    dh = wh * torch.log(target[:, 3] / src[:, 3])
    da = (target[:, 4] - src[:, 4] + 180.0) % 360.0 - 180.0
    da = da * (wa * math.pi / 180.0)
    return torch.stack([dx, dy, dw, dh, da], dim=-1)


def apply_deltas_rotated(deltas: torch.Tensor, boxes: torch.Tensor,
                         weights=(1.0, 1.0, 1.0, 1.0, 1.0),
                         scale_clamp: float = _DEFAULT_SCALE_CLAMP
                         ) -> torch.Tensor:
    """Decode (..., K*5) deltas against (..., 5) boxes; angles wrapped to
    [-180, 180). Returns the shape of ``deltas``."""
    wx, wy, ww, wh, wa = weights
    dx = deltas[..., 0::5] / wx
    dy = deltas[..., 1::5] / wy
    dw = (deltas[..., 2::5] / ww).clamp(max=scale_clamp)
    dh = (deltas[..., 3::5] / wh).clamp(max=scale_clamp)
    da = deltas[..., 4::5] / wa
    cx = dx * boxes[..., 2:3] + boxes[..., 0:1]
    cy = dy * boxes[..., 3:4] + boxes[..., 1:2]
    w = torch.exp(dw) * boxes[..., 2:3]
    h = torch.exp(dh) * boxes[..., 3:4]
    ang = da * (180.0 / math.pi) + boxes[..., 4:5]
    ang = (ang + 180.0) % 360.0 - 180.0
    return torch.stack([cx, cy, w, h, ang], dim=-1).reshape(deltas.shape)
