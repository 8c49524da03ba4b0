"""Proposal Cluster Learning (counterpart of ``drn_wsod_tpu/ops/pcl.py``).

Every function takes a leading batch axis (the JAX functions are per image
and vmapped) and runs as plain torch ops on the tensors' device, with no
read back to the host; every loop has a static count.

  * candidates: the exact 1-D 3-means of each class's scores over the
    proposals left in the pool (an exhaustive (P+1)^2 search over the two
    interval boundaries of the sorted scores, with prefix sums); the members
    of the top interval, at most ``top_k`` of the highest;
  * graph centers: greedy max-degree picks on the IoU > ``graph_iou`` graph
    of the candidates, for ``top_k`` rounds, stopping once 5 or fewer remain;
    a center's score is the highest score among its neighbours; the
    ``max_centers`` best picks by score are kept;
  * classes run in sequence: centers of a present class leave the pool of
    the classes after it;
  * the loss: proposals with IoU >= ``fg_iou`` to their best center join
    its cluster (-count * score * log(mean cluster probability)); the rest
    are background weighted by their best center's score (zero below
    ``bg_thresh``), over the number of valid proposals.

Ties resolve as in the JAX package: sorts are stable (``lax.top_k`` and
``jnp.argsort`` order equal values by index), and ``argmin`` / ``argmax``
take the first. The prefix sums are summed in the order XLA's CPU backend
sums ``jnp.cumsum`` (:func:`xla_cumsum`), so the 3-means boundaries, which
an ulp can move, agree with the JAX package's on the CPU bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..parallel import context
from ..structures import boxes as box_ops
from ..utils import tracing

# block length of XLA's rewrite of a long cumulative reduce_window
_SCAN_BLOCK = 16


class PCLClusters(NamedTuple):
    centers: torch.Tensor        # (B, C, M, 4) center boxes per class slot
    center_scores: torch.Tensor  # (B, C, M)
    center_valid: torch.Tensor   # (B, C, M) bool


def _sequential_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Prefix sums along the last axis, one float add after another."""
    out = [x[..., 0]]
    for k in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., k])
    return torch.stack(out, -1)


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Prefix sums along the last axis in XLA's order for ``jnp.cumsum`` on
    the CPU: sequential up to 16 elements; longer axes are cut into blocks
    of 16, summed sequentially within each block, and each block adds the
    (recursively scanned) sum of the blocks before it. ``torch.cumsum``
    accumulates in float64 on the CPU and in a parallel order on CUDA, so
    neither rounds as the JAX package does."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        return _sequential_cumsum(x)
    pad = -n % _SCAN_BLOCK
    blocks = F.pad(x, (0, pad)).reshape(*x.shape[:-1], -1, _SCAN_BLOCK)
    within = _sequential_cumsum(blocks)
    before = xla_cumsum(within[..., -1])
    before = torch.cat([torch.zeros_like(before[..., :1]), before[..., :-1]],
                       -1)
    return (within + before[..., None]).reshape(*x.shape[:-1], -1)[..., :n]


def kmeans3_sse(scores: torch.Tensor, valid: torch.Tensor):
    """The 3-means objective of each row's valid scores over every pair of
    boundaries: the scores sorted in descending order (invalid last), the
    top interval [0, i), the middle [i, j), the low [j, n). scores: (B, P)
    float32; valid: (B, P) bool. Returns (total (B, P+1, P+1) with inf at
    infeasible pairs, the sort order (B, P), n (B,))."""
    B, P = scores.shape
    n = valid.sum(-1)                                        # (B,)
    # descending, the invalid last
    order = torch.argsort(torch.where(valid, -scores, math.inf), dim=-1,
                          stable=True)
    xv = torch.where(valid.gather(-1, order), scores.gather(-1, order), 0.0)
    z = xv.new_zeros(B, 1)
    p1 = torch.cat([z, xla_cumsum(xv)], -1)                  # (B, P+1)
    p2 = torch.cat([z, xla_cumsum(xv * xv)], -1)
    idx = torch.arange(P + 1, device=scores.device)

    def sse(s1, s2, m):  # within-SSE of an interval of m >= 1 sorted values
        return s2 - s1 * s1 / m.to(s1.dtype)

    m_top = idx.clamp(min=1)                                  # [0, i)
    top = sse(p1, p2, m_top)                                  # (B, P+1) over i
    m_mid = (idx[None, :] - idx[:, None]).clamp(min=1)        # [i, j)
    mid = sse(p1[:, None, :] - p1[:, :, None], p2[:, None, :] - p2[:, :, None],
              m_mid)                                          # (B, i, j)
    pn1 = p1.gather(-1, n[:, None])
    pn2 = p2.gather(-1, n[:, None])
    m_low = (n[:, None] - idx[None, :]).clamp(min=1)          # [j, n)
    low = sse(pn1 - p1, pn2 - p2, m_low)                      # (B, P+1) over j
    total = top[:, :, None] + mid + low[:, None, :]
    i, j = idx[:, None], idx[None, :]
    feasible = (i >= 1) & (j >= i + 1) & (j[None] <= (n - 1)[:, None, None])
    return torch.where(feasible, total, math.inf), order, n


def _kmeans3_top_members(scores: torch.Tensor, valid: torch.Tensor
                         ) -> torch.Tensor:
    """Members of the top interval of the exact 1-D 3-means of each row's
    valid scores (the first optimum of :func:`kmeans3_sse`). scores: (B, P)
    float32; valid: (B, P) bool -> (B, P) bool. With fewer than 3 valid
    scores the top interval is the highest score (the reference runs
    k = min(3, n) means)."""
    B, P = scores.shape
    total, order, n = kmeans3_sse(scores, valid)
    idx = torch.arange(P + 1, device=scores.device)
    best_i = total.reshape(B, -1).argmin(-1) // (P + 1)
    top_count = torch.where(n >= 3, best_i, n.clamp(max=1))
    ranked = idx[None, :P] < top_count[:, None]
    members = torch.zeros_like(valid).scatter(-1, order, ranked)
    return members & valid


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: equal values in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _class_graph_centers(scores_c: torch.Tensor, proposals: torch.Tensor,
                         pool_mask: torch.Tensor, top_k: int,
                         max_centers: int, graph_iou: float):
    """Greedy IoU-graph centers of one class in each image.

    scores_c: (B, P); proposals: (B, P, 4); pool_mask: (B, P), the valid
    slots minus the centers earlier classes took. Returns (centers (B, M,
    4), scores (B, M), valid (B, M), picked (B, P) bool)."""
    B, P = scores_c.shape
    K = min(top_k, P)
    members = _kmeans3_top_members(scores_c, pool_mask)
    ms = torch.where(members, scores_c, -math.inf)
    top_vals, top_idx = _top_k(ms, K)                         # score desc
    cand_ok = torch.isfinite(top_vals)
    # the reference takes the candidates in ascending proposal index
    ar = torch.arange(K, device=scores_c.device)
    slot = torch.where(cand_ok, top_idx, P + ar)
    order = torch.argsort(slot, dim=-1, stable=True)
    cand_idx = top_idx.gather(-1, order)                      # (B, K)
    cand_ok = cand_ok.gather(-1, order)
    cand_scores = scores_c.gather(-1, cand_idx)
    cand_boxes = proposals.gather(1, cand_idx[..., None].expand(-1, -1, 4))
    # IoU is elementwise per pair, so the candidates' block equals the
    # block of the full (P, P) matrix the JAX function indexes
    adj = ((box_ops.pairwise_iou(cand_boxes, cand_boxes) > graph_iou)
           & cand_ok[:, :, None] & cand_ok[:, None, :])       # (B, K, K)

    alive, cont = cand_ok, torch.ones_like(cand_ok[:, 0])
    centers, oks, picks = [], [], []
    for _ in range(K):
        degree = torch.where(alive, (adj & alive[:, None, :]).sum(-1), -1)
        # max degree, then the largest index (the reference's argsort[::-1])
        best, center = (degree * (K + 1) + ar).max(-1)
        ok = cont & (best >= K + 1)          # degree >= 1 (alive self-loop)
        member = adj.gather(1, center[:, None, None].expand(-1, 1, K))[:, 0] \
            & alive
        picks.append(torch.where(member, cand_scores, -math.inf).amax(-1))
        alive = alive & ~(member & ok[:, None])
        cont = ok & (alive.sum(-1) > 5)
        centers.append(center)
        oks.append(ok)
    pick_scores = torch.where(torch.stack(oks, -1), torch.stack(picks, -1),
                              -math.inf)
    sel_vals, sel = _top_k(pick_scores, max_centers)          # by score
    valid_m = torch.isfinite(sel_vals)
    centers_p = cand_idx.gather(-1, torch.stack(centers, -1).gather(-1, sel))
    picked = torch.zeros_like(scores_c, dtype=torch.int32).scatter_reduce(
        -1, centers_p, valid_m.to(torch.int32), "amax") > 0
    boxes = proposals.gather(1, centers_p[..., None].expand(-1, -1, 4))
    return boxes, torch.where(valid_m, sel_vals, 0.0), valid_m, picked


def mine_pcl_clusters(prev_scores: torch.Tensor, proposals: torch.Tensor,
                      prop_mask: torch.Tensor, labels: torch.Tensor,
                      top_k: int = 32, max_centers: int = 5,
                      graph_iou: float = 0.4) -> PCLClusters:
    """Cluster centers of every class slot in each image, the absent
    classes' invalid. prev_scores: (B, P, C); proposals: (B, P, 4);
    prop_mask: (B, P); labels: (B, C) multi-hot."""
    prev = prev_scores.clamp(1e-9, 1.0 - 1e-9)
    consumed = torch.zeros_like(prop_mask)
    out = []
    for c in range(prev.shape[-1]):
        present = (labels[:, c] > 0.5)[:, None]
        boxes, scores, valid, picked = _class_graph_centers(
            prev[..., c], proposals, prop_mask & ~consumed, top_k,
            max_centers, graph_iou)
        valid = valid & present
        consumed = consumed | (picked & present)
        out.append((boxes, torch.where(valid, scores, 0.0), valid))
    centers, scores, valid = (torch.stack(t, 1) for t in zip(*out))
    return PCLClusters(centers=centers, center_scores=scores,
                       center_valid=valid)


def pcl_loss(cls_logits: torch.Tensor, clusters: PCLClusters,
             proposals: torch.Tensor, prop_mask: torch.Tensor,
             fg_iou: float = 0.5, bg_thresh: float = 0.1) -> torch.Tensor:
    """Each image's PCL branch loss. cls_logits: (B, P, C+1), background in
    column 0. Returns (B,)."""
    B, P, _ = cls_logits.shape
    C, M = clusters.center_valid.shape[1:]
    probs = torch.softmax(cls_logits, dim=-1)
    flat_centers = clusters.centers.reshape(B, C * M, 4)
    flat_valid = clusters.center_valid.reshape(B, C * M)
    flat_scores = clusters.center_scores.reshape(B, C * M)
    iou = box_ops.pairwise_iou(flat_centers, proposals)        # (B, CM, P)
    iou = torch.where(flat_valid[..., None], iou, -1.0)
    best = iou.argmax(1)                                       # first max
    best_iou = iou.amax(1)
    fg = (best_iou >= fg_iou) & prop_mask

    # background: -w log p_bg, w the matched center's score, zero in the
    # ignore band below bg_thresh; plain CE where no center exists at all
    w = torch.where(best_iou >= bg_thresh, flat_scores.gather(-1, best), 0.0)
    w = torch.where(flat_valid.any(-1, keepdim=True), w, 1.0)
    bg_ll = -torch.log(probs[..., 0].clamp(min=1e-9))
    bg_loss = torch.where(prop_mask & ~fg, w * bg_ll, 0.0).sum(-1)

    # clusters: -count_k * score_k * log(mean prob of members for class k)
    slot = torch.arange(C * M, device=cls_logits.device)
    member = (slot[None, :, None] == best[:, None, :]) & fg[:, None, :]
    cls_of_center = slot // M
    member_probs = probs[..., 1:].index_select(-1, cls_of_center) \
        .transpose(1, 2)                                       # (B, CM, P)
    count = member.sum(-1)
    mean_prob = torch.where(member, member_probs, 0.0).sum(-1) \
        / count.clamp(min=1)
    has_members = (count > 0) & flat_valid
    fg_loss = torch.where(
        has_members,
        -count * flat_scores * torch.log(mean_prob.clamp(min=1e-9)),
        0.0).sum(-1)
    denom = prop_mask.float().sum(-1).clamp(min=1.0)
    return (bg_loss + fg_loss) / denom


def pcl_branch_loss(cls_logits: torch.Tensor, prev_scores: torch.Tensor,
                    proposals: torch.Tensor, prop_mask: torch.Tensor,
                    labels: torch.Tensor, graph_iou: float = 0.4,
                    max_centers: int = 5) -> torch.Tensor:
    """The batch's PCL loss: clusters mined from the previous branch's
    scores, then the cluster-supervised loss, averaged over images (of the
    global batch under a mesh shard)."""
    with tracing.span("model.refine.mine"):
        clusters = mine_pcl_clusters(prev_scores, proposals, prop_mask,
                                     labels, max_centers=max_centers,
                                     graph_iou=graph_iou)
    with tracing.span("model.refine.loss"):
        return context.mean(pcl_loss(cls_logits, clusters, proposals,
                                     prop_mask))
