"""The plain reference of the WSOD detector the cells run: WS-ResNet (frozen,
FrozenBN), exact RoIPool scaled by ``(objectness + 1) * mask``, the DAN with
its dropout, WSDDN and the OICR or PCL refinement branches, their losses,
the SGD update, and TTA-AVG inference (the views built on the device, the
scores and boxes summed over them, one NMS).

Plain PyTorch, functional over a dict of weights by Detectron2 name, in full
float32 (TF32 off). It follows DRN-WSOD's equations as the program states
them at commit 84b8633 (``models/meta_arch.py``, ``models/heads/*.py``,
``solver/build.py``, ``tta.py``), and imports nothing of the program.

``precision="fp8"`` is the control: every convolution and linear product
takes its two operands rounded to float8 e4m3 with a per-tensor scale
(amax / 448), the step below the configuration's bfloat16; the backward
pass sees the rounding as the identity.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import ops
from .arch import Arch
from .pcl import pcl_branch_loss

CLAMP_LO, CLAMP_HI = 1e-6, 1.0 - 1e-6
# WSDDN's weights: their gradient takes no mined target
WSDDN_LEAVES = ("box_predictor.cls.weight", "box_predictor.det.weight")
E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 at a per-tensor scale, in float32; identity
    for the gradient."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    s = amax / E4M3_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (q - x).detach()


class Reference:
    """The detector of one architecture over weights ``W``; the same
    object computes the control with ``precision="fp8"``."""

    def __init__(self, arch: Arch, W: Dict[str, torch.Tensor],
                 precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.arch, self.W, self.precision = arch, W, precision

    # ------------------------------------------------------------ products
    def _q(self, x):
        return _fp8(x) if self.precision == "fp8" else x

    def conv(self, x, c) -> torch.Tensor:
        y = F.conv2d(self._q(x), self._q(self.W[c.name + ".weight"]), None,
                     c.stride, c.dilation * (c.k // 2), c.dilation)
        n = c.name + ".norm."
        scale = self.W[n + "weight"] / torch.sqrt(self.W[n + "running_var"]
                                                  + 1e-5)
        shift = self.W[n + "bias"] - self.W[n + "running_mean"] * scale
        return y * scale[:, None, None] + shift[:, None, None]

    def linear(self, x, name) -> torch.Tensor:
        return F.linear(self._q(x), self._q(self.W[name + ".weight"]),
                        self.W[name + ".bias"])

    # ------------------------------------------------------------ backbone
    def features(self, image: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) raw pixels -> (B, Hf, Wf, C) float32 map."""
        a = self.arch
        mean = torch.tensor(a.pixel_mean, device=image.device)
        std = torch.tensor(a.pixel_std, device=image.device)
        x = ((image.float() - mean) / std).permute(0, 3, 1, 2)
        with torch.no_grad():
            for c in a.stem:
                x = F.relu(self.conv(x, c))
            x = F.max_pool2d(x, 2, 2)
            for b in a.blocks:
                out = F.relu(self.conv(x, b.convs[0]))
                out = F.relu(self.conv(out, b.convs[1]))
                out = self.conv(out, b.convs[2])
                sc = x if b.shortcut is None else self.conv(x, b.shortcut)
                x = F.relu(out + sc)
                if b.pool_stride:
                    x = F.max_pool2d(x, 2, b.pool_stride)
        return x.permute(0, 2, 3, 1).contiguous()

    def pool(self, feats, proposals, mask, objectness) -> torch.Tensor:
        """(B, P, R, R, C): exact RoIPool times (objectness + 1) * mask."""
        a = self.arch
        obj = objectness + 1.0 if a.use_objectness else \
            torch.ones_like(objectness)
        roi_scale = obj * mask.to(obj.dtype)
        pooled = torch.stack([ops.roi_pool(f, b, 1.0 / a.feature_stride,
                                           a.resolution)
                              for f, b in zip(feats, proposals)])
        return pooled * roi_scale[:, :, None, None, None]

    def dan(self, pooled, generator: Optional[torch.Generator]):
        """The DAN's fcs, each with ReLU and, where a generator is given,
        dropout whose masks are drawn as the program draws them: a bool
        Bernoulli(1 - rate) of the activation's shape per fc, in order."""
        B, P = pooled.shape[:2]
        x = pooled.reshape(B * P, -1)
        rate = self.arch.dropout
        for i in range(len(self.arch.dan)):
            x = F.relu(self.linear(x, f"box_head.fc{i + 1}"))
            if generator is not None and rate > 0:
                keep = torch.empty(x.shape, dtype=torch.bool,
                                   device=x.device).bernoulli_(
                    1.0 - rate, generator=generator)
                x = torch.where(keep, x / (1.0 - rate), 0.0)
        return x.reshape(B, P, -1)

    def box_features(self, batch, generator=None) -> torch.Tensor:
        m = batch["proposal_mask"]
        props = torch.where(m[..., None], batch["proposals"], 0.0)
        obj = torch.where(m, batch["objectness"], 0.0)
        feats = self.features(batch["image"])
        return self.dan(self.pool(feats, props, m, obj), generator), props

    # --------------------------------------------------------------- heads
    def wsddn_scores(self, x, mask) -> torch.Tensor:
        cls_sm = torch.softmax(self.linear(x, "box_predictor.cls"), -1)
        m = mask[..., None]
        det = torch.where(m, self.linear(x, "box_predictor.det"), -math.inf)
        return cls_sm * torch.where(m, torch.softmax(det, -2), 0.0)

    def refinement_logits(self, x, k) -> torch.Tensor:
        return self.linear(x, f"box_refinery.{k}.cls_score")

    # -------------------------------------------------------------- losses
    def losses(self, batch, generator) -> Dict[str, torch.Tensor]:
        """The training losses of one batch (dict of device tensors)."""
        a = self.arch
        m, labels = batch["proposal_mask"], batch["labels"]
        x, props = self.box_features(batch, generator)
        scores = self.wsddn_scores(x, m)
        p = scores.sum(-2).clamp(CLAMP_LO, CLAMP_HI)
        bce = -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))
        losses = {"loss_cls": (bce.mean() if a.mean_loss else bce.sum())
                  / scores.shape[0]}
        evidence = p.detach()
        prev = scores.detach()
        C = a.num_classes
        for k in range(a.refine_k):
            logits = self.refinement_logits(x, k)
            if a.head == "PCL":
                losses[f"loss_cls_r{k}"] = pcl_branch_loss(
                    logits, prev, props, m, labels)
                prev = torch.softmax(logits, -1)[..., 1:].detach()
                continue
            losses[f"loss_cls_r{k}"] = _oicr_loss(logits, prev, props, m,
                                                  labels, evidence)
            prev = torch.softmax(logits, -1)[..., :C].detach()
        return losses

    # ----------------------------------------------------------- inference
    def inference_scores(self, batch) -> torch.Tensor:
        """(V, P, C+1) scores, background last, padded rows zero."""
        with torch.no_grad():
            m = batch["proposal_mask"]
            x, _ = self.box_features(batch)
            probs = [torch.softmax(self.refinement_logits(x, k), -1)
                     for k in range(self.arch.refine_k)]
            scores = sum(probs) / len(probs)
            if self.arch.head == "PCL":
                scores = torch.cat([scores[..., 1:], scores[..., :1]], -1)
            return torch.where(m[..., None], scores, 0.0)


def _oicr_loss(logits, prev, props, mask, labels, evidence):
    """One OICR branch: the top valid proposal of each present class seeds a
    pseudo box weighted by the class's image evidence; proposals at IoU >=
    0.5 to their best seed take its class, the rest background; the
    weighted cross-entropy over the proposals of weight above 1e-12."""
    C = labels.shape[-1]
    masked = torch.where(mask[..., None], prev, -torch.inf)
    seed_idx = masked.max(dim=1).indices                          # (B, C)
    seeds = props.gather(1, seed_idx[..., None].expand(-1, -1, 4))
    valid = labels > 0.5
    midx, mlab = ops.match(ops.pairwise_iou(seeds, props), valid, [0.5],
                           [0, 1])
    gt = torch.where(mlab == 1, midx, C)
    gt = torch.where(mlab == -1, -1, gt)
    gt = torch.where(mask, gt, -1)
    w = torch.where(gt >= 0, evidence.gather(1, midx), 0.0)
    logp = torch.log_softmax(logits, -1)
    ce = -logp.gather(-1, gt.clamp(min=0)[..., None])[..., 0]
    ce = torch.where(gt >= 0, ce, 0.0)
    return (ce * w).sum() / (w > 1e-12).float().sum().clamp(min=1.0)


# ------------------------------------------------------------------ solver

def sgd_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             traces: Dict[str, torch.Tensor], lr: float, momentum: float,
             weight_decay: float, bias_lr_factor: float,
             weight_decay_bias: float) -> None:
    """Detectron2's SGD as the configuration states it: coupled decay, then
    the momentum trace ``t = g + m t``, then ``p -= lr t``; biases at
    ``lr * bias_lr_factor`` and their own decay. In place."""
    m = float(torch.tensor(momentum, dtype=torch.float32))
    with torch.no_grad():
        for n, p in params.items():
            bias = n.endswith(".bias")
            wd = weight_decay_bias if bias else weight_decay
            g = grads[n] + p * wd if wd else grads[n]
            t = g + traces[n] * m
            traces[n] = t
            p.add_(t * -(lr * (bias_lr_factor if bias else 1.0)))


def train_steps(arch: Arch, W: Dict[str, torch.Tensor], batches: List[dict],
                generators: Sequence[torch.Generator], solver: dict,
                precision: str = "f32") -> dict:
    """The first ``len(batches)`` training steps from ``W`` (copied): each
    step's losses, the raw gradient and the trace after the first step, and
    the trainable parameters after the last. ``solver`` holds lr, momentum,
    weight_decay, bias_lr_factor, weight_decay_bias."""
    W = {n: t.clone() for n, t in W.items()}
    names = [n for n in W if n.startswith(("box_head.", "box_predictor.",
                                           "box_refinery."))]
    params = {n: W[n].requires_grad_(True) for n in names}
    traces = {n: torch.zeros_like(W[n]) for n in names}
    ref = Reference(arch, W, precision)
    out = {"losses": [], "grad": None, "trace": None}
    with ops.full_float32():
        for i, (batch, gen) in enumerate(zip(batches, generators)):
            losses = ref.losses(batch, gen)
            total = sum(losses[k] for k in sorted(losses))
            grads = torch.autograd.grad(total, list(params.values()),
                                        allow_unused=True)
            grads = {n: torch.zeros_like(p) if g is None else g
                     for (n, p), g in zip(params.items(), grads)}
            out["losses"].append(
                {**{k: float(v.detach()) for k, v in losses.items()},
                 "total_loss": float(total.detach())})
            sgd_step(params, grads, traces, **solver)
            if i == 0:
                out["grad"] = {n: float(g.norm()) for n, g in grads.items()}
                out["trace"] = {n: float(t.norm()) for n, t in traces.items()}
                out["wsddn_trace"] = {n: traces[n].detach().clone()
                                      for n in WSDDN_LEAVES}
            del losses, total, grads
    out["params"] = {n: p.detach() for n, p in params.items()}
    return out


# --------------------------------------------------------------- TTA-AVG
# ``drn_wsod_torch/tta.py``: the device view build, the inverse, the sums

def _flip_x(width, x, scale):
    return (width.double() - x.double() * scale.double()).to(torch.float32)


def _f32(v, dev):
    return torch.full((), float(v), dtype=torch.float32, device=dev)


def view_boxes(hw0, new_hw, flips, boxes, mask):
    """Each view's proposals (V, P, 4), padded rows zero, and its scale
    factors, as the program's view build computes them."""
    dev = boxes.device
    H0, W0 = _f32(hw0[0], dev), _f32(hw0[1], dev)
    maskf = mask.to(torch.float32)
    props, scales = [], []
    for (nh, nw), do_flip in zip(new_hw, flips):
        nwf = _f32(nw, dev)
        sy, sx = _f32(nh, dev) / H0, nwf / W0
        b = boxes * torch.stack([sx, sy, sx, sy])
        if do_flip:
            b = torch.stack([_flip_x(nwf, boxes[:, 2], sx), b[:, 1],
                             _flip_x(nwf, boxes[:, 0], sx), b[:, 3]], dim=1)
        props.append(b * maskf[:, None])
        scales.append((sy, sx))
    return torch.stack(props), scales


def view_batch(raw, hw0, new_hw, flips, bucket, boxes, mask, objectness):
    """One bucket group's views, built on the device from the edge-padded
    raw image as the program builds them; (batch dict, inverse info)."""
    dev = raw.device
    props, scales = view_boxes(hw0, new_hw, flips, boxes, mask)
    rawf = raw.to(torch.float32)
    imgs = []
    for (nh, nw), do_flip, (sy, sx) in zip(new_hw, flips, scales):
        im = ops.scale_linear(rawf, (bucket, bucket), sy, sx)
        im[nh:] = 0.0
        im[:, nw:] = 0.0
        if do_flip:
            im = torch.roll(torch.flip(im, [1]), nw - bucket, 1)
        imgs.append(im)
    V = len(flips)
    maskf = mask.to(torch.float32)
    batch = {"image": torch.stack(imgs), "proposals": props,
             "proposal_mask": mask[None].expand(V, -1),
             "objectness": (objectness * maskf)[None].expand(V, -1)}
    inv = {"scale": torch.stack([torch.stack([sx, sy]) for sy, sx in scales]),
           "flip": torch.tensor(flips, dtype=torch.float32, device=dev),
           "width": torch.stack([_f32(nw, dev) for _, nw in new_hw])}
    return batch, inv


def invert_boxes(boxes, inv):
    w = inv["width"][:, None]
    f = inv["flip"][:, None]
    x1, y1, x2, y2 = (boxes[..., i] for i in range(4))
    fx1 = torch.where(f > 0, w - x2, x1)
    fx2 = torch.where(f > 0, w - x1, x2)
    sx = inv["scale"][:, None, 0]
    sy = inv["scale"][:, None, 1]
    return torch.stack([fx1 / sx, y1 / sy, fx2 / sx, y2 / sy], dim=-1)


def tta_inputs(image: np.ndarray, record: dict, num_proposals: int,
               device) -> dict:
    """The raw image edge-padded to a multiple of 256 and the deduplicated,
    padded proposals on ``device``."""
    boxes = np.asarray(record["proposal_boxes"], np.float32)
    logits = np.asarray(record["proposal_objectness_logits"], np.float32)
    keep = ops.unique_boxes_mask(boxes)
    boxes, logits = boxes[keep], logits[keep]
    H0, W0 = image.shape[:2]
    rb = int(np.ceil(max(H0, W0) / 256) * 256)
    raw = np.pad(image, ((0, rb - H0), (0, rb - W0), (0, 0)), mode="edge")
    P = num_proposals
    n = min(len(boxes), P)
    pb = np.zeros((P, 4), np.float32)
    pb[:n] = boxes[:n]
    pm = np.zeros((P,), bool)
    pm[:n] = True
    po = np.zeros((P,), np.float32)
    po[:n] = logits[:n]
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return {"raw": t(raw), "hw0": (H0, W0), "boxes": t(pb), "mask": t(pm),
            "objectness": t(po)}


def tta_sums(ref: Reference, inputs: dict, groups: Dict[int, list],
             views: Optional[Sequence[int]] = None):
    """Summed (P, C+1) scores and (P, 4) original-frame boxes over the
    views of ``groups`` (in their order), and the view count. ``views``
    keeps only those indices of the flattened view list (the planted fault
    of half the views)."""
    sum_s = sum_b = None
    idx, n = 0, 0
    for bucket, gviews in groups.items():
        pick = [v for j, v in enumerate(gviews)
                if views is None or idx + j in views]
        idx += len(gviews)
        if not pick:
            continue
        batch, inv = view_batch(inputs["raw"], inputs["hw0"],
                                [(h, w) for h, w, _ in pick],
                                [f for _, _, f in pick], bucket,
                                inputs["boxes"], inputs["mask"],
                                inputs["objectness"])
        with ops.full_float32():
            scores = ref.inference_scores(batch)
        s = torch.sum(scores, dim=0)
        b = torch.sum(invert_boxes(batch["proposals"], inv), dim=0)
        sum_s = s if sum_s is None else sum_s + s
        sum_b = b if sum_b is None else sum_b + b
        n += len(pick)
    return sum_s, sum_b, n


def tta_finish(sum_s, sum_b, n_views: int, mask, nms_thresh: float,
               score_thresh: float, topk: int) -> dict:
    """The views' mean, then one NMS: numpy detections."""
    n = sum_s.new_full((), float(n_views))
    avg_s, avg_b = sum_s / n, sum_b / n
    C = avg_s.shape[-1] - 1
    with ops.full_float32():
        dets = ops.multiclass_nms(avg_b[None], avg_s[None, :, :C], mask[None],
                                  nms_thresh, score_thresh, topk)
    out = {k: v[0].cpu().numpy() for k, v in dets.items()}
    out["all_scores"] = avg_s.cpu().numpy()
    out["all_boxes"] = avg_b.cpu().numpy()
    return out
