"""ComputeLoss, the classic 3-positive YOLOv5/v7 loss (counterpart of
`yolo_series_tpu/losses/yolo_loss.py`; reference utils/loss.py:422-553).

CIoU box loss on the matched candidates, IoU-aware objectness with a
balance a level, BCE classification with optional label smoothing and
focal modulation, over the static-shape padded candidates of
`losses/targets.find_positive`.

Inputs: raw head maps [(B, na, ny, nx, no)], padded labels (B, M, 5)
[cls, x, y, w, h] normalized, and the label mask (B, M). Returns
(total, {box, obj, cls}), total already multiplied by the batch size
(reference loss.py:498).

Under a process group (`group=`, each rank holding an equal contiguous
slice of the global batch) every loss here normalizes over the GLOBAL
batch: a masked mean divides by the all-reduced count of positives (no
gradient flows through a count), the objectness mean by the global element
count, and `total` takes the global batch size. Each rank's total is then
its share of the global batch's loss, so the SUM of the ranks' gradients
is the global batch's gradient (the train step all-reduces with SUM). The
returned items are the global ones (summed over the ranks, detached).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from yolo_series_tpu_torch.losses.targets import find_positive
from yolo_series_tpu_torch.ops.boxes import bbox_iou
from yolo_series_tpu_torch.parallel.dist import world_size


@dataclasses.dataclass(frozen=True)
class LossHyp:
    """Loss hyperparameters (the loss subset of hyp.scratch, pre-scaled by
    the trainer: box *= 3 / nl etc., reference train.py:288-291). The
    defaults equal hyp.scratch.p5 at nl 3, nc 80, 640 px."""

    box: float = 0.05
    obj: float = 0.7
    cls: float = 0.3
    cls_pw: float = 1.0
    obj_pw: float = 1.0
    anchor_t: float = 4.0
    fl_gamma: float = 0.0
    label_smoothing: float = 0.0
    gr: float = 1.0          # IoU-aware objectness ratio (model.gr)
    aux_w: float = 0.25      # aux head weight (loss.py:1258)


def smooth_bce(eps: float) -> Tuple[float, float]:
    """Positive and negative BCE targets (reference loss.py:11-13)."""
    return 1.0 - 0.5 * eps, 0.5 * eps


def bce_logits(logits, targets, pos_weight=1.0):
    """Elementwise BCE with logits, pos_weight on the positive log term as
    in torch, written with log-sigmoids as the JAX package does so that it
    rounds the same way."""
    ls = F.logsigmoid(logits)
    lns = F.logsigmoid(-logits)
    return -(pos_weight * targets * ls + (1.0 - targets) * lns)


def focal_scale(logits, targets, gamma, alpha=0.25):
    """Focal modulation factors (reference FocalLoss, loss.py:121-146)."""
    p = torch.sigmoid(logits)
    p_t = targets * p + (1 - targets) * (1 - p)
    alpha_t = targets * alpha + (1 - targets) * (1 - alpha)
    return alpha_t * (1.0 - p_t) ** gamma


def positive_count(mask, group=None):
    """The number of True entries of mask (fp32), over the whole global
    batch under a group (all-reduced; no gradient flows through it)."""
    n = mask.to(torch.float32).sum()
    if group is not None:
        dist.all_reduce(n, group=group)
    return n


def _masked_mean(x, mask, count):
    """The mean of x where mask, over `count` positives (`positive_count`:
    the global batch's under a group)."""
    num = torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device)).sum()
    return num / torch.clamp(count, min=1.0)


def global_items(lbox, lobj, lcls, group=None):
    """The loss items {box, obj, cls}; under a group, summed over the ranks
    in one all-reduce (each rank's are its share of the global batch's)."""
    if group is None:
        return {"box": lbox, "obj": lobj, "cls": lcls}
    t = torch.stack([lbox, lobj, lcls]).detach()
    dist.all_reduce(t, group=group)
    return dict(zip(("box", "obj", "cls"), t))


def balance_for(nl: int):
    """Objectness balance a level (reference loss.py:442)."""
    return [4.0, 1.0, 0.4] if nl == 3 else [4.0, 1.0, 0.25, 0.06, 0.02][:nl]


def objectness_target(shape, bi, ai, gj, gi, val, keep):
    """(B, na, ny, nx) zeros, each cell the max of the `val` of the kept
    candidates that land on it (`tobj.at[...].max(..., mode="drop")` of the
    JAX package): a scatter-amax over flat cell indices, the dropped rows
    sent to a spare slot past the end. Order-free, so candidates that land
    on the same cell agree exactly."""
    b, na, ny, nx = shape
    n = b * na * ny * nx
    flat = ((bi * na + ai) * ny + gj) * nx + gi
    flat = torch.where(keep, flat, torch.full_like(flat, n))
    tobj = torch.zeros(n + 1, dtype=val.dtype, device=val.device)
    tobj.scatter_reduce_(0, flat.reshape(-1), val.reshape(-1), reduce="amax")
    return tobj[:n].reshape(shape)


def make_compute_loss(head, hyp: LossHyp):
    """compute_loss(raw, labels, label_mask) for a Detect-family head."""
    nl = len(head.strides)
    na = head.na
    nc = head.nc
    balance = balance_for(nl)
    anchors = np.asarray(head.anchors, np.float32).reshape(nl, na, 2)
    cp, cn = smooth_bce(hyp.label_smoothing)

    def per_level(pi, labels, label_mask, li, group):
        """pi: (B, na, ny, nx, no)."""
        ny, nx = pi.shape[2], pi.shape[3]
        cand = find_positive(labels, label_mask, anchors[li], (ny, nx),
                             hyp.anchor_t, g=0.5)
        b_sz, m, _, k = cand.gi.shape
        dev = pi.device
        bi = torch.arange(b_sz, device=dev)[:, None, None, None].expand(cand.gi.shape)
        ai = torch.arange(na, device=dev)[None, None, :, None].expand(cand.gi.shape)

        gi, gj = cand.gi.reshape(-1), cand.gj.reshape(-1)
        bi, ai = bi.reshape(-1), ai.reshape(-1)
        valid = cand.valid.reshape(-1)
        tbox = cand.tbox.reshape(-1, 4)
        tcls = cand.tcls[:, :, None, None].expand(cand.gi.shape).reshape(-1)
        anc = cand.anchors[None, None, :, None, :].expand(b_sz, m, na, k, 2).reshape(-1, 2)

        ps = pi[bi, ai, gj, gi]                       # (N, no) gather

        pxy = torch.sigmoid(ps[:, 0:2]) * 2.0 - 0.5
        pwh = torch.square(torch.sigmoid(ps[:, 2:4]) * 2.0) * anc
        pbox = torch.cat([pxy, pwh], dim=-1)
        iou = bbox_iou(pbox, tbox, xywh=True, ciou=True)
        count = positive_count(valid, group)
        lbox = _masked_mean(1.0 - iou, valid, count)

        # objectness target map: the max IoU among candidates of a cell
        tobj_val = (1.0 - hyp.gr) + hyp.gr * torch.clamp(iou.detach(), min=0.0)
        tobj = objectness_target(pi.shape[:4], bi, ai, gj, gi, tobj_val.to(pi.dtype),
                                 valid)

        obj_bce = bce_logits(pi[..., 4], tobj, hyp.obj_pw)
        if hyp.fl_gamma > 0:
            obj_bce = obj_bce * focal_scale(pi[..., 4], tobj, hyp.fl_gamma)
        lobj = obj_bce.mean() / world_size(group)

        if nc > 1:
            t = torch.full((ps.shape[0], nc), cn, dtype=ps.dtype, device=dev)
            t.scatter_(1, tcls[:, None], cp)     # a fill, no copy from the host
            cls_bce = bce_logits(ps[:, 5:], t, hyp.cls_pw)
            if hyp.fl_gamma > 0:
                cls_bce = cls_bce * focal_scale(ps[:, 5:], t, hyp.fl_gamma)
            lcls = _masked_mean(cls_bce.mean(-1), valid, count)
        else:
            lcls = torch.zeros((), dtype=torch.float32, device=dev)
        return lbox, lobj, lcls

    def compute_loss(raw: Sequence[torch.Tensor], labels, label_mask, group=None):
        lbox = lobj = lcls = 0.0
        for li in range(nl):
            lb, lo, lc = per_level(raw[li].float(), labels, label_mask, li, group)
            lbox = lbox + lb
            lobj = lobj + lo * balance[li]
            lcls = lcls + lc
        bs = raw[0].shape[0] * world_size(group)
        lbox = lbox * hyp.box
        lobj = lobj * hyp.obj
        lcls = lcls * hyp.cls
        total = (lbox + lobj + lcls) * bs
        return total, global_items(lbox, lobj, lcls, group)

    return compute_loss
