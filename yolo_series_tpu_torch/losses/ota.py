"""ComputeLossOTA, SimOTA dynamic label assignment, batched (counterpart
of `yolo_series_tpu/losses/ota.py`; reference utils/loss.py:556-845).

The assignment is one static-shape computation over the whole batch (the
JAX package's per-image vmap as batched tensors):

  * candidates: every (gt, level, anchor, offset) slot of the lateral-offset
    scheme (losses/targets.py), C = M * nl * na * 5 columns with a validity
    bit;
  * the (M, C, nc) pairwise class cost never materializes: for one-hot
    targets sum_c BCE(z_c, t_c) = sum_c softplus(z_c) - z_{gt_cls};
  * dynamic k (k = clamp(sum of the top-10 IoUs, 1), loss.py:714-715) by a
    top-k over the cost row and a rank mask;
  * a contested column goes to the global argmin-cost gt (loss.py:747-755).

Ties resolve as the JAX package's: argmax and argmin return the first
index in both libraries, and `_top_k_iter` takes the first index at each
of its k passes.

Under a process group the assignment needs nothing from the other ranks:
every quantity in it (candidates, pairwise IoU and cost, dynamic k, the
top-k and the contested-column argmin over the gts) is one image's, as in
the JAX package's per-image vmap (`yolo_series_tpu/losses/ota.py:178-201`);
the image size comes from the maps' shape. Only the loss's normalizers are
global (`losses/yolo_loss.py`).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from yolo_series_tpu_torch.losses.targets import const_on, find_positive
from yolo_series_tpu_torch.losses.yolo_loss import (LossHyp, _masked_mean, balance_for,
                                                    bce_logits, focal_scale, global_items,
                                                    objectness_target, positive_count,
                                                    smooth_bce)
from yolo_series_tpu_torch.ops.boxes import bbox_iou, box_iou, xywh2xyxy
from yolo_series_tpu_torch.parallel.dist import world_size

K_OFFSETS = 5


def _top_k_iter(x, k):
    """Exact top-k along the last axis by k masked argmax passes: the first
    index wins a tie, as in `lax.top_k` and the JAX package's `_top_k_iter`.
    Returns (values, indices), each (..., k)."""
    x = x.clone()
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(x, dim=-1, keepdim=True)
        vals.append(torch.gather(x, -1, i))
        idxs.append(i)
        x.scatter_(-1, i, float("-inf"))
    return torch.cat(vals, -1), torch.cat(idxs, -1)


def _softplus(x):
    """log(1 + e^x) as `jax.nn.softplus` computes it (logaddexp(x, 0))."""
    return torch.logaddexp(x, torch.zeros_like(x))


@torch.no_grad()
def ota_assign_batch(raw: Sequence[torch.Tensor], labels, label_mask,
                     anchors: np.ndarray, strides: np.ndarray,
                     hyp: LossHyp, g: float, topk: int, codec=None):
    """SimOTA assignment. raw: [(B, na, ny, nx, no)] lead maps (fp32).
    Returns fg (B, C) bool, matched_gt (B, C) int64 over the concatenated
    candidate columns (level-major), and the level column offsets. No
    gradient flows through it. codec: another head's channel layout,
    {"obj_idx": the objectness channel (the classes follow it),
    "wh_decode": (ps (B, Cl, no), anchors (Cl, 2)) -> (B, Cl, 2) w, h in
    grid units} (the IBin head's bins, `losses/bin_ota.py`); None for
    [x, y, w, h, obj, classes]."""
    grids = [(r.shape[2], r.shape[3]) for r in raw]
    # gt pixel scale from the maps' own shapes (the reference's
    # `this_target[:, 2:6] * imgs[batch_idx].shape[1]`, loss.py:661)
    img_size = grids[0][0] * float(strides[0])
    b, m = labels.shape[:2]
    na = anchors.shape[1]
    dev = labels.device

    all_ps, all_valid, all_xyxy = [], [], []
    for li, r in enumerate(raw):
        ny, nx = grids[li]
        c = find_positive(labels, label_mask, anchors[li], (ny, nx), hyp.anchor_t, g=g)
        gi = c.gi.reshape(b, -1)
        gj = c.gj.reshape(b, -1)
        ai = torch.arange(na, device=dev)[:, None].expand(m, na, K_OFFSETS).reshape(-1)
        bi = torch.arange(b, device=dev)[:, None]
        ps = r[bi, ai[None, :], gj, gi]                                  # (B, Cl, no)
        anc = c.anchors[None, :, None, :].expand(m, na, K_OFFSETS, 2).reshape(-1, 2)
        grid = torch.stack([gi, gj], -1).float()
        pxy = (torch.sigmoid(ps[..., 0:2]) * 2.0 - 0.5 + grid) * float(strides[li])
        if codec is None:
            pwh = torch.square(torch.sigmoid(ps[..., 2:4]) * 2.0) * anc * float(strides[li])
        else:
            pwh = codec["wh_decode"](ps, anc) * float(strides[li])
        all_xyxy.append(xywh2xyxy(torch.cat([pxy, pwh], -1)))
        all_ps.append(ps)
        all_valid.append(c.valid.reshape(b, -1))

    p_xyxy = torch.cat(all_xyxy, 1)                                      # (B, C, 4)
    p_all = torch.cat(all_ps, 1)
    v_all = torch.cat(all_valid, 1)
    c_total = p_xyxy.shape[1]

    t_xyxy = xywh2xyxy(labels[..., 1:5] * img_size)                      # (B, M, 4)
    pair_ok = label_mask[:, :, None] & v_all[:, None, :]
    pair_iou = torch.where(pair_ok, box_iou(t_xyxy, p_xyxy), 0.0)        # (B, M, C)
    iou_cost = -torch.log(pair_iou + 1e-8)

    topk_eff = min(topk, c_total)
    top_iou = _top_k_iter(pair_iou, topk_eff)[0]
    dyn_k = torch.clamp(top_iou.sum(-1).to(torch.int32), min=1)         # (B, M)

    obj_idx = 4 if codec is None else codec["obj_idx"]
    obj_l = p_all[..., obj_idx:obj_idx + 1]
    cls_l = p_all[..., obj_idx + 1:]
    y = torch.sqrt(torch.sigmoid(cls_l) * torch.sigmoid(obj_l))
    z = torch.log(y / (1.0 - y + 1e-12) + 1e-12)                         # (B, C, nc)
    sp_sum = _softplus(z).sum(-1)                                        # (B, C)
    gt_cls = labels[..., 0].long()                                       # (B, M)
    z_gt = torch.gather(z.transpose(1, 2), 1,
                        gt_cls[:, :, None].expand(b, m, c_total))        # (B, M, C)
    cls_cost = sp_sum[:, None, :] - z_gt

    big = 1e8
    cost = torch.where(pair_ok, cls_cost + 3.0 * iou_cost, big)

    neg_top, top_idx = _top_k_iter(-cost, topk_eff)
    rank_ok = ((torch.arange(topk_eff, device=dev) < dyn_k[..., None])
               & (-neg_top < big * 0.5))
    matching = torch.zeros((b, m, c_total), dtype=torch.bool, device=dev)
    matching.scatter_(2, top_idx, rank_ok)

    # a contested column goes to the global argmin-cost gt, which may be a
    # gt that never claimed it (loss.py:752-755 zeroes the column, then
    # writes cost_argmin), so the claims are not ANDed in
    claims = matching.sum(1)                                             # (B, C)
    best_gt = torch.argmin(cost, 1)                                      # (B, C)
    exclusive = torch.arange(m, device=dev)[None, :, None] == best_gt[:, None, :]
    matching = torch.where(claims[:, None, :] > 1, exclusive, matching)

    fg = matching.any(1) & v_all
    matched_gt = torch.argmax(matching.to(torch.uint8), 1)
    sizes = [m * na * K_OFFSETS] * len(raw)
    return fg, matched_gt, np.cumsum([0] + sizes)


def ota_level_loss(pi, labels, label_mask, fg_l, mg_l, anchors_l,
                   hyp: LossHyp, g: float, group=None):
    """(lbox, mean objectness BCE, lcls) of one level given assignments.
    pi: (B, na, ny, nx, no), the maps the loss is applied to. Under a
    group, this rank's shares of the global batch's means."""
    bs, na = pi.shape[0], anchors_l.shape[0]
    ny, nx = pi.shape[2], pi.shape[3]
    m = labels.shape[1]
    dev = pi.device

    cand = find_positive(labels, label_mask, anchors_l, (ny, nx), hyp.anchor_t, g=g)
    gi = cand.gi.reshape(bs, -1)
    gj = cand.gj.reshape(bs, -1)
    ai = torch.arange(na, device=dev)[None, None, :, None].expand(
        bs, m, na, K_OFFSETS).reshape(bs, -1)
    bi = torch.arange(bs, device=dev)[:, None].expand(gi.shape)

    ps = pi[bi, ai, gj, gi]                                              # (B, Cl, no)
    lab = labels[bi, mg_l]                                               # (B, Cl, 5)
    gain = const_on([nx, ny, nx, ny], dev)
    tb = lab[..., 1:5] * gain
    grid = torch.stack([gi, gj], -1).float()
    tb = torch.cat([tb[..., 0:2] - grid, tb[..., 2:4]], -1)

    anc = cand.anchors[None, None, :, None, :].expand(
        bs, m, na, K_OFFSETS, 2).reshape(bs, -1, 2)
    pxy = torch.sigmoid(ps[..., 0:2]) * 2.0 - 0.5
    pwh = torch.square(torch.sigmoid(ps[..., 2:4]) * 2.0) * anc
    iou = bbox_iou(torch.cat([pxy, pwh], -1), tb, xywh=True, ciou=True)
    count = positive_count(fg_l, group)
    lbox = _masked_mean(1.0 - iou, fg_l, count)

    tobj_val = (1.0 - hyp.gr) + hyp.gr * torch.clamp(iou.detach(), min=0.0)
    tobj = objectness_target(pi.shape[:4], bi, ai, gj, gi, tobj_val, fg_l)
    obj_bce = bce_logits(pi[..., 4], tobj, hyp.obj_pw)
    if hyp.fl_gamma > 0:
        obj_bce = obj_bce * focal_scale(pi[..., 4], tobj, hyp.fl_gamma)
    lobj = obj_bce.mean() / world_size(group)

    nc = pi.shape[-1] - 5
    if nc > 1:
        cp, cn = smooth_bce(hyp.label_smoothing)
        onehot = F.one_hot(lab[..., 0].long(), nc).bool()
        t = torch.where(onehot, cp, torch.full(onehot.shape, cn, device=dev))
        cls_bce = bce_logits(ps[..., 5:], t, hyp.cls_pw)
        if hyp.fl_gamma > 0:
            cls_bce = cls_bce * focal_scale(ps[..., 5:], t, hyp.fl_gamma)
        lcls = _masked_mean(cls_bce.mean(-1), fg_l, count)
    else:
        lcls = torch.zeros((), dtype=torch.float32, device=dev)
    return lbox, lobj, lcls


def make_compute_loss_ota(head, hyp: LossHyp, g: float = 0.5, topk: int = 10):
    """compute_loss_ota(raw, labels, label_mask) (reference loss.py:556-845)."""
    nl = len(head.strides)
    balance = balance_for(nl)
    anchors = np.asarray(head.anchors, np.float32).reshape(nl, head.na, 2)
    strides = np.asarray(head.strides, np.float32)

    def compute_loss(raw: Sequence[torch.Tensor], labels, label_mask, group=None):
        raw = [r.float() for r in raw[:nl]]
        bs = raw[0].shape[0] * world_size(group)
        fg, mg, offs = ota_assign_batch(raw, labels, label_mask, anchors, strides,
                                        hyp, g, topk)
        lbox = lobj = lcls = 0.0
        for li in range(nl):
            sl = slice(offs[li], offs[li + 1])
            lb, lo, lc = ota_level_loss(raw[li], labels, label_mask, fg[:, sl],
                                        mg[:, sl], anchors[li], hyp, g, group)
            lbox = lbox + lb
            lobj = lobj + lo * balance[li]
            lcls = lcls + lc
        lbox = lbox * hyp.box
        lobj = lobj * hyp.obj
        lcls = lcls * hyp.cls
        total = (lbox + lobj + lcls) * bs
        return total, global_items(lbox, lobj, lcls, group)

    return compute_loss
