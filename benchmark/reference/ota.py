"""A frozen copy of the OTA loss of YOLOv7 (upstream utils/loss.py
ComputeLossOTA, :556-845), in the batched static-shape form the program
had when the benchmark was written (labels padded to (B, M, 5) with a
mask; candidates (gt, level, anchor, lateral offset) with a validity bit),
so that the reference does not import the program. Hyperparameters are
hyp.scratch.p5's at nl 3, nc 80, 640 px: box 0.05, obj 0.7, cls 0.3,
anchor_t 4, no focal loss, no label smoothing, gr 1, offsets g 0.5,
top-k 10.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

BOX, OBJ, CLS, ANCHOR_T, GR, G, TOPK = 0.05, 0.7, 0.3, 4.0, 1.0, 0.5, 10
K_OFFSETS = 5
_OFF = np.asarray([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]], np.float32)


def xywh2xyxy(x):
    xy, wh = x[..., 0:2], x[..., 2:4] * 0.5
    return torch.cat([xy - wh, xy + wh], dim=-1)


def box_iou(box1, box2, eps=1e-7):
    lt = torch.maximum(box1[..., :, None, 0:2], box2[..., None, :, 0:2])
    rb = torch.minimum(box1[..., :, None, 2:4], box2[..., None, :, 2:4])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda b: (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])  # noqa: E731
    union = area(box1)[..., :, None] + area(box2)[..., None, :] - inter
    return inter / (union + eps)


def ciou(box1, box2, eps=1e-7):
    """CIoU of aligned centre-xywh boxes (upstream general.bbox_iou with
    CIoU=True; alpha detached)."""
    b1, b2 = xywh2xyxy(box1), xywh2xyxy(box2)
    clip0 = lambda x: torch.maximum(x, torch.zeros_like(x))  # noqa: E731
    inter = (clip0(torch.minimum(b1[..., 2], b2[..., 2]) - torch.maximum(b1[..., 0], b2[..., 0]))
             * clip0(torch.minimum(b1[..., 3], b2[..., 3])
                     - torch.maximum(b1[..., 1], b2[..., 1])))
    w1, h1 = b1[..., 2] - b1[..., 0], b1[..., 3] - b1[..., 1] + eps
    w2, h2 = b2[..., 2] - b2[..., 0], b2[..., 3] - b2[..., 1] + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    cw = torch.maximum(b1[..., 2], b2[..., 2]) - torch.minimum(b1[..., 0], b2[..., 0])
    ch = torch.maximum(b1[..., 3], b2[..., 3]) - torch.minimum(b1[..., 1], b2[..., 1])
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((b2[..., 0] + b2[..., 2] - b1[..., 0] - b1[..., 2]) ** 2
            + (b2[..., 1] + b2[..., 3] - b1[..., 1] - b1[..., 3]) ** 2) / 4.0
    v = (4.0 / math.pi ** 2) * (torch.atan(w2 / (h2 + eps)) - torch.atan(w1 / (h1 + eps))) ** 2
    denom = v - iou + (1.0 + eps)
    pos = v > 0.0
    alpha = torch.where(pos, v / torch.where(pos, denom, torch.ones_like(denom)),
                        torch.zeros_like(v)).detach()
    return iou - (rho2 / c2 + v * alpha)


def bce_logits(logits, targets):
    return -(targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits))


def find_positive(labels, mask, anchors, grid):
    """Candidates of one level: gi, gj (B, M, K), valid (B, M, na, K),
    anchors (na, 2) in grid units (upstream find_3_positive)."""
    ny, nx = grid
    dev = labels.device
    gain = torch.tensor([nx, ny, nx, ny], dtype=torch.float32, device=dev)
    txywh = labels[..., 1:5] * gain
    txy, twh = txywh[..., 0:2], txywh[..., 2:4]
    anc = torch.as_tensor(np.asarray(anchors, np.float32), device=dev)
    r = twh[:, :, None, :] / anc[None, None, :, :]
    anchor_ok = torch.maximum(r, 1.0 / r).amax(-1) < ANCHOR_T
    inv = torch.tensor([nx, ny], dtype=torch.float32, device=dev) - txy
    fx, fy = txy[..., 0] % 1.0, txy[..., 1] % 1.0
    ix, iy = inv[..., 0] % 1.0, inv[..., 1] % 1.0
    off_ok = torch.stack([torch.ones_like(fx, dtype=torch.bool),
                          (fx < G) & (txy[..., 0] > 1.0), (fy < G) & (txy[..., 1] > 1.0),
                          (ix < G) & (inv[..., 0] > 1.0), (iy < G) & (inv[..., 1] > 1.0)], -1)
    off = torch.as_tensor(_OFF * np.float32(G), device=dev)
    gij = torch.floor(txy[:, :, None, :] - off[None, None, :, :]).long()
    gi = torch.clamp(gij[..., 0], 0, nx - 1)
    gj = torch.clamp(gij[..., 1], 0, ny - 1)
    valid = mask[:, :, None, None] & anchor_ok[:, :, :, None] & off_ok[:, :, None, :]
    return gi, gj, valid, anc


def _top_k_iter(x, k):
    """Top-k by k argmax passes (the first index wins a tie)."""
    x = x.clone()
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(x, dim=-1, keepdim=True)
        vals.append(torch.gather(x, -1, i))
        idxs.append(i)
        x.scatter_(-1, i, float("-inf"))
    return torch.cat(vals, -1), torch.cat(idxs, -1)


def _expand(gi, m, na):
    b = gi.shape[0]
    return gi[:, :, None, :].expand(b, m, na, K_OFFSETS).reshape(b, -1)


@torch.no_grad()
def assign(raw, labels, mask, anchors, strides):
    """SimOTA: fg (B, C) and matched gt (B, C) over the level-major
    candidate columns, and the levels' column offsets."""
    img = raw[0].shape[2] * float(strides[0])
    b, m = labels.shape[:2]
    na = anchors.shape[1]
    dev = labels.device
    all_ps, all_valid, all_xyxy = [], [], []
    for li, r in enumerate(raw):
        ny, nx = r.shape[2], r.shape[3]
        gi, gj, valid, anc = find_positive(labels, mask, anchors[li], (ny, nx))
        gi, gj = _expand(gi, m, na), _expand(gj, m, na)
        ai = torch.arange(na, device=dev)[:, None].expand(m, na, K_OFFSETS).reshape(-1)
        bi = torch.arange(b, device=dev)[:, None]
        ps = r[bi, ai[None, :], gj, gi]
        ancx = anc[None, :, None, :].expand(m, na, K_OFFSETS, 2).reshape(-1, 2)
        grid = torch.stack([gi, gj], -1).float()
        pxy = (torch.sigmoid(ps[..., 0:2]) * 2.0 - 0.5 + grid) * float(strides[li])
        pwh = torch.square(torch.sigmoid(ps[..., 2:4]) * 2.0) * ancx * float(strides[li])
        all_xyxy.append(xywh2xyxy(torch.cat([pxy, pwh], -1)))
        all_ps.append(ps)
        all_valid.append(valid.reshape(b, -1))
    p_xyxy, p_all, v_all = torch.cat(all_xyxy, 1), torch.cat(all_ps, 1), torch.cat(all_valid, 1)
    c_total = p_xyxy.shape[1]
    t_xyxy = xywh2xyxy(labels[..., 1:5] * img)
    pair_ok = mask[:, :, None] & v_all[:, None, :]
    pair_iou = torch.where(pair_ok, box_iou(t_xyxy, p_xyxy), 0.0)
    iou_cost = -torch.log(pair_iou + 1e-8)
    k = min(TOPK, c_total)
    dyn_k = torch.clamp(_top_k_iter(pair_iou, k)[0].sum(-1).to(torch.int32), min=1)
    obj_l, cls_l = p_all[..., 4:5], p_all[..., 5:]
    y = torch.sqrt(torch.sigmoid(cls_l) * torch.sigmoid(obj_l))
    z = torch.log(y / (1.0 - y + 1e-12) + 1e-12)
    sp_sum = torch.logaddexp(z, torch.zeros_like(z)).sum(-1)
    gt_cls = labels[..., 0].long()
    z_gt = torch.gather(z.transpose(1, 2), 1, gt_cls[:, :, None].expand(b, m, c_total))
    big = 1e8
    cost = torch.where(pair_ok, sp_sum[:, None, :] - z_gt + 3.0 * iou_cost, big)
    neg_top, top_idx = _top_k_iter(-cost, k)
    rank_ok = (torch.arange(k, device=dev) < dyn_k[..., None]) & (-neg_top < big * 0.5)
    matching = torch.zeros((b, m, c_total), dtype=torch.bool, device=dev)
    matching.scatter_(2, top_idx, rank_ok)
    claims = matching.sum(1)
    best_gt = torch.argmin(cost, 1)
    exclusive = torch.arange(m, device=dev)[None, :, None] == best_gt[:, None, :]
    matching = torch.where(claims[:, None, :] > 1, exclusive, matching)
    fg = matching.any(1) & v_all
    matched = torch.argmax(matching.to(torch.uint8), 1)
    return fg, matched, np.cumsum([0] + [m * na * K_OFFSETS] * len(raw))


def level_loss(pi, labels, mask, fg, mg, anchors_l):
    """(lbox, mean objectness BCE, lcls) of one level."""
    bs, na, ny, nx = pi.shape[:4]
    m = labels.shape[1]
    dev = pi.device
    gi, gj, _, anc = find_positive(labels, mask, anchors_l, (ny, nx))
    gi, gj = _expand(gi, m, na), _expand(gj, m, na)
    ai = torch.arange(na, device=dev)[None, None, :, None].expand(bs, m, na, K_OFFSETS).reshape(bs, -1)
    bi = torch.arange(bs, device=dev)[:, None].expand(gi.shape)
    ps = pi[bi, ai, gj, gi]
    lab = labels[bi, mg]
    tb = lab[..., 1:5] * torch.tensor([nx, ny, nx, ny], dtype=torch.float32, device=dev)
    grid = torch.stack([gi, gj], -1).float()
    tb = torch.cat([tb[..., 0:2] - grid, tb[..., 2:4]], -1)
    ancx = anc[None, None, :, None, :].expand(bs, m, na, K_OFFSETS, 2).reshape(bs, -1, 2)
    pxy = torch.sigmoid(ps[..., 0:2]) * 2.0 - 0.5
    pwh = torch.square(torch.sigmoid(ps[..., 2:4]) * 2.0) * ancx
    iou = ciou(torch.cat([pxy, pwh], -1), tb)
    count = torch.clamp(fg.float().sum(), min=1.0)
    zero = torch.zeros((), dtype=iou.dtype, device=dev)
    lbox = torch.where(fg, 1.0 - iou, zero).sum() / count
    tval = (1.0 - GR) + GR * torch.clamp(iou.detach(), min=0.0)
    n = bs * na * ny * nx
    flat = ((bi * na + ai) * ny + gj) * nx + gi
    flat = torch.where(fg, flat, torch.full_like(flat, n))
    tobj = torch.zeros(n + 1, dtype=tval.dtype, device=dev)
    tobj.scatter_reduce_(0, flat.reshape(-1), tval.reshape(-1), reduce="amax")
    lobj = bce_logits(pi[..., 4], tobj[:n].reshape(bs, na, ny, nx)).mean()
    nc = pi.shape[-1] - 5
    t = F.one_hot(lab[..., 0].long(), nc).to(ps.dtype)
    lcls = torch.where(fg, bce_logits(ps[..., 5:], t).mean(-1), zero).sum() / count
    return lbox, lobj, lcls


def loss(raw, labels, mask, anchors_px, strides):
    """(loss x batch, {box, obj, cls}) of the raw maps [(B, na, ny, nx, no)];
    anchors_px: (nl, na, 2) pixels."""
    raw = [r.float() for r in raw]
    nl = len(raw)
    anchors = np.asarray(anchors_px, np.float32) / np.asarray(strides, np.float32)[:, None, None]
    balance = [4.0, 1.0, 0.4] if nl == 3 else [4.0, 1.0, 0.25, 0.06, 0.02][:nl]
    fg, mg, offs = assign(raw, labels, mask, anchors, strides)
    lbox = lobj = lcls = 0.0
    for li in range(nl):
        sl = slice(offs[li], offs[li + 1])
        b, o, c = level_loss(raw[li], labels, mask, fg[:, sl], mg[:, sl], anchors[li])
        lbox, lobj, lcls = lbox + b, lobj + o * balance[li], lcls + c
    lbox, lobj, lcls = lbox * BOX, lobj * OBJ, lcls * CLS
    return (lbox + lobj + lcls) * raw[0].shape[0], {"box": lbox, "obj": lobj, "cls": lcls}
