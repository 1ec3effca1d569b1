"""ComputeLossBinOTA, the OTA loss of the IBin head (counterpart of
`yolo_series_tpu/losses/bin_ota.py`; reference utils/loss.py:848-1172).

An anchor's channels are [x, y, w bins (bl), h bins (bl), obj, classes]
with bl = bin_count + 1. The assignment is the port's SimOTA
(`losses/ota.ota_assign_batch`, which keeps `_top_k_iter`'s tie order),
its costs decoding w and h through `SigmoidBin.forward` (loss.py:1018-1019);
the box loss adds the bins' training losses (BCE over the bins; the MSE
of the residual is off, use_loss_regression=False, as loss.py:876 sets it)
to the CIoU term (loss.py:910-929). Under a process group the means are
the global batch's, as in `losses/ota.py`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from yolo_series_tpu_torch.losses.bin import SigmoidBin
from yolo_series_tpu_torch.losses.ota import K_OFFSETS, ota_assign_batch
from yolo_series_tpu_torch.losses.targets import const_on, find_positive
from yolo_series_tpu_torch.losses.yolo_loss import (LossHyp, _masked_mean, balance_for,
                                                    bce_logits, global_items,
                                                    objectness_target, positive_count,
                                                    smooth_bce)
from yolo_series_tpu_torch.ops.boxes import bbox_iou
from yolo_series_tpu_torch.parallel.dist import world_size


def make_compute_loss_bin_ota(head, hyp: LossHyp, topk: int = 10):
    """compute_loss(raw, labels, label_mask, group=None) -> (loss x B,
    {box, obj, cls}) for an IBin head."""
    nl = len(head.strides)
    balance = balance_for(nl)
    anchors = np.asarray(head.anchors, np.float32).reshape(nl, head.na, 2)
    strides = np.asarray(head.strides, np.float32)
    sb = SigmoidBin(head.bin_count, 0.0, 4.0, use_loss_regression=False)
    bl = sb.length
    obj_idx = 2 * bl + 2
    nc = head.nc
    cp, cn = smooth_bce(hyp.label_smoothing)

    def wh_decode(ps, anc):
        y = torch.sigmoid(ps)
        pw = sb.forward(y[..., 2:2 + bl]) * anc[:, 0]
        ph = sb.forward(y[..., 2 + bl:obj_idx]) * anc[:, 1]
        return torch.stack([pw, ph], -1)

    codec = {"obj_idx": obj_idx, "wh_decode": wh_decode}

    def compute_loss(raw: Sequence[torch.Tensor], labels, label_mask, group=None):
        raw = [r.float() for r in raw[:nl]]
        bs = raw[0].shape[0] * world_size(group)
        fg, mg, offs = ota_assign_batch(raw, labels, label_mask, anchors, strides, hyp,
                                        0.5, topk, codec=codec)
        lbox = lobj = lcls = 0.0
        m, na = labels.shape[1], head.na
        for li in range(nl):
            pi = raw[li]
            b, ny, nx = pi.shape[0], pi.shape[2], pi.shape[3]
            dev = pi.device
            fg_l = fg[:, offs[li]:offs[li + 1]]
            mg_l = mg[:, offs[li]:offs[li + 1]]
            cand = find_positive(labels, label_mask, anchors[li], (ny, nx), hyp.anchor_t,
                                 g=0.5)
            gi = cand.gi.reshape(b, -1)
            gj = cand.gj.reshape(b, -1)
            ai = torch.arange(na, device=dev)[None, None, :, None].expand(
                b, m, na, K_OFFSETS).reshape(b, -1)
            bi = torch.arange(b, device=dev)[:, None].expand(gi.shape)
            ps = pi[bi, ai, gj, gi]                                      # (B, Cl, no)

            lab = labels[bi, mg_l]
            gain = const_on([nx, ny, nx, ny], dev)
            tb = lab[..., 1:5] * gain
            grid = torch.stack([gi, gj], -1).float()
            tb = torch.cat([tb[..., 0:2] - grid, tb[..., 2:4]], -1)

            anc = cand.anchors[None, None, :, None, :].expand(
                b, m, na, K_OFFSETS, 2).reshape(b, -1, 2)
            count = positive_count(fg_l, group)
            # the bins' training losses on the w / h ratios (loss.py:910-913)
            w_loss, pw = sb.training_loss(ps[..., 2:2 + bl], tb[..., 2] / anc[..., 0],
                                          valid=fg_l, count=count)
            h_loss, ph = sb.training_loss(ps[..., 2 + bl:obj_idx], tb[..., 3] / anc[..., 1],
                                          valid=fg_l, count=count)
            pxy = torch.sigmoid(ps[..., 0:2]) * 2.0 - 0.5
            pbox = torch.cat([pxy, (pw * anc[..., 0])[..., None],
                              (ph * anc[..., 1])[..., None]], -1)
            iou = bbox_iou(pbox, tb, xywh=True, ciou=True)
            lbox = lbox + (w_loss + h_loss + _masked_mean(1.0 - iou, fg_l, count))

            tobj_val = (1.0 - hyp.gr) + hyp.gr * torch.clamp(iou.detach(), min=0.0)
            tobj = objectness_target(pi.shape[:4], bi, ai, gj, gi, tobj_val, fg_l)
            lobj = lobj + (bce_logits(pi[..., obj_idx], tobj, hyp.obj_pw).mean()
                           / world_size(group)) * balance[li]

            if nc > 1:
                onehot = F.one_hot(lab[..., 0].long(), nc).bool()
                t = torch.where(onehot, cp, torch.full(onehot.shape, cn, device=dev))
                lcls = lcls + _masked_mean(
                    bce_logits(ps[..., obj_idx + 1:], t, hyp.cls_pw).mean(-1), fg_l, count)
        if not torch.is_tensor(lcls):
            lcls = torch.zeros((), dtype=torch.float32, device=raw[0].device)
        lbox = lbox * hyp.box
        lobj = lobj * hyp.obj
        lcls = lcls * hyp.cls
        total = (lbox + lobj + lcls) * bs
        return total, global_items(lbox, lobj, lcls, group)

    return compute_loss
