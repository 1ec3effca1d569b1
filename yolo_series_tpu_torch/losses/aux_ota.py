"""ComputeLossAuxOTA, the coarse-to-fine deep supervision of IAuxDetect
(counterpart of `yolo_series_tpu/losses/aux_ota.py`; reference
utils/loss.py:1175-1696).

The lead branch assigns with the 3-positive scheme (g = 0.5) and top-20
dynamic k, the aux branch with the wider 5-positive scheme (g = 1.0,
find_5_positive, loss.py:1592-1643) and top-20. Both assignments come
from the LEAD maps (build_targets2(p[:nl]), loss.py:1205), and the aux
terms weigh `hyp.aux_w` (0.25, loss.py:1258, 1268, 1272).

raw: [lead_0 .. lead_{nl-1}, aux_0 .. aux_{nl-1}], as IAuxDetect returns
them in training (`models/heads.py`). Under a process group both branches
normalize over the global batch, as the OTA loss does (`losses/ota.py`).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from yolo_series_tpu_torch.losses.ota import ota_assign_batch, ota_level_loss
from yolo_series_tpu_torch.losses.yolo_loss import LossHyp, balance_for, global_items
from yolo_series_tpu_torch.parallel.dist import world_size


def make_compute_loss_aux_ota(head, hyp: LossHyp, topk: int = 20):
    """compute_loss(raw, labels, label_mask) -> (total x B, {box, obj, cls})."""
    nl = len(head.strides)
    balance = balance_for(nl)
    anchors = np.asarray(head.anchors, np.float32).reshape(nl, head.na, 2)
    strides = np.asarray(head.strides, np.float32)

    def compute_loss(raw: Sequence, labels, label_mask, group=None):
        if len(raw) < 2 * nl:
            raise ValueError(f"the aux loss needs {2 * nl} maps (lead + aux), "
                             f"got {len(raw)}")
        lead = [r.float() for r in raw[:nl]]
        aux = [r.float() for r in raw[nl:2 * nl]]
        bs = lead[0].shape[0] * world_size(group)
        fg, mg, offs = ota_assign_batch(lead, labels, label_mask, anchors, strides,
                                        hyp, g=0.5, topk=topk)
        fg_a, mg_a, offs_a = ota_assign_batch(lead, labels, label_mask, anchors,
                                              strides, hyp, g=1.0, topk=topk)
        lbox = lobj = lcls = 0.0
        for li in range(nl):
            sl, sl_a = slice(offs[li], offs[li + 1]), slice(offs_a[li], offs_a[li + 1])
            lb, lo, lc = ota_level_loss(lead[li], labels, label_mask, fg[:, sl],
                                        mg[:, sl], anchors[li], hyp, 0.5, group)
            lb_a, lo_a, lc_a = ota_level_loss(aux[li], labels, label_mask, fg_a[:, sl_a],
                                              mg_a[:, sl_a], anchors[li], hyp, 1.0, group)
            lbox = lbox + lb + hyp.aux_w * lb_a
            lobj = lobj + (lo + hyp.aux_w * lo_a) * balance[li]
            lcls = lcls + lc + hyp.aux_w * lc_a
        lbox = lbox * hyp.box
        lobj = lobj * hyp.obj
        lcls = lcls * hyp.cls
        total = (lbox + lobj + lcls) * bs
        return total, global_items(lbox, lobj, lcls, group)

    return compute_loss
