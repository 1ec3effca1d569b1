"""Fused head + candidate selection + greedy NMS for serving (counterpart of
`yolo_series_tpu/ops/nms.py`: `NMSOutput`, `_nms_tail`, `fused_head_nms`).

Per-class NMS uses the class-offset trick (reference general.py:702-703):
boxes are shifted by `class_id * max_wh` so one suppression pass handles
every class. The keep-mask comes from `ops/nms_keep.nms_keep_mask` (a CUDA
kernel on the card). The output is the EfficientNMS contract: num_dets,
boxes, scores, classes, with static max_det rows. `batched_nms` and the
tiled keep-mask of the eval path are ROADMAP queue 1, item 4.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from yolo_series_tpu_torch.models.layers import Ctx
from yolo_series_tpu_torch.ops.boxes import xywh2xyxy
from yolo_series_tpu_torch.ops.nms_keep import nms_keep_mask


class NMSOutput(NamedTuple):
    """EfficientNMS_TRT-style fixed-shape detections (batched)."""

    num_dets: torch.Tensor  # (B,) int32 — valid rows per image
    boxes: torch.Tensor     # (B, max_det, 4) xyxy
    scores: torch.Tensor    # (B, max_det)
    classes: torch.Tensor   # (B, max_det) int32


def _nms_tail(cand_boxes, top_scores, cand_cls, iou_thres, agnostic, max_det,
              max_wh, keep_fn: Callable = nms_keep_mask) -> NMSOutput:
    """Greedy suppression + packed output from score-sorted candidates,
    batched: cand_boxes (B, K, 4) xyxy fp32, top_scores (B, K) fp32 (-inf =
    invalid), cand_cls (B, K) fp32. keep_fn is the keep-mask; the on-card
    reference of chip_smoke.py passes the plain version."""
    valid = torch.isfinite(top_scores)
    shifted = (cand_boxes if agnostic
               else cand_boxes + (cand_cls * max_wh)[..., None])
    nms_boxes = torch.where(valid[..., None], shifted,
                            torch.zeros((), device=shifted.device))
    keep = keep_fn(nms_boxes, valid, iou_thres) & valid

    b = keep.shape[0]
    pos = torch.cumsum(keep.int(), dim=1) - 1
    writable = keep & (pos < max_det)
    # rows that are not written go to the extra slot max_det, dropped below
    idx = torch.where(writable, pos, torch.full_like(pos, max_det)).long()
    dev = cand_boxes.device
    out_boxes = torch.zeros((b, max_det + 1, 4), dtype=torch.float32, device=dev)
    out_boxes.scatter_(1, idx[..., None].expand(-1, -1, 4), cand_boxes.float())
    out_scores = torch.zeros((b, max_det + 1), dtype=torch.float32, device=dev)
    out_scores.scatter_(1, idx, top_scores.float())
    out_cls = torch.zeros((b, max_det + 1), dtype=torch.int32, device=dev)
    out_cls.scatter_(1, idx, cand_cls.int())
    num = torch.clamp(keep.sum(dim=1), max=max_det).int()
    return NMSOutput(num, out_boxes[:, :max_det], out_scores[:, :max_det],
                     out_cls[:, :max_det])


def fused_head_nms(head, head_params, feats, *, conf_thres=0.25,
                   iou_thres=0.45, max_det=300, max_nms=256, max_wh=4096.0,
                   compute_dtype=torch.bfloat16,
                   keep_fn: Callable = nms_keep_mask) -> NMSOutput:
    """Serving fast path: head convs + candidate top-k + decode of the
    selected rows + NMS, without materializing the (B, A, no) decoded
    tensor. multi_label=False semantics (reference general.py:687-688).

    head: Detect; head_params: {"m": [{w, b}]} fused convs; feats: per-level
    (B, ny, nx, c) NHWC head inputs.
    """
    nc, na, nl, no = head.nc, head.na, head.nl, head.no
    apx = head.anchors_grid()  # (nl, na, 2) pixel anchors
    if len(feats) < nl:
        raise ValueError(f"{len(feats)} feature levels for a {nl}-level head")
    convs = head._convs()
    ctx = Ctx(dtype=compute_dtype)
    raw_levels, dims = [], []
    for i in range(nl):
        y, _ = convs[i].apply(head_params["m"][i], {},
                              feats[i].permute(0, 3, 1, 2), ctx)
        bsz, _, ny, nx = y.shape
        # flat index is cell-major (ny, nx, na), as from the NHWC reshape
        raw_levels.append(y.permute(0, 2, 3, 1).reshape(bsz, ny * nx * na, no))
        dims.append((ny, nx))
    offs = np.cumsum([0] + [r.shape[1] for r in raw_levels])
    dev = raw_levels[0].device

    scores = []
    for r in raw_levels:
        rf = r.float()
        obj = torch.sigmoid(rf[..., 4])
        cls_best = torch.sigmoid(rf[..., 5:5 + nc].max(dim=-1).values)
        scores.append(obj * cls_best)
    score = torch.cat(scores, dim=1)
    score = torch.where(score > conf_thres, score,
                        torch.full_like(score, float("-inf")))
    k = min(max_nms, score.shape[1])
    # stable descending sort: ties keep the lower index first, as
    # jax.lax.top_k does (torch.topk promises no order at ties)
    sorted_scores, order = torch.sort(score, dim=1, descending=True, stable=True)
    top_scores, flat_idx = sorted_scores[:, :k], order[:, :k]

    rows = torch.zeros((bsz, k, no), dtype=torch.float32, device=dev)
    grid = torch.zeros((bsz, k, 2), dtype=torch.float32, device=dev)
    anc = torch.zeros((bsz, k, 2), dtype=torch.float32, device=dev)
    strd = torch.zeros((bsz, k), dtype=torch.float32, device=dev)
    for li in range(nl):
        ny, nx = dims[li]
        n_l = ny * nx * na
        in_level = (flat_idx >= int(offs[li])) & (flat_idx < int(offs[li + 1]))
        idx_l = torch.clamp(flat_idx - int(offs[li]), 0, n_l - 1)
        r_l = torch.gather(raw_levels[li], 1,
                           idx_l[..., None].expand(-1, -1, no)).float()
        cell = idx_l // na
        a_l = idx_l % na
        g_l = torch.stack([(cell % nx).float(), (cell // nx).float()], -1)
        anc_l = torch.as_tensor(apx[li], dtype=torch.float32, device=dev)[a_l]
        rows = torch.where(in_level[..., None], r_l, rows)
        grid = torch.where(in_level[..., None], g_l, grid)
        anc = torch.where(in_level[..., None], anc_l, anc)
        strd = torch.where(in_level, torch.full_like(strd, float(head.strides[li])),
                           strd)

    # decode only the selected candidates (reference yolo.py:55-57)
    sig = torch.sigmoid(rows[..., 0:4])
    xy = (sig[..., 0:2] * 2.0 - 0.5 + grid) * strd[..., None]
    wh = torch.square(sig[..., 2:4] * 2.0) * anc
    cand_boxes = xywh2xyxy(torch.cat([xy, wh], dim=-1))
    cand_cls = torch.argmax(rows[..., 5:5 + nc], dim=-1).float()
    return _nms_tail(cand_boxes, top_scores, cand_cls, iou_thres, False,
                     max_det, max_wh, keep_fn)
