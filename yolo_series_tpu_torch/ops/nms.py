"""Batched NMS on decoded predictions, and the fused head + NMS of serving
(counterpart of `yolo_series_tpu/ops/nms.py`: `NMSOutput`, `nms_padded`,
`batched_nms`, `_single_image_nms`, `_nms_tail`, `nms_output_to_dets`,
`fused_head_nms`, `batched_nms_kpt`).

Candidate selection is a stable descending sort over the (anchor) or
(anchor x class) scores, cut to `max_nms`: at ties the lower index comes
first, as `jax.lax.top_k` orders them. Per-class NMS uses the class-offset
trick (reference general.py:702-703): boxes are shifted by
`class_id * max_wh` so one suppression pass handles every class. The
keep-mask comes from `ops/nms_keep.nms_keep_mask` for every K: on the card
the kernel for K <= 1024 (serving) or the large-K kernel (eval and detect,
K = 8192 and 4096), on the CPU the plain version. The output is the
EfficientNMS contract: num_dets, boxes, scores, classes, with static
max_det rows. The images of a batch are a batch dimension here, where the
JAX package vmaps one image's function.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from yolo_series_tpu_torch.models.layers import Ctx
from yolo_series_tpu_torch.ops.boxes import xywh2xyxy
from yolo_series_tpu_torch.ops import nms_keep


class NMSOutput(NamedTuple):
    """EfficientNMS_TRT-style fixed-shape detections (batched)."""

    num_dets: torch.Tensor  # (B,) int32 — valid rows per image
    boxes: torch.Tensor     # (B, max_det, 4) xyxy
    scores: torch.Tensor    # (B, max_det)
    classes: torch.Tensor   # (B, max_det) int32


def _nms_tail(cand_boxes, top_scores, cand_cls, iou_thres, agnostic, max_det,
              max_wh, payload=None):
    """Greedy suppression + packed output from score-sorted candidates,
    batched: cand_boxes (B, K, 4) xyxy fp32, top_scores (B, K) fp32 (-inf =
    invalid), cand_cls (B, K) fp32. The keep-mask is looked up in
    `ops/nms_keep` at each call. payload (B, K, P): extra columns (the
    keypoints) carried through the same scatter; with it the result is
    (NMSOutput, (B, max_det, P) fp32)."""
    valid = torch.isfinite(top_scores)
    shifted = (cand_boxes if agnostic
               else cand_boxes + (cand_cls * max_wh)[..., None])
    nms_boxes = torch.where(valid[..., None], shifted,
                            torch.zeros((), device=shifted.device))
    keep = nms_keep.nms_keep_mask(nms_boxes, valid, iou_thres) & valid

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
    out = NMSOutput(num, out_boxes[:, :max_det], out_scores[:, :max_det],
                    out_cls[:, :max_det])
    if payload is None:
        return out
    out_payload = torch.zeros((b, max_det + 1, payload.shape[-1]), dtype=torch.float32,
                              device=dev)
    out_payload.scatter_(1, idx[..., None].expand(-1, -1, payload.shape[-1]), payload.float())
    return out, out_payload[:, :max_det]


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.45,
               max_output: int = 300, tile: int = 256):
    """Single-image NMS with a padded static-shape output (`nms_padded` of
    the JAX package). boxes (N, 4) xyxy, need not be sorted; scores (N,),
    a row whose score is -inf is invalid padding. Returns (indices, valid):
    (max_output,) int32 indices into the input in descending score order
    (0 past `valid`), and the scalar int32 count. The sort is stable, as
    `jnp.argsort(-scores)` is: at equal scores the lower index comes
    first. The keep-mask is `ops/nms_keep.nms_keep_mask`'s (K1 up to 1024
    rows, K1L above, on the card). `tile` sizes the JAX function's tiled
    keep-mask and has no effect here."""
    del tile
    order = torch.argsort(-scores.float(), stable=True)
    boxes_s = boxes.float()[order]
    valid_in = torch.isfinite(scores.float()[order])
    boxes_s = torch.where(valid_in[:, None], boxes_s, torch.zeros((), device=boxes.device))
    keep = nms_keep.nms_keep_mask(boxes_s[None], valid_in[None], iou_threshold)[0] & valid_in
    pos = torch.cumsum(keep.int(), 0) - 1
    writable = keep & (pos < max_output)
    # rows that are not written go to the extra slot max_output, dropped below
    slot = torch.where(writable, pos, torch.full_like(pos, max_output)).long()
    out = torch.zeros((max_output + 1,), dtype=torch.int32, device=boxes.device)
    out.scatter_(0, slot, order.int())
    valid = torch.clamp(keep.sum(), max=max_output).int()
    return out[:max_output], valid


def _top_k(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest of each row, the lower index first
    at ties (`jax.lax.top_k`'s order; torch.topk promises none)."""
    values, order = torch.sort(scores, dim=1, descending=True, stable=True)
    return values[:, :k], order[:, :k]


def _single_image_nms(pred, conf_thres, iou_thres, multi_label, agnostic,
                      max_det, max_nms, max_wh, nc, class_mask=None,
                      score_dtype=torch.float32) -> NMSOutput:
    """pred: (B, A, 5 + nc) decoded predictions (xywh, obj, classes) of a
    batch of images; `_single_image_nms` of the JAX package on each row.
    score_dtype=bfloat16 computes the (A, nc) scores in bf16, as there;
    box coordinates stay fp32."""
    b, a = pred.shape[:2]
    obj = pred[..., 4].to(score_dtype)
    cls_scores = pred[..., 5:5 + nc].to(score_dtype) * obj[..., None]
    neg_inf = torch.full((), float("-inf"), device=pred.device)
    if multi_label:
        # every (anchor, class) pair is a candidate (reference general.py:684)
        flat = cls_scores.reshape(b, a * nc).float()
        if class_mask is not None:
            flat = torch.where(class_mask.repeat(a)[None], flat, neg_inf)
        flat = torch.where(flat > conf_thres, flat, neg_inf)
        top_scores, top_flat = _top_k(flat, min(max_nms, flat.shape[1]))
        anchor_idx = top_flat // nc
        cand_cls = (top_flat % nc).float()
    else:
        # best class per anchor (reference general.py:687-688)
        if class_mask is not None:
            cls_scores = torch.where(class_mask, cls_scores,
                                     neg_inf.to(cls_scores.dtype))
        best = torch.argmax(cls_scores, dim=-1)
        score = cls_scores.max(dim=-1).values.float()
        score = torch.where(score > conf_thres, score, neg_inf)
        top_scores, anchor_idx = _top_k(score, min(max_nms, a))
        cand_cls = torch.gather(best, 1, anchor_idx).float()
    xywh = torch.gather(pred[..., 0:4].float(), 1,
                        anchor_idx[..., None].expand(-1, -1, 4))
    return _nms_tail(xywh2xyxy(xywh), top_scores.float(), cand_cls, iou_thres,
                     agnostic, max_det, max_wh)


def batched_nms(pred: torch.Tensor, conf_thres: float = 0.25,
                iou_thres: float = 0.45, multi_label: bool = False,
                agnostic: bool = False, max_det: int = 300, max_nms: int = 4096,
                max_wh: float = 4096.0, classes: Optional[Sequence[int]] = None,
                score_dtype=torch.float32) -> NMSOutput:
    """Batched end-to-end NMS on decoded predictions: pred (B, A, 5 + nc)
    in xywh + obj + cls layout (reference utils/general.py:628
    `non_max_suppression`, with static shapes). `classes` keeps only those
    class ids (general.py:691-693). The JAX function's `tile` picks its
    tiled keep-mask's tile and has no counterpart here."""
    nc = pred.shape[-1] - 5
    class_mask = None
    if classes is not None:
        class_mask = torch.zeros((nc,), dtype=torch.bool, device=pred.device)
        class_mask[torch.as_tensor(list(classes), dtype=torch.long,
                                   device=pred.device)] = True
    return _single_image_nms(pred.float(), conf_thres, iou_thres, multi_label,
                             agnostic, max_det, max_nms, max_wh, nc, class_mask,
                             score_dtype)


def nms_output_to_dets(out: NMSOutput) -> List[np.ndarray]:
    """NMSOutput -> list of (n_i, 6) numpy arrays [x1, y1, x2, y2, conf,
    cls] (reference detect.py:152, test.py:126)."""
    num = out.num_dets.cpu().numpy()
    boxes = out.boxes.cpu().numpy()
    scores = out.scores.cpu().numpy()
    classes = out.classes.cpu().numpy()
    return [np.concatenate([boxes[i, :n], scores[i, :n, None],
                            classes[i, :n, None].astype(np.float32)], axis=1)
            for i, n in enumerate(num.astype(int))]


def fused_head_nms(head, head_params, feats, *, conf_thres=0.25,
                   iou_thres=0.45, max_det=300, max_nms=256, max_wh=4096.0,
                   compute_dtype=torch.bfloat16,
                   anchors: Optional[torch.Tensor] = None) -> NMSOutput:
    """Serving fast path: head convs + candidate top-k + decode of the
    selected rows + NMS, without materializing the (B, A, no) decoded
    tensor. multi_label=False semantics (reference general.py:687-688).

    head: Detect; head_params: {"m": [{w, b}]} fused convs; feats: per-level
    (B, ny, nx, c) NHWC head inputs. anchors: `head.anchors_grid()` already
    on the device, so that no host-to-device copy runs inside a CUDA-graph
    capture (made here when None).
    """
    nc, na, nl, no = head.nc, head.na, head.nl, head.no
    if "ia" in head_params:
        raise ValueError("fused_head_nms wants a fused head: fold IDetect's "
                         "implicit layers first (reparam.fuse_model)")
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
    if anchors is None:
        anchors = torch.as_tensor(head.anchors_grid(), dtype=torch.float32, device=dev)

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
    top_scores, flat_idx = _top_k(score, k)

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
        anc_l = anchors[li][a_l]
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
                     max_det, max_wh)


def batched_nms_kpt(pred: torch.Tensor, conf_thres: float = 0.25, iou_thres: float = 0.45,
                    max_det: int = 300, max_nms: int = 256, max_wh: float = 4096.0,
                    agnostic: bool = False):
    """Keypoint NMS (reference non_max_suppression_kpt, general.py:723-780,
    kpt_label=True) on the IKeypoint head's decoded output pred (B, A,
    6 + 3 nkpt) = [xywh, obj, cls, keypoints...], obj and cls already
    sigmoids; score = obj x cls, one class. Returns (num_dets (B,), boxes
    (B, max_det, 4) xyxy, scores, classes, keypoints (B, max_det,
    3 nkpt)), static shapes. At the default max_nms the keep-mask is K1's
    on the card."""
    score = (pred[..., 4] * pred[..., 5]).float()
    score = torch.where(score > conf_thres, score, torch.full_like(score, float("-inf")))
    top_scores, idx = _top_k(score, min(max_nms, score.shape[1]))
    rows = torch.gather(pred, 1, idx[..., None].expand(-1, -1, pred.shape[-1]))
    cand_cls = torch.zeros(top_scores.shape, dtype=torch.float32, device=pred.device)
    out, kpts = _nms_tail(xywh2xyxy(rows[..., 0:4].float()), top_scores, cand_cls, iou_thres,
                          agnostic, max_det, max_wh, payload=rows[..., 6:])
    return (*out, kpts)
