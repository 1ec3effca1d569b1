"""The comparisons that decide `correct`.

Detections (serving cells): one image's served detections are judged
against the reference's every anchor of that image (boxes and the score
of every class, fp32 forward, decoded in fp64) by the widest of three
gaps, each 0 for an exact greedy-NMS answer of the reference's own
candidates and each moving continuously with rounding:

  * det: for each served detection, the least over the reference's anchors
    of max(|score - the anchor's score for the detection's class|, the
    largest corner offset over the anchor box's longer side (at least
    1 px)): how far the detection is from anything the model puts there
    (an offset and not 1 - IoU, which thin boxes make jump);
  * overlap: for two served detections of one class, how far their IoU
    exceeds the NMS threshold (a suppression left out);
  * unexplained: for each reference anchor that must reach NMS (its best
    score at least conf_thres + SLACK, within the candidate cut, and above
    the last served score when the answer is full), how far below the NMS
    threshold its best IoU with a served detection of a near-tied class
    and a score at least its own less SLACK lies (it is neither served nor
    suppressed by something served: a missing answer).

SLACK only excuses the edges (a score near the threshold or near the last
served one, two near-tied classes or scores), where rounding may decide
either way; it is not a tolerance of the gaps.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

SLACK = 0.1
NOT_FINITE = 1e9   # the det gap of a served box or score that is not finite


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes (n, 4) x (m, 4) -> (n, m)."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area = lambda x: (x[:, 2] - x[:, 0]).clamp(min=0) * (x[:, 3] - x[:, 1]).clamp(min=0)  # noqa
    return inter / (area(a)[:, None] + area(b)[None, :] - inter + 1e-12)


def detection_gaps(served: Dict[str, np.ndarray], ref_boxes: torch.Tensor,
                   ref_scores: torch.Tensor, nms: dict) -> Dict[str, float]:
    """served: one image's {num_dets, det_boxes, det_scores, det_classes}
    (numpy, as the engine returns them); ref_boxes (A, 4) and ref_scores
    (A, nc), fp64 on the device, in the served boxes' pixel frame.
    Returns {"det", "overlap", "unexplained", "served", "must"} and the
    items "det_all", "miss_all"."""
    dev, dt = ref_boxes.device, torch.float64
    n = int(np.asarray(served["num_dets"]).reshape(-1)[0])
    boxes = torch.as_tensor(np.asarray(served["det_boxes"])[:n], dtype=dt, device=dev)
    scores = torch.as_tensor(np.asarray(served["det_scores"])[:n], dtype=dt, device=dev)
    classes = torch.as_tensor(np.asarray(served["det_classes"])[:n], dtype=torch.long,
                              device=dev)
    thr, conf = nms["iou_thres"], nms["conf_thres"]
    out = {"det": 0.0, "overlap": 0.0, "unexplained": 0.0, "served": n}
    if not bool(torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
        out["det"] = NOT_FINITE        # an answer that is no number fails any limit
        out["det_all"] = np.asarray([NOT_FINITE])
        return out
    if n:
        side = (ref_boxes[:, 2:] - ref_boxes[:, :2]).amax(1).clamp(min=1.0)    # (A,)
        off = (boxes[:, None, :] - ref_boxes[None, :, :]).abs().amax(-1) / side  # (n, A)
        s_ref = ref_scores[:, classes].T                               # (n, A)
        gap = torch.maximum((scores[:, None] - s_ref).abs(), off).min(1).values
        out["det"] = float(gap.max())
        out["det_all"] = gap.cpu().numpy()
        pair = _iou(boxes, boxes)
        same = (classes[:, None] == classes[None, :]) & ~torch.eye(n, dtype=torch.bool,
                                                                    device=dev)
        out["overlap"] = float(torch.where(same, pair - thr, torch.zeros_like(pair))
                               .clamp(min=0).max())
    best = ref_scores.max(1).values                                    # (A,)
    floor = conf + SLACK
    ranked = torch.sort(best[best > conf], descending=True).values
    if len(ranked) > nms["max_nms"]:
        floor = max(floor, float(ranked[nms["max_nms"] - 1]) + SLACK)
    if n >= nms["max_det"]:
        floor = max(floor, float(scores.min()) + SLACK)
    keep = best >= floor
    must = torch.nonzero(keep).reshape(-1)
    out["must"] = int(len(must))
    if len(must):
        if n == 0:
            out["unexplained"] = thr
            out["miss_all"] = np.full(len(must), thr)
            return out
        iou = _iou(ref_boxes[must], boxes)                             # (m, n)
        cls_ok = ref_scores[must][:, classes] >= best[must][:, None] - SLACK
        score_ok = scores[None, :] >= best[must][:, None] - SLACK
        reach = torch.where(cls_ok & score_ok, iou, torch.zeros_like(iou)).max(1).values
        miss = (thr - reach).clamp(min=0)
        out["unexplained"] = float(miss.max())
        out["miss_all"] = miss.cpu().numpy()
        w = int(miss.argmax())
        a = int(must[w])
        top2 = ref_scores[a].topk(2)
        j = int(iou[w].argmax())
        out["worst_miss"] = {"anchor": a, "box": [round(float(v), 2) for v in ref_boxes[a]],
                             "best": float(best[a]), "classes": top2.indices.tolist(),
                             "scores": [float(v) for v in top2.values],
                             "nearest": {"iou": float(iou[w, j]), "class": int(classes[j]),
                                         "score": float(scores[j]),
                                         "box": [round(float(v), 2) for v in boxes[j]]},
                             "served": n, "floor": floor}
    return out


def widest(gaps, thr: float) -> Dict[str, float]:
    """The compared number over all images' items: `det_gap`, the widest of
    the served detections' det gaps, the must-reach anchors' unexplained
    gaps over the NMS threshold (1: nothing served explains it) and the
    detection pairs' overlap excesses; beside it the quantiles and the
    widest of each kind (readings only), and the items themselves under
    "items"."""
    cat = lambda key: np.concatenate([np.asarray(g.get(key, np.zeros(0)), np.float64)  # noqa
                                      for g in gaps] + [np.zeros(0)])
    det, miss = cat("det_all"), cat("miss_all") / thr
    over = np.asarray([g["overlap"] for g in gaps], np.float64)
    items = np.concatenate([det, miss, over])
    q = lambda x, p: float(np.quantile(x, p)) if len(x) else 0.0  # noqa: E731
    out = {"det_gap": float(items.max()) if len(items) else 0.0}
    worst = max(gaps, key=lambda g: g["unexplained"], default=None)
    if worst is not None and worst["unexplained"] > 0:
        out["worst_miss"] = worst.get("worst_miss")
    for name, x in (("det", det), ("miss", miss)):
        for p in (0.5, 0.9, 0.99):
            out[f"{name}_p{int(p * 100)}"] = q(x, p)
        out[f"{name}_max"] = float(x.max()) if len(x) else 0.0
    out["overlap_max"] = float(over.max()) if len(over) else 0.0
    out["images"] = len(gaps)
    out["served"] = int(sum(g["served"] for g in gaps))
    out["must"] = int(sum(g.get("must", 0) for g in gaps))
    out["items"] = {"det": det, "miss": miss, "overlap": over}
    return out
