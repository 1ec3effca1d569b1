"""COCO-protocol mAP evaluation in pure numpy (counterpart of
`yolo_series_tpu/eval/coco_eval.py`, line for line).

pycocotools is a C extension the reference uses for its second accuracy
path (test.py:256-278); this module re-implements the COCOeval bbox
protocol instead:

  * 10 IoU thresholds 0.50:0.05:0.95, 101-point recall interpolation
  * greedy per-category matching in descending score order, honoring
    `iscrowd` gts (match allowed but excluded from counts) and area-range
    ignore rules
  * area ranges all/small/medium/large, maxDets (1, 10, 100)
  * summary metrics AP, AP50, AP75, APs, APm, APl, AR1, AR10, AR100,
    ARs, ARm, ARl

API mirrors the loadRes/evaluate/accumulate/summarize flow, so the json
dump of `eval/evaluator.evaluate(save_json=...)` plugs straight in.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray):
    """IoU between xywh det and gt boxes; crowd gts use IoA (pycocotools
    semantics: union = det area for crowd)."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    iw = np.clip(np.minimum(dx2[:, None], gx2[None]) -
                 np.maximum(dx1[:, None], gx1[None]), 0, None)
    ih = np.clip(np.minimum(dy2[:, None], gy2[None]) -
                 np.maximum(dy1[:, None], gy1[None]), 0, None)
    inter = iw * ih
    d_area = (dets[:, 2] * dets[:, 3])[:, None]
    g_area = (gts[:, 2] * gts[:, 3])[None, :]
    union = np.where(iscrowd[None, :], d_area,
                     d_area + g_area - inter)
    return inter / np.maximum(union, 1e-10)


class COCOEvaluator:
    """gt: COCO-format dict or path; results: list of detection dicts
    (image_id, category_id, bbox xywh, score) or path."""

    def __init__(self, gt, results):
        if isinstance(gt, str):
            with open(gt) as f:
                gt = json.load(f)
        if isinstance(results, str):
            with open(results) as f:
                results = json.load(f)
        self.cat_ids = sorted({a["category_id"] for a in gt["annotations"]}) \
            or sorted(c["id"] for c in gt.get("categories", []))
        self.img_ids = sorted({im["id"] for im in gt["images"]}) if "images" in gt \
            else sorted({a["image_id"] for a in gt["annotations"]})

        self.gts = defaultdict(list)
        for a in gt["annotations"]:
            self.gts[(a["image_id"], a["category_id"])].append(a)
        self.dts = defaultdict(list)
        for d in results:
            self.dts[(d["image_id"], d["category_id"])].append(d)

    def _evaluate_img(self, img_id, cat_id, area_rng, max_det):
        gts = self.gts.get((img_id, cat_id), [])
        dts = self.dts.get((img_id, cat_id), [])
        if not gts and not dts:
            return None
        g_ignore = np.array(
            [bool(g.get("iscrowd", 0)) or g.get("ignore", 0)
             or not (area_rng[0] <= g.get("area", g["bbox"][2] * g["bbox"][3])
                     <= area_rng[1]) for g in gts], bool)
        # sort gts: unignored first (pycocotools order)
        g_order = np.argsort(g_ignore, kind="stable")
        gts = [gts[i] for i in g_order]
        g_ignore = g_ignore[g_order]
        iscrowd = np.array([bool(g.get("iscrowd", 0)) for g in gts], bool)

        d_order = np.argsort([-d["score"] for d in dts], kind="stable")[:max_det]
        dts = [dts[i] for i in d_order]

        g_boxes = np.array([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
        d_boxes = np.array([d["bbox"] for d in dts], np.float64).reshape(-1, 4)
        ious = _iou_xywh(d_boxes, g_boxes, iscrowd)

        T = len(IOU_THRS)
        D, G = len(dts), len(gts)
        dt_m = np.zeros((T, D), np.int64) - 1
        gt_m = np.zeros((T, G), np.int64) - 1
        dt_ig = np.zeros((T, D), bool)
        for t, thr in enumerate(IOU_THRS):
            for d in range(D):
                best_iou = min(thr, 1 - 1e-10)
                best_g = -1
                for g in range(G):
                    if gt_m[t, g] >= 0 and not iscrowd[g]:
                        continue
                    # stop at ignored gts once a real match exists
                    if best_g > -1 and not g_ignore[best_g] and g_ignore[g]:
                        break
                    if ious[d, g] < best_iou:
                        continue
                    best_iou = ious[d, g]
                    best_g = g
                if best_g == -1:
                    continue
                dt_ig[t, d] = g_ignore[best_g]
                dt_m[t, d] = best_g
                gt_m[t, best_g] = d
        # unmatched dets outside the area range are ignored
        d_area = d_boxes[:, 2] * d_boxes[:, 3]
        d_out = (d_area < area_rng[0]) | (d_area > area_rng[1])
        dt_ig = dt_ig | ((dt_m == -1) & d_out[None, :])
        return {
            "dt_scores": np.array([d["score"] for d in dts]),
            "dt_m": dt_m, "dt_ig": dt_ig,
            "n_gt": int((~g_ignore).sum()),
        }

    def accumulate(self) -> Dict[str, np.ndarray]:
        T = len(IOU_THRS)
        R = len(REC_THRS)
        K = len(self.cat_ids)
        A = len(AREA_RNG)
        M = len(MAX_DETS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        for k, cat in enumerate(self.cat_ids):
            for a, (aname, arng) in enumerate(AREA_RNG.items()):
                for m, max_det in enumerate(MAX_DETS):
                    evals = [self._evaluate_img(i, cat, arng, max_det)
                             for i in self.img_ids]
                    evals = [e for e in evals if e is not None]
                    if not evals:
                        continue
                    scores = np.concatenate([e["dt_scores"] for e in evals])
                    order = np.argsort(-scores, kind="mergesort")
                    dt_m = np.concatenate([e["dt_m"] for e in evals], 1)[:, order]
                    dt_ig = np.concatenate([e["dt_ig"] for e in evals], 1)[:, order]
                    n_gt = sum(e["n_gt"] for e in evals)
                    if n_gt == 0:
                        continue
                    tps = (dt_m >= 0) & ~dt_ig
                    fps = (dt_m == -1) & ~dt_ig
                    tp_sum = tps.cumsum(1).astype(float)
                    fp_sum = fps.cumsum(1).astype(float)
                    for t in range(T):
                        tp, fp = tp_sum[t], fp_sum[t]
                        rc = tp / n_gt
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[t, k, a, m] = rc[-1] if len(rc) else 0
                        # precision envelope
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(R)
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[t, :, k, a, m] = q
        self.eval = {"precision": precision, "recall": recall}
        return self.eval

    def summarize(self, verbose=True) -> Dict[str, float]:
        if not hasattr(self, "eval"):
            self.accumulate()
        p = self.eval["precision"]
        r = self.eval["recall"]

        def _ap(iou=None, area="all", max_det=100):
            a = list(AREA_RNG).index(area)
            m = MAX_DETS.index(max_det)
            s = p[:, :, :, a, m]
            if iou is not None:
                s = s[[int(np.where(np.isclose(IOU_THRS, iou))[0][0])]]
            s = s[s > -1]
            return float(s.mean()) if s.size else -1.0

        def _ar(area="all", max_det=100):
            a = list(AREA_RNG).index(area)
            m = MAX_DETS.index(max_det)
            s = r[:, :, a, m]
            s = s[s > -1]
            return float(s.mean()) if s.size else -1.0

        out = {
            "AP": _ap(), "AP50": _ap(iou=0.5), "AP75": _ap(iou=0.75),
            "APs": _ap(area="small"), "APm": _ap(area="medium"),
            "APl": _ap(area="large"),
            "AR1": _ar(max_det=1), "AR10": _ar(max_det=10), "AR100": _ar(),
            "ARs": _ar(area="small"), "ARm": _ar(area="medium"),
            "ARl": _ar(area="large"),
        }
        if verbose:
            for k, v in out.items():
                print(f"{k:>6s} = {v:.4f}")
        return out
