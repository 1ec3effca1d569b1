"""Detection metrics: AP, confusion matrix, fitness (counterpart of
`yolo_series_tpu/eval/metrics.py`, numpy only).

Numerical parity with reference utils/metrics.py (fitness :12, ap_per_class
:18-78, compute_ap :81-110, ConfusionMatrix :113-186) and the per-image
greedy IoU matching of test.py:180-211. Host code on the accumulated
detections; the PR / F1 curves and the confusion matrix are drawn by
`obs/plots`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def fitness(results: np.ndarray) -> np.ndarray:
    """0.1*mAP@.5 + 0.9*mAP@.5:.95 over rows [P, R, mAP50, mAP]."""
    w = np.array([0.0, 0.0, 0.1, 0.9])
    return (results[:, :4] * w).sum(1)


def box_iou_np(a: np.ndarray, b: np.ndarray, eps=1e-7) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter + eps)


def compute_ap(recall, precision, v5_metric=False):
    """AP from one recall/precision curve: monotone precision envelope +
    101-point COCO interpolation; the v7-default sentinel extends recall by
    +0.01 instead of to 1.0 (reference metrics.py:81-110)."""
    if v5_metric:
        mrec = np.concatenate(([0.0], recall, [1.0]))
    else:
        mrec = np.concatenate(([0.0], recall, [recall[-1] + 0.01]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = np.trapezoid(np.interp(x, mrec, mpre), x) if hasattr(np, "trapezoid") \
        else np.trapz(np.interp(x, mrec, mpre), x)
    return ap, mpre, mrec


def ap_per_class(tp, conf, pred_cls, target_cls, v5_metric=False,
                 plot=False, save_dir=".", names=()):
    """Per-class AP over the 10 IoU thresholds.

    tp: (n, 10) bool; conf, pred_cls: (n,); target_cls: (m,).
    Returns (p, r, ap (nc, 10), f1, unique_classes) at the max-F1 operating
    point — same contract as reference metrics.py:18-78.
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]

    unique_classes = np.unique(target_cls)
    nc = unique_classes.shape[0]

    px = np.linspace(0, 1, 1000)
    py = []
    ap = np.zeros((nc, tp.shape[1]))
    p = np.zeros((nc, 1000))
    r = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        i = pred_cls == c
        n_l = (target_cls == c).sum()
        n_p = int(i.sum())
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[i]).cumsum(0)
        tpc = tp[i].cumsum(0)
        recall = tpc / (n_l + 1e-16)
        r[ci] = np.interp(-px, -conf[i], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p[ci] = np.interp(-px, -conf[i], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], mpre, mrec = compute_ap(recall[:, j], precision[:, j],
                                               v5_metric=v5_metric)
            if plot and j == 0:
                py.append(np.interp(px, mrec, mpre))

    f1 = 2 * p * r / (p + r + 1e-16)
    if plot:
        from yolo_series_tpu_torch.obs.plots import plot_mc_curve, plot_pr_curve
        plot_pr_curve(px, py, ap, Path(save_dir) / "PR_curve.png", names)
        plot_mc_curve(px, f1, Path(save_dir) / "F1_curve.png", names, ylabel="F1")
        plot_mc_curve(px, p, Path(save_dir) / "P_curve.png", names, ylabel="Precision")
        plot_mc_curve(px, r, Path(save_dir) / "R_curve.png", names, ylabel="Recall")
    i = f1.mean(0).argmax()
    return p[:, i], r[:, i], ap, f1[:, i], unique_classes.astype(np.int32)


def match_predictions(pred: np.ndarray, labels: np.ndarray,
                      iouv: np.ndarray) -> np.ndarray:
    """Greedy per-class matching of one image's detections to gt boxes.

    pred: (n, 6) [x1, y1, x2, y2, conf, cls] sorted by conf desc (NMS
    output order); labels: (m, 5) [cls, x1, y1, x2, y2] (pixels).
    Returns correct: (n, len(iouv)) bool — reference test.py:180-211.
    """
    correct = np.zeros((len(pred), len(iouv)), dtype=bool)
    if len(pred) == 0 or len(labels) == 0:
        return correct
    detected: set = set()
    tcls = labels[:, 0]
    for c in np.unique(tcls):
        ti = np.nonzero(tcls == c)[0]
        pi = np.nonzero(pred[:, 5] == c)[0]
        if len(pi) == 0:
            continue
        ious_all = box_iou_np(pred[pi, :4], labels[ti, 1:5])
        best_t = ious_all.argmax(1)
        ious = ious_all[np.arange(len(pi)), best_t]
        for j in np.nonzero(ious > iouv[0])[0]:
            d = ti[best_t[j]]
            if d not in detected:
                detected.add(d)
                correct[pi[j]] = ious[j] > iouv
                if len(detected) == len(labels):
                    break
    return correct


class ConfusionMatrix:
    """IoU-matched confusion matrix (reference metrics.py:113-186)."""

    def __init__(self, nc: int, conf=0.25, iou_thres=0.45):
        self.matrix = np.zeros((nc + 1, nc + 1))
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres

    def process_batch(self, detections: np.ndarray, labels: np.ndarray):
        """detections (n, 6) [xyxy, conf, cls]; labels (m, 5) [cls, xyxy]."""
        detections = detections[detections[:, 4] > self.conf]
        gt_classes = labels[:, 0].astype(int)
        dc = detections[:, 5].astype(int)
        iou = box_iou_np(labels[:, 1:], detections[:, :4])

        x = np.nonzero(iou > self.iou_thres)
        if x[0].size:
            matches = np.concatenate(
                (np.stack(x, 1), iou[x[0], x[1]][:, None]), 1)
            if x[0].size > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        else:
            matches = np.zeros((0, 3))

        n = matches.shape[0] > 0
        m0, m1, _ = matches.transpose().astype(int)
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if n and j.sum() == 1:
                self.matrix[dc[m1[j]][0], gc] += 1  # correct
            else:
                self.matrix[self.nc, gc] += 1       # background FN
        if n:
            for i, dcls in enumerate(dc):
                if not (m1 == i).any():
                    self.matrix[dcls, self.nc] += 1  # background FP

    def plot(self, save_dir=".", names=()):
        from yolo_series_tpu_torch.obs.plots import plot_confusion_matrix
        plot_confusion_matrix(self.matrix, self.nc, save_dir, names)

    def print(self):
        for i in range(self.nc + 1):
            print(" ".join(map(str, self.matrix[i])))
