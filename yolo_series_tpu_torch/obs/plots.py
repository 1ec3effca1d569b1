"""Plot artifacts (counterpart of `yolo_series_tpu/obs/plots.py`;
reference utils/plots.py): boxes, batch mosaics and keypoint skeletons
(cv2), PR / F1 curves, the confusion matrix, training, study, label and
evolution panels (matplotlib, 'Agg'). The fire-and-forget helpers
tolerate missing data.

matplotlib (and seaborn, optional) is imported inside the functions that
draw with it, never when this module is imported: the serving, eval and
train paths import this module and need no matplotlib to run.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Optional, Sequence

import cv2
import numpy as np


def _pyplot():
    """matplotlib.pyplot on the 'Agg' backend, imported at first use."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def color_list():
    """Deterministic per-class BGR palette."""
    def hex2bgr(h):
        return tuple(int(h[i:i + 2], 16) for i in (4, 2, 0))
    hexs = ("FF3838 FF9D97 FF701F FFB21D CFD231 48F90A 92CC17 3DDB86 1A9334 "
            "00D4BB 2C99A8 00C2FF 344593 6473FF 0018EC 8438FF 520085 CB38FF "
            "FF95C8 FF37C7").split()
    return [hex2bgr(h) for h in hexs]


def plot_one_box(xyxy, img, color=None, label: Optional[str] = None,
                 line_thickness=3):
    """Draw one box + label on a BGR image."""
    tl = line_thickness or round(0.002 * (img.shape[0] + img.shape[1]) / 2) + 1
    color = color or [int(x) for x in np.random.randint(0, 255, 3)]
    c1, c2 = (int(xyxy[0]), int(xyxy[1])), (int(xyxy[2]), int(xyxy[3]))
    cv2.rectangle(img, c1, c2, color, thickness=tl, lineType=cv2.LINE_AA)
    if label:
        tf = max(tl - 1, 1)
        t_size = cv2.getTextSize(label, 0, fontScale=tl / 3, thickness=tf)[0]
        c2 = c1[0] + t_size[0], c1[1] - t_size[1] - 3
        cv2.rectangle(img, c1, c2, color, -1, cv2.LINE_AA)
        cv2.putText(img, label, (c1[0], c1[1] - 2), 0, tl / 3, (225, 255, 255),
                    thickness=tf, lineType=cv2.LINE_AA)
    return img


def plot_images(images: np.ndarray, labels: np.ndarray, mask: np.ndarray,
                paths=None, fname="images.jpg", names=None, max_size=640,
                max_subplots=16):
    """Batch mosaic with boxes (reference plots.py:114-190).

    images: (B, H, W, 3) uint8 RGB; labels: (B, M, 5) normalized cls-xywh.
    """
    bs, h, w = images.shape[:3]
    bs = min(bs, max_subplots)
    ns = int(np.ceil(bs ** 0.5))
    scale = max_size / max(h, w)
    if scale < 1:
        h, w = int(h * scale), int(w * scale)

    colors = color_list()
    mosaic = np.full((ns * h, ns * w, 3), 255, np.uint8)
    for i in range(bs):
        x0, y0 = w * (i % ns), h * (i // ns)
        img = images[i][:, :, ::-1]  # RGB->BGR for cv2 drawing
        if scale < 1:
            img = cv2.resize(img, (w, h))
        img = img.copy()
        lb = labels[i][mask[i]]
        for row in lb:
            cls = int(row[0])
            cx, cy, bw, bh = row[1] * w, row[2] * h, row[3] * w, row[4] * h
            xyxy = (cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2)
            label = names[cls] if names and cls < len(names) else str(cls)
            plot_one_box(xyxy, img, color=colors[cls % len(colors)],
                         label=label, line_thickness=1)
        mosaic[y0:y0 + h, x0:x0 + w] = img
    cv2.imwrite(str(fname), mosaic)
    return mosaic


def plot_pr_curve(px, py, ap, save_dir="pr_curve.png", names=()):
    plt = _pyplot()
    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    py = np.stack(py, axis=1) if len(py) else np.zeros((len(px), 0))
    if 0 < len(names) < 21:
        for i, y in enumerate(py.T):
            ax.plot(px, y, linewidth=1, label=f"{names[i]} {ap[i, 0]:.3f}")
    else:
        ax.plot(px, py, linewidth=1, color="grey")
    if py.shape[1]:
        ax.plot(px, py.mean(1), linewidth=3, color="blue",
                label=f"all classes {ap[:, 0].mean():.3f} mAP@0.5")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    plt.legend(bbox_to_anchor=(1.04, 1), loc="upper left")
    fig.savefig(save_dir, dpi=250)
    plt.close(fig)


def plot_mc_curve(px, py, save_dir="mc_curve.png", names=(), xlabel="Confidence",
                  ylabel="Metric"):
    plt = _pyplot()
    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    if 0 < len(names) < 21:
        for i, y in enumerate(py):
            ax.plot(px, y, linewidth=1, label=f"{names[i]}")
    else:
        ax.plot(px, py.T, linewidth=1, color="grey")
    y = py.mean(0)
    ax.plot(px, y, linewidth=3, color="blue",
            label=f"all classes {y.max():.2f} at {px[y.argmax()]:.3f}")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    plt.legend(bbox_to_anchor=(1.04, 1), loc="upper left")
    fig.savefig(save_dir, dpi=250)
    plt.close(fig)


def plot_confusion_matrix(matrix, nc, save_dir=".", names=()):
    plt = _pyplot()
    array = matrix / (matrix.sum(0).reshape(1, -1) + 1e-6)
    array[array < 0.005] = np.nan
    fig = plt.figure(figsize=(12, 9), tight_layout=True)
    try:
        import seaborn as sn
        sn.heatmap(array, annot=nc < 30, annot_kws={"size": 8}, cmap="Blues",
                   fmt=".2f", square=True,
                   xticklabels=list(names) + ["background FP"] if names else "auto",
                   yticklabels=list(names) + ["background FN"] if names else "auto")
    except Exception:
        plt.imshow(array, cmap="Blues")
        plt.colorbar()
    plt.xlabel("True")
    plt.ylabel("Predicted")
    fig.savefig(Path(save_dir) / "confusion_matrix.png", dpi=250)
    plt.close(fig)


def plot_lr_scheduler(lrs, save_dir="."):
    plt = _pyplot()
    fig = plt.figure()
    plt.plot(lrs)
    plt.xlabel("epoch")
    plt.ylabel("LR")
    fig.savefig(Path(save_dir) / "LR.png", dpi=200)
    plt.close(fig)


def plot_results(results_rows: Sequence[dict], save_dir="."):
    """Training curves from per-epoch metric dicts (reference plots.py:400)."""
    if not results_rows:
        return
    plt = _pyplot()
    keys = [k for k in results_rows[0] if isinstance(results_rows[0][k], (int, float))]
    n = len(keys)
    cols = min(5, n)
    rows = math.ceil(n / cols)
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows),
                             tight_layout=True)
    axes = np.atleast_1d(axes).ravel()
    for i, k in enumerate(keys):
        axes[i].plot([row[k] for row in results_rows], marker=".")
        axes[i].set_title(k, fontsize=10)
    for ax in axes[n:]:
        ax.axis("off")
    fig.savefig(Path(save_dir) / "results.png", dpi=200)
    plt.close(fig)


def plot_study_txt(path=".", x=None, save_dir=None):
    """Speed-vs-mAP curve from study_*.txt sweeps (reference
    plots.py:240-270; rows are the 10-column test() output, columns
    [0-3] = P/R/mAP50/mAP, [7-9] = inference/NMS/total ms per image)."""
    save_dir = Path(save_dir if save_dir is not None else path)
    files = sorted(Path(path).glob("study*.txt"))
    if not files:
        return None
    plt = _pyplot()
    fig, ax = plt.subplots(1, 1, figsize=(8, 4), tight_layout=True)
    for f in files:
        y = np.loadtxt(f, dtype=np.float32, usecols=[0, 1, 2, 3, 7, 8, 9],
                       ndmin=2).T
        j = int(y[3].argmax()) + 1
        ax.plot(y[6, :j], y[3, :j] * 1e2, ".-", linewidth=2, markersize=8,
                label=f.stem.replace("study_", ""))
    ax.grid(alpha=0.2)
    ax.set_xlabel("latency (ms/img)")
    ax.set_ylabel("COCO AP val (%)")
    ax.legend(fontsize=8)
    out = save_dir / "study.png"
    fig.savefig(out, dpi=200)
    plt.close(fig)
    return str(out)


def plot_labels_histogram(labels: np.ndarray, nc: int, save_dir="."):
    """Class/box distribution panels (reference plots.py:272)."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 3, figsize=(12, 4), tight_layout=True)
    axes[0].hist(labels[:, 0], bins=np.arange(nc + 1) - 0.5)
    axes[0].set_title("classes")
    axes[1].scatter(labels[:, 1], labels[:, 2], s=2, alpha=0.3)
    axes[1].set_title("xy centers")
    axes[2].scatter(labels[:, 3], labels[:, 4], s=2, alpha=0.3)
    axes[2].set_title("wh")
    fig.savefig(Path(save_dir) / "labels.png", dpi=200)
    plt.close(fig)


def plot_evolution(evolve_txt, save_dir=".", keys=None):
    """Hyperparameter-evolution scatter panels (reference plots.py:321-342):
    one subplot per hyp, fitness vs value, best point marked. Rows in
    evolve.txt are [P, R, mAP50, mAP, hyp values...] (train/evolve.py)."""
    import matplotlib

    from yolo_series_tpu_torch.eval.metrics import fitness
    from yolo_series_tpu_torch.train.evolve import EVOLVE_META

    plt = _pyplot()

    keys = list(keys or EVOLVE_META.keys())
    x = np.loadtxt(str(evolve_txt), ndmin=2)
    f = fitness(x)
    ncol = 5
    nrow = int(np.ceil(len(keys) / ncol))
    plt.figure(figsize=(10, 2 * nrow), tight_layout=True)
    matplotlib.rc("font", size=8)
    for i, k in enumerate(keys):
        y = x[:, i + 4]
        mu = y[f.argmax()]  # best single result
        plt.subplot(nrow, ncol, i + 1)
        plt.scatter(y, f, c=f, cmap="viridis", alpha=0.8, edgecolors="none")
        plt.plot(mu, f.max(), "k+", markersize=15)
        plt.title(f"{k} = {mu:.3g}", fontdict={"size": 9})
        if i % ncol != 0:
            plt.yticks([])
    out = Path(save_dir) / "evolve.png"
    plt.savefig(out, dpi=200)
    plt.close()
    return out


# COCO-17 keypoint skeleton + colors (reference plots.py:447-490)
_KPT_PALETTE = np.array(
    [[255, 128, 0], [255, 153, 51], [255, 178, 102], [230, 230, 0],
     [255, 153, 255], [153, 204, 255], [255, 102, 255], [255, 51, 255],
     [102, 178, 255], [51, 153, 255], [255, 153, 153], [255, 102, 102],
     [255, 51, 51], [153, 255, 153], [102, 255, 102], [51, 255, 51],
     [0, 255, 0], [0, 0, 255], [255, 0, 0], [255, 255, 255]])
_SKELETON = [[16, 14], [14, 12], [17, 15], [15, 13], [12, 13], [6, 12],
             [7, 13], [6, 7], [6, 8], [7, 9], [8, 10], [9, 11], [2, 3],
             [1, 2], [1, 3], [2, 4], [3, 5], [4, 6], [5, 7]]
_LIMB_COLOR = _KPT_PALETTE[[9, 9, 9, 9, 7, 7, 7, 0, 0, 0, 0, 0, 16, 16, 16,
                            16, 16, 16, 16]]
_KPT_COLOR = _KPT_PALETTE[[16, 16, 16, 16, 16, 0, 0, 0, 0, 0, 0, 9, 9, 9, 9,
                           9, 9]]


def plot_skeleton_kpts(im, kpts, steps=3, conf_thres=0.5):
    """Draw COCO-17 pose keypoints + limb skeleton on a BGR image
    (reference plots.py:447-490). kpts: flat [x, y(, conf)] * 17."""
    num_kpts = len(kpts) // steps
    for kid in range(num_kpts):
        x, y = kpts[steps * kid], kpts[steps * kid + 1]
        if steps == 3 and kpts[steps * kid + 2] < conf_thres:
            continue
        if x <= 0 or y <= 0:
            continue
        r, g, b = _KPT_COLOR[kid % len(_KPT_COLOR)]
        cv2.circle(im, (int(x), int(y)), 5, (int(r), int(g), int(b)), -1)
    for sk_id, sk in enumerate(_SKELETON):
        p1 = (int(kpts[(sk[0] - 1) * steps]), int(kpts[(sk[0] - 1) * steps + 1]))
        p2 = (int(kpts[(sk[1] - 1) * steps]), int(kpts[(sk[1] - 1) * steps + 1]))
        if steps == 3 and (kpts[(sk[0] - 1) * steps + 2] < conf_thres
                           or kpts[(sk[1] - 1) * steps + 2] < conf_thres):
            continue
        if min(p1) <= 0 or min(p2) <= 0:
            continue
        r, g, b = _LIMB_COLOR[sk_id]
        cv2.line(im, p1, p2, (int(r), int(g), int(b)), thickness=2)
    return im


def output_to_target(num, boxes, scores, classes):
    """Fixed-shape NMS outputs -> plottable target rows
    [batch_id, cls, cx, cy, w, h, conf] (reference plots.py
    output_to_target)."""
    rows = []
    for b in range(len(num)):
        n = int(num[b])
        for i in range(n):
            x1, y1, x2, y2 = np.asarray(boxes[b][i], np.float64)
            rows.append([b, int(classes[b][i]), (x1 + x2) / 2, (y1 + y2) / 2,
                         x2 - x1, y2 - y1, float(scores[b][i])])
    return np.array(rows, np.float64).reshape(-1, 7)


def output_to_keypoint(num, boxes, scores, classes, kpts):
    """Keypoint NMS outputs -> rows [batch_id, cls, cx, cy, w, h, conf,
    kpts...] (reference plots.py output_to_keypoint)."""
    rows = []
    for b in range(len(num)):
        n = int(num[b])
        for i in range(n):
            x1, y1, x2, y2 = np.asarray(boxes[b][i], np.float64)
            rows.append([b, int(classes[b][i]), (x1 + x2) / 2, (y1 + y2) / 2,
                         x2 - x1, y2 - y1, float(scores[b][i]),
                         *np.asarray(kpts[b][i], np.float64)])
    return np.array(rows, np.float64)
