"""Host-side image augmentation (counterpart of
`yolo_series_tpu/data/augment.py`; reference utils/datasets.py:959-1533):
letterbox, HSV jitter, mosaic-4/9, mixup, random_perspective,
copy-paste/paste-in, cutout, hist-equalize and replicate. Pure numpy + cv2,
the same operations in the same order as the JAX module.

Every random draw comes from the `rng` the caller passes: an object with
the `random.Random` interface (the dataset's own generator), or for
`mixup`'s Beta draw a numpy generator (`np.random.RandomState` or
`Generator`). Given the same seeded generators, each function draws the
same numbers in the same order as its JAX counterpart does from the global
`random` and `np.random`, so both give the same pixels and labels. Without
one, a function draws from a fresh unseeded generator.

All functions take/return uint8 HWC BGR images (cv2 convention) and label
arrays (n, 5) [cls, x1, y1, x2, y2] in PIXEL xyxy unless stated otherwise.
"""

from __future__ import annotations

import math
import random
from typing import List, Optional, Sequence, Tuple

import cv2
import numpy as np


def letterbox(img: np.ndarray, new_shape=(640, 640), color=(114, 114, 114),
              auto=True, scale_fill=False, scaleup=True, stride=32):
    """Aspect-preserving resize + pad (reference utils/datasets.py:1277-1307).
    Returns (img, ratio (rw, rh), (dw, dh))."""
    shape = img.shape[:2]  # h, w
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)

    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:  # only downscale (keeps test mAP up, datasets.py:1288)
        r = min(r, 1.0)

    ratio = (r, r)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    if auto:  # pad to a stride multiple only
        dw, dh = dw % stride, dh % stride
    elif scale_fill:  # stretch exactly
        dw, dh = 0.0, 0.0
        new_unpad = (new_shape[1], new_shape[0])
        ratio = (new_shape[1] / shape[1], new_shape[0] / shape[0])

    dw /= 2
    dh /= 2

    if shape[::-1] != new_unpad:
        img = cv2.resize(img, new_unpad, interpolation=cv2.INTER_LINEAR)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    img = cv2.copyMakeBorder(img, top, bottom, left, right,
                             cv2.BORDER_CONSTANT, value=color)
    return img, ratio, (dw, dh)


def augment_hsv(img, hgain=0.015, sgain=0.7, vgain=0.4, rng=None):
    """In-place LUT-based HSV jitter (reference datasets.py:976-987)."""
    rng = rng or random.Random()
    r = np.array([rng.uniform(-1, 1) for _ in range(3)]) * [hgain, sgain, vgain] + 1
    x = np.arange(0, 256, dtype=np.int16)
    # one 3-channel LUT == the reference's split + per-channel LUTs +
    # merge, applied in a single pass (~5% of the host aug budget)
    lut = np.stack([((x * r[0]) % 180).astype(np.uint8),
                    np.clip(x * r[1], 0, 255).astype(np.uint8),
                    np.clip(x * r[2], 0, 255).astype(np.uint8)],
                   axis=-1).reshape(256, 1, 3)
    img_hsv = cv2.LUT(cv2.cvtColor(img, cv2.COLOR_BGR2HSV), lut)
    cv2.cvtColor(img_hsv, cv2.COLOR_HSV2BGR, dst=img)
    return img


def hist_equalize(img, clahe=True, bgr=True):
    """Equalize luminance (reference datasets.py:990-998)."""
    yuv = cv2.cvtColor(img, cv2.COLOR_BGR2YUV if bgr else cv2.COLOR_RGB2YUV)
    if clahe:
        c = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
        yuv[:, :, 0] = c.apply(yuv[:, :, 0])
    else:
        yuv[:, :, 0] = cv2.equalizeHist(yuv[:, :, 0])
    return cv2.cvtColor(yuv, cv2.COLOR_YUV2BGR if bgr else cv2.COLOR_YUV2RGB)


def box_candidates(box1, box2, wh_thr=2, ar_thr=20, area_thr=0.1, eps=1e-16):
    """Keep transformed boxes that stay plausible (reference
    datasets.py:1399-1404): min size, aspect, area-retention filters.
    box1/box2: (4, n) xyxy before/after."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return ((w2 > wh_thr) & (h2 > wh_thr)
            & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr))


def random_perspective(img, targets=(), segments=(), degrees=10, translate=.1,
                       scale=.1, shear=10, perspective=0.0,
                       border=(0, 0), rng=None):
    """Combined center/perspective/rotation/scale/shear/translate warp
    (reference datasets.py:1310-1396). targets: (n, 5) [cls, xyxy]."""
    rng = rng or random.Random()
    height = img.shape[0] + border[0] * 2
    width = img.shape[1] + border[1] * 2

    C = np.eye(3)
    C[0, 2] = -img.shape[1] / 2
    C[1, 2] = -img.shape[0] / 2

    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)

    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    # upper bound is 1.1 + scale, NOT 1 + scale — an upstream quirk the
    # training-data distribution depends on (datasets.py:1332)
    s = rng.uniform(1 - scale, 1.1 + scale)
    R[:2] = cv2.getRotationMatrix2D(angle=a, center=(0, 0), scale=s)

    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)

    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * width
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * height

    M = T @ S @ R @ P @ C
    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        if perspective:
            img = cv2.warpPerspective(img, M, dsize=(width, height),
                                      borderValue=(114, 114, 114))
        else:
            img = cv2.warpAffine(img, M[:2], dsize=(width, height),
                                 borderValue=(114, 114, 114))

    n = len(targets)
    if n:
        use_segments = any(len(x) for x in segments)
        new = np.zeros((n, 4))
        if use_segments:
            for i, seg in enumerate(segments):
                xy = np.ones((len(seg), 3))
                xy[:, :2] = seg
                xy = xy @ M.T
                xy = (xy[:, :2] / xy[:, 2:3]) if perspective else xy[:, :2]
                x, y = xy[:, 0], xy[:, 1]
                new[i] = [x.min(), y.min(), x.max(), y.max()]
        else:
            xy = np.ones((n * 4, 3))
            xy[:, :2] = targets[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)
            xy = xy @ M.T
            xy = (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]).reshape(n, 8)
            x = xy[:, [0, 2, 4, 6]]
            y = xy[:, [1, 3, 5, 7]]
            new = np.concatenate(
                (x.min(1), y.min(1), x.max(1), y.max(1))).reshape(4, n).T
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
        keep = box_candidates(box1=targets[:, 1:5].T * s, box2=new.T,
                              area_thr=0.01 if use_segments else 0.10)
        targets = targets[keep]
        targets[:, 1:5] = new[keep]
    return img, targets


def mosaic4(images: Sequence[np.ndarray], labels: Sequence[np.ndarray],
            img_size: int, rng=None) -> Tuple[np.ndarray, np.ndarray]:
    """4-image mosaic on a 2s x 2s canvas (reference datasets.py:1001-1064).

    labels: per-image (n, 5) [cls, x1, y1, x2, y2] pixel coords in the
    source image. Returns (canvas, labels4 pixel-xyxy on canvas).
    """
    rng = rng or random.Random()
    s = img_size
    yc = int(rng.uniform(s // 2, 2 * s - s // 2))
    xc = int(rng.uniform(s // 2, 2 * s - s // 2))
    canvas = np.full((s * 2, s * 2, 3), 114, dtype=np.uint8)
    out_labels = []
    for i in range(4):
        img = images[i]
        h, w = img.shape[:2]
        if i == 0:    # top left
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
        elif i == 1:  # top right
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
            x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
        elif i == 2:  # bottom left
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
            x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
        else:         # bottom right
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)
            x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
        canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        padw, padh = x1a - x1b, y1a - y1b
        if len(labels[i]):
            lb = labels[i].copy()
            lb[:, [1, 3]] += padw
            lb[:, [2, 4]] += padh
            out_labels.append(lb)
    if out_labels:
        lb4 = np.concatenate(out_labels, 0)
        lb4[:, 1:5] = lb4[:, 1:5].clip(0, 2 * s)
    else:
        lb4 = np.zeros((0, 5), np.float32)
    return canvas, lb4


def mosaic9(images: Sequence[np.ndarray], labels: Sequence[np.ndarray],
            img_size: int, rng=None) -> Tuple[np.ndarray, np.ndarray]:
    """9-image mosaic on a 3s x 3s canvas cropped to 2s x 2s
    (reference datasets.py:1066-1133)."""
    rng = rng or random.Random()
    s = img_size
    canvas = np.full((s * 3, s * 3, 3), 114, dtype=np.uint8)
    out_labels = []
    hp = wp = -1
    for i in range(9):
        img = images[i]
        h, w = img.shape[:2]
        if i == 0:
            c = s, s, s + w, s + h
        elif i == 1:
            c = s, s - h, s + w, s
        elif i == 2:
            c = s + wp, s - h, s + wp + w, s
        elif i == 3:
            c = s + w0, s, s + w0 + w, s + h
        elif i == 4:
            c = s + w0, s + hp, s + w0 + w, s + hp + h
        elif i == 5:
            c = s + w0 - w, s + hp, s + w0, s + hp + h
        elif i == 6:
            c = s + w0 - wp - w, s + hp, s + w0 - wp, s + hp + h
        elif i == 7:
            c = s - w, s + h0 - h, s, s + h0
        else:
            c = s - w, s + h0 - hp - h, s, s + h0 - hp
        padx, pady = c[:2]
        x1, y1, x2, y2 = [max(x, 0) for x in c]
        if len(labels[i]):
            lb = labels[i].copy()
            lb[:, [1, 3]] += padx
            lb[:, [2, 4]] += pady
            out_labels.append(lb)
        canvas[y1:y2, x1:x2] = img[y1 - pady:, x1 - padx:][: y2 - y1, : x2 - x1]
        hp, wp = h, w
        if i == 0:
            h0, w0 = h, w
    yc = int(rng.uniform(0, s))
    xc = int(rng.uniform(0, s))
    canvas = canvas[yc:yc + 2 * s, xc:xc + 2 * s]
    if out_labels:
        lb9 = np.concatenate(out_labels, 0)
        lb9[:, [1, 3]] -= xc
        lb9[:, [2, 4]] -= yc
        lb9[:, 1:5] = lb9[:, 1:5].clip(0, 2 * s)
    else:
        lb9 = np.zeros((0, 5), np.float32)
    return canvas, lb9


def mixup(img1, labels1, img2, labels2, rng=None):
    """Beta(8,8) image blend + label concat (reference datasets.py:840-847).
    rng: a numpy generator (the JAX function draws from `np.random`)."""
    rng = np.random.default_rng() if rng is None else rng
    r = rng.beta(8.0, 8.0)
    img = (img1 * r + img2 * (1 - r)).astype(np.uint8)
    return img, np.concatenate([labels1, labels2], 0)


def bbox_ioa_np(box1, box2, eps=1e-7):
    """Intersection over box2 area, numpy (reference datasets.py:1407-1423)."""
    b2 = box2.T
    inter = (np.minimum(box1[2], b2[2]) - np.maximum(box1[0], b2[0])).clip(0) * \
            (np.minimum(box1[3], b2[3]) - np.maximum(box1[1], b2[1])).clip(0)
    area2 = (b2[2] - b2[0]) * (b2[3] - b2[1]) + eps
    return inter / area2


def cutout(img, labels, rng=None):
    """Random occlusion squares; drop labels >60% covered
    (reference datasets.py:1426-1451)."""
    rng = rng or random.Random()
    h, w = img.shape[:2]
    scales = [0.5] * 1 + [0.25] * 2 + [0.125] * 4 + [0.0625] * 8 + [0.03125] * 16
    for s in scales:
        mask_h = rng.randint(1, int(h * s))
        mask_w = rng.randint(1, int(w * s))
        xmin = max(0, rng.randint(0, w) - mask_w // 2)
        ymin = max(0, rng.randint(0, h) - mask_h // 2)
        xmax = min(w, xmin + mask_w)
        ymax = min(h, ymin + mask_h)
        img[ymin:ymax, xmin:xmax] = [rng.randint(64, 191) for _ in range(3)]
        if len(labels) and s > 0.03:
            box = np.array([xmin, ymin, xmax, ymax], dtype=np.float32)
            ioa = bbox_ioa_np(box, labels[:, 1:5])
            labels = labels[ioa < 0.60]
    return img, labels


def copy_paste(img, labels, segments, p=0.0, rng=None):
    """Flip-paste segmented instances (reference datasets.py:1187-1208)."""
    rng = rng or random.Random()
    n = len(segments)
    if p and n:
        h, w, _ = img.shape
        im_new = np.zeros(img.shape, np.uint8)
        for j in rng.sample(range(n), k=round(p * n)):
            lb, seg = labels[j], segments[j]
            box = w - lb[3], lb[2], w - lb[1], lb[4]
            ioa = bbox_ioa_np(np.array(box, np.float32), labels[:, 1:5])
            if (ioa < 0.30).all():
                labels = np.concatenate(
                    (labels, [[lb[0], *box]]), 0)
                segments.append(np.concatenate(
                    (w - seg[:, 0:1], seg[:, 1:2]), 1))
                cv2.drawContours(im_new, [segments[-1].astype(np.int32)], -1,
                                 (255, 255, 255), cv2.FILLED)
        result = cv2.bitwise_and(src1=img, src2=im_new)
        result = cv2.flip(result, 1)
        i = result > 0
        img[i] = result[i]
    return img, labels, segments


def pastein(img, labels, samples, rng=None):
    """Paste pre-cut object crops at random scales (the reference's
    `paste_in` augmentation, datasets.py:1454-1509).

    samples: list of (cls, crop_bgr, binary_mask) from segment sampling.
    """
    rng = rng or random.Random()
    h, w = img.shape[:2]
    scales = [0.75] * 2 + [0.5] * 4 + [0.25] * 4 + [0.125] * 4 + [0.0625] * 6
    for s in scales:
        if rng.random() < 0.2:
            continue
        mask_h = rng.randint(1, int(h * s))
        mask_w = rng.randint(1, int(w * s))
        xmin = max(0, rng.randint(0, w) - mask_w // 2)
        ymin = max(0, rng.randint(0, h) - mask_h // 2)
        xmax = min(w, xmin + mask_w)
        ymax = min(h, ymin + mask_h)
        box = np.array([xmin, ymin, xmax, ymax], dtype=np.float32)
        ioa = bbox_ioa_np(box, labels[:, 1:5]) if len(labels) else np.zeros(1)
        if ((ioa < 0.30).all() and len(samples)
                and (xmax > xmin + 20) and (ymax > ymin + 20)):
            sel = rng.randint(0, len(samples) - 1)
            cls_s, crop, mask_s = samples[sel]
            hs, ws = crop.shape[:2]
            r_scale = min((ymax - ymin) / hs, (xmax - xmin) / ws)
            r_w, r_h = int(ws * r_scale), int(hs * r_scale)
            if (r_w > 10) and (r_h > 10):
                r_mask = cv2.resize(mask_s, (r_w, r_h))
                r_image = cv2.resize(crop, (r_w, r_h))
                temp_crop = img[ymin:ymin + r_h, xmin:xmin + r_w]
                m_ind = r_mask > 0
                if m_ind.astype(np.int32).sum() > 60:
                    temp_crop[m_ind] = r_image[m_ind]
                    box = np.array([xmin, ymin, xmin + r_w, ymin + r_h],
                                   dtype=np.float32)
                    row = np.array([[float(cls_s), *box]], dtype=np.float32)
                    labels = np.concatenate((labels, row), 0) if len(labels) else row
                    img[ymin:ymin + r_h, xmin:xmin + r_w] = temp_crop
    return img, labels


def replicate(img, labels, rng=None):
    """Duplicate the smallest-half boxes at random offsets
    (reference datasets.py:1260-1274)."""
    rng = rng or random.Random()
    h, w = img.shape[:2]
    boxes = labels[:, 1:5].astype(int)
    x1, y1, x2, y2 = boxes.T
    s = ((x2 - x1) + (y2 - y1)) / 2
    for i in s.argsort()[: round(s.size * 0.5)]:
        x1b, y1b, x2b, y2b = boxes[i]
        bh, bw = y2b - y1b, x2b - x1b
        yc = rng.randint(0, h - bh - 1) if h - bh - 1 > 0 else 0
        xc = rng.randint(0, w - bw - 1) if w - bw - 1 > 0 else 0
        x1a, y1a, x2a, y2a = [xc, yc, xc + bw, yc + bh]
        img[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        labels = np.append(labels, [[labels[i, 0], x1a, y1a, x2a, y2a]], axis=0)
    return img, labels
