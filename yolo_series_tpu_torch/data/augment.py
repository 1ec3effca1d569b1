"""Host letterbox (counterpart of `letterbox` in
`yolo_series_tpu/data/augment.py`; reference utils/datasets.py:1277-1307).

Pure numpy + cv2, the same semantics line for line. The training
augmentations of that module come with the training slice (ROADMAP queue
1, item 11).
"""

from __future__ import annotations

import cv2
import numpy as np


def letterbox(img: np.ndarray, new_shape=(640, 640), color=(114, 114, 114),
              auto=True, scale_fill=False, scaleup=True, stride=32):
    """Aspect-preserving resize + pad. Returns (img, ratio (rw, rh),
    (dw, dh))."""
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
