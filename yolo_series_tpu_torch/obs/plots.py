"""Box drawing (counterpart of `color_list` and `plot_one_box` in
`yolo_series_tpu/obs/plots.py`; reference utils/plots.py:57-73).

Only what `infer/detector.draw_detections` needs. The batch mosaics,
PR / F1 curves, confusion-matrix and training plots are ROADMAP queue 1,
item 19.
"""

from __future__ import annotations

from typing import Optional

import cv2
import numpy as np


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
