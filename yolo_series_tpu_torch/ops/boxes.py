"""Box geometry (counterpart of `yolo_series_tpu/ops/boxes.py`).

Same formulas as the JAX functions (reference utils/general.py:275 and
:464); every function broadcasts over leading dims.
"""

from __future__ import annotations

import torch


def xywh2xyxy(x):
    """(..., 4) center-xywh -> corner-xyxy."""
    xy = x[..., 0:2]
    wh = x[..., 2:4] * 0.5
    return torch.cat([xy - wh, xy + wh], dim=-1)


def box_area(box):
    """(..., 4) xyxy -> (...) area."""
    return (box[..., 2] - box[..., 0]) * (box[..., 3] - box[..., 1])


def box_iou(box1, box2, eps=1e-7):
    """Pairwise IoU of xyxy boxes: (..., N, 4) x (..., M, 4) -> (..., N, M),
    inter / (area1 + area2 - inter + eps) with hard-zero clamped overlap.
    The NMS keep-mask kernel (csrc/nms_keep.cu) rounds each operation in
    this order, so its threshold decisions match this function exactly."""
    lt = torch.maximum(box1[..., :, None, 0:2], box2[..., None, :, 0:2])
    rb = torch.minimum(box1[..., :, None, 2:4], box2[..., None, :, 2:4])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(box1)[..., :, None] + box_area(box2)[..., None, :] - inter
    return inter / (union + eps)
