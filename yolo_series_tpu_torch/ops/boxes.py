"""Box geometry (counterpart of `yolo_series_tpu/ops/boxes.py`).

Same formulas as the JAX functions (reference utils/general.py:265-563),
with the same epsilon placement; every function broadcasts over leading
dims.
"""

from __future__ import annotations

import math

import torch


def xywh2xyxy(x):
    """(..., 4) center-xywh -> corner-xyxy."""
    xy = x[..., 0:2]
    wh = x[..., 2:4] * 0.5
    return torch.cat([xy - wh, xy + wh], dim=-1)


def xyxy2xywh(x):
    """(..., 4) corner-xyxy -> center-xywh."""
    lo = x[..., 0:2]
    hi = x[..., 2:4]
    return torch.cat([(lo + hi) * 0.5, hi - lo], dim=-1)


def xywhn2xyxy(x, w=640, h=640, padw=0, padh=0):
    """Normalized center-xywh -> pixel corner-xyxy with a pad offset."""
    scale = torch.tensor([w, h, w, h], dtype=x.dtype, device=x.device)
    pad = torch.tensor([padw, padh, padw, padh], dtype=x.dtype, device=x.device)
    return xywh2xyxy(x) * scale + pad


def xyn2xy(x, w=640, h=640, padw=0, padh=0):
    """Normalized (..., 2) points -> pixel coords with a pad offset."""
    scale = torch.tensor([w, h], dtype=x.dtype, device=x.device)
    pad = torch.tensor([padw, padh], dtype=x.dtype, device=x.device)
    return x * scale + pad


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


def wh_iou(wh1, wh2, eps=1e-7):
    """Pairwise IoU of implicitly centred wh boxes: (N, 2) x (M, 2) -> (N, M)."""
    inter = torch.minimum(wh1[:, None, :], wh2[None, :, :]).prod(-1)
    union = wh1.prod(-1)[:, None] + wh2.prod(-1)[None, :] - inter
    return inter / (union + eps)


def bbox_ioa(box1, box2, eps=1e-7):
    """Intersection over box2's area: (4,) xyxy x (N, 4) xyxy -> (N,)."""
    lt = torch.maximum(box1[0:2], box2[..., 0:2])
    rb = torch.minimum(box1[2:4], box2[..., 2:4])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (box_area(box2) + eps)


def _clip0(x):
    """max(x, 0) whose gradient at x == 0 is split in half, as `jnp.clip`'s
    (torch.clamp passes all of it)."""
    return torch.maximum(x, torch.zeros_like(x))


def bbox_iou(box1, box2, xywh=False, giou=False, diou=False, ciou=False, eps=1e-7):
    """Elementwise IoU / GIoU / DIoU / CIoU of aligned (..., 4) boxes, which
    broadcast against each other; xywh=True: centre-format inputs. CIoU's
    aspect weight alpha is a constant to the gradient (detached, as
    `lax.stop_gradient` in the JAX package and `torch.no_grad` in the
    reference, general.py:400-402)."""
    b1, b2 = (xywh2xyxy(box1), xywh2xyxy(box2)) if xywh else (box1, box2)

    inter_w = _clip0(torch.minimum(b1[..., 2], b2[..., 2])
                     - torch.maximum(b1[..., 0], b2[..., 0]))
    inter_h = _clip0(torch.minimum(b1[..., 3], b2[..., 3])
                     - torch.maximum(b1[..., 1], b2[..., 1]))
    inter = inter_w * inter_h

    w1 = b1[..., 2] - b1[..., 0]
    h1 = b1[..., 3] - b1[..., 1] + eps
    w2 = b2[..., 2] - b2[..., 0]
    h2 = b2[..., 3] - b2[..., 1] + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union

    if not (giou or diou or ciou):
        return iou

    cw = torch.maximum(b1[..., 2], b2[..., 2]) - torch.minimum(b1[..., 0], b2[..., 0])
    ch = torch.maximum(b1[..., 3], b2[..., 3]) - torch.minimum(b1[..., 1], b2[..., 1])
    if ciou or diou:
        c2 = cw ** 2 + ch ** 2 + eps
        rho2 = ((b2[..., 0] + b2[..., 2] - b1[..., 0] - b1[..., 2]) ** 2
                + (b2[..., 1] + b2[..., 3] - b1[..., 1] - b1[..., 3]) ** 2) / 4.0
        if diou:
            return iou - rho2 / c2
        v = (4.0 / math.pi ** 2) * (torch.atan(w2 / (h2 + eps))
                                    - torch.atan(w1 / (h1 + eps))) ** 2
        # the v == 0, iou ~ 1 corner, where fp32 rounding makes the
        # denominator 0, gives alpha 0 (as the JAX package)
        denom = v - iou + (1.0 + eps)
        pos = v > 0.0
        alpha = torch.where(pos, v / torch.where(pos, denom, torch.ones_like(denom)),
                            torch.zeros_like(v)).detach()
        return iou - (rho2 / c2 + v * alpha)
    c_area = cw * ch + eps
    return iou - (c_area - union) / c_area


def scale_coords(img1_shape, coords, img0_shape, ratio_pad=None):
    """Rescale xyxy coords from the letterboxed img1_shape (h, w) back to
    img0_shape, clipped to its bounds (reference general.py:545-563).
    `eval/evaluator.scale_coords_np` is the host (numpy) form."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad = ((img1_shape[1] - img0_shape[1] * gain) / 2,
               (img1_shape[0] - img0_shape[0] * gain) / 2)
    else:
        gain = ratio_pad[0][0]
        pad = ratio_pad[1]
    pad4 = torch.tensor([pad[0], pad[1], pad[0], pad[1]], dtype=coords.dtype,
                        device=coords.device)
    return clip_coords((coords - pad4) / gain, img0_shape)


def clip_coords(boxes, img_shape):
    """Clip xyxy boxes to (h, w) image bounds."""
    h, w = img_shape[0], img_shape[1]
    lim = torch.tensor([w, h, w, h], dtype=boxes.dtype, device=boxes.device)
    return torch.minimum(torch.clamp(boxes, min=0.0), lim)
