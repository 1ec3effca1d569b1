"""Test-time augmentation and model ensembles (counterpart of
`yolo_series_tpu/models/tta.py`).

TTA is the reference Model.forward(augment=True) (models/yolo.py:581-599):
scales (1, 0.83, 0.67) x flips (none, left-right, none); each pass's
predictions are de-scaled and de-flipped, then all are concatenated along
the anchor axis. The ensemble is the reference Ensemble's "nms" mode
(models/experimental.py:69-81): the models' predictions concatenated
before NMS.

The resize is JAX's `jax.image.resize(..., "bilinear", antialias=False)`
(`data/device_aug.resize_bilinear`: the same fp32 weight matrices, so the
scaled inputs agree with the JAX function's to float rounding), the pad
value 0.447, the sizes JAX's Python float arithmetic.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F

from yolo_series_tpu_torch.data.device_aug import resize_bilinear
from yolo_series_tpu_torch.models.model import apply_model

TTA_SCALES = (1.0, 0.83, 0.67)
TTA_FLIPS = (None, 2, None)   # axis 2: the width flip of NHWC


def _scale_img(x: torch.Tensor, ratio: float, gs: int = 32) -> torch.Tensor:
    """Resize by `ratio` and pad up to a stride multiple (reference
    torch_utils.scale_img), on (B, H, W, C) float."""
    if ratio == 1.0:
        return x
    b, h, w, c = x.shape
    nh, nw = int(h * ratio), int(w * ratio)
    x = resize_bilinear(x, (nh, nw))
    # the pad target is ceil(h * ratio / gs) * gs of the fractional scaled
    # size (torch_utils.scale_img's math.ceil; flooring 128.64 to 128 in
    # place of 160 would change the anchor count)
    ph = math.ceil(h * ratio / gs) * gs
    pw = math.ceil(w * ratio / gs) * gs
    return F.pad(x, (0, 0, 0, pw - nw, 0, ph - nh), value=0.447)


def apply_model_tta(plan, params, state, x: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Augmented inference on (B, H, W, 3) float in [0, 1]: the decoded
    predictions of the three passes, concatenated (B, A1 + A2 + A3, no)."""
    b, h, w, _ = x.shape
    preds: List[torch.Tensor] = []
    for scale, flip in zip(TTA_SCALES, TTA_FLIPS):
        xi = _scale_img(torch.flip(x, [flip]) if flip else x, scale)
        y = apply_model(plan, params, state, xi, dtype=dtype)[0]["pred"]
        # the scale in the predictions' dtype first, as JAX's weak-typed
        # Python float
        sc = torch.tensor(scale, dtype=y.dtype, device=y.device)
        xy = y[..., 0:2] / sc
        wh = y[..., 2:4] / sc
        if flip == 2:
            xy = torch.cat([w - xy[..., 0:1], xy[..., 1:2]], dim=-1)
        elif flip == 1:
            xy = torch.cat([xy[..., 0:1], h - xy[..., 1:2]], dim=-1)
        preds.append(torch.cat([xy, wh, y[..., 4:]], dim=-1))
    return torch.cat(preds, dim=1)


def apply_ensemble(plans_params_states: Sequence, x: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Several models on the same input, their predictions concatenated
    along the anchor axis (reference Ensemble "nms" mode,
    experimental.py:76-80)."""
    preds = [apply_model(plan, params, state, x, dtype=dtype)[0]["pred"]
             for plan, params, state in plans_params_states]
    return torch.cat(preds, dim=1)
