"""Device letterbox (counterpart of `make_device_letterbox` in
`yolo_series_tpu/data/device_aug.py`).

For a fixed source shape (one camera or stream): aspect-preserving
bilinear resize and centre pad to (dst, dst), uint8 in and out, on the
tensor's device, with the static (ratio, (dw, dh)) that maps detections
back (`augment.letterbox` with auto=False, scaleup=True). The resize is
`F.interpolate(mode="bilinear", align_corners=False, antialias=False)`,
the half-pixel-centre bilinear of `jax.image.resize(..., "bilinear",
antialias=False)`; the two sum the same taps in another order, so a
value that lands within an ulp of .5 may round the other way: pixels
differ from the JAX function's by at most 1. The rest of the device
augmentation pipeline is ROADMAP queue 1, item 18.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def make_device_letterbox(src_hw, dst: int = 640, pad_value: float = 114.0):
    """Returns (fn, (r, r), (dw, dh)); fn maps (B, h, w, 3) uint8 NHWC to
    (B, dst, dst, 3) uint8 on the input's device."""
    h, w = src_hw
    r = min(dst / h, dst / w)
    new_w, new_h = int(round(w * r)), int(round(h * r))
    dw, dh = (dst - new_w) / 2, (dst - new_h) / 2
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))

    def fn(x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[1:3]) != (h, w):
            raise ValueError(f"frames {tuple(x.shape)}: this letterbox takes "
                             f"(B, {h}, {w}, 3)")
        y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(new_h, new_w),
                          mode="bilinear", align_corners=False, antialias=False)
        y = torch.clamp(torch.round(y), 0, 255)
        y = F.pad(y, (left, right, top, bottom), value=pad_value)
        return y.to(torch.uint8).permute(0, 2, 3, 1)

    return fn, (r, r), (dw, dh)
