"""Greedy-NMS keep-mask (counterpart of `yolo_series_tpu/ops/pallas_nms.py`).

`nms_keep_mask(boxes, valid, iou_threshold)` returns, per image, the keep
mask of exact sequential greedy NMS over score-sorted boxes. On a CUDA
tensor it launches the kernel `csrc/nms_keep.cu` (a cluster of CTAs per
image builds the suppression bitmask, one warp scans it); on a CPU tensor
it runs `nms_keep_mask_plain`, the whole-matrix fixpoint of
`ops/nms.nms_keep_mask_full` in the JAX package. Both run to convergence,
so they agree on any suppression-chain depth; the Pallas kernel stops
after `max_iters` (64) passes and agrees only on shallower chains.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from yolo_series_tpu_torch.ops import _build
from yolo_series_tpu_torch.ops.boxes import box_iou

MAX_K = 1024  # shared-memory capacity of the kernel (16 B per box)


@functools.cache
def _entry():
    """The kernel's C entry point with its argument types, set up once: the
    serving path calls it every forward, and the host's cost shows."""
    fn = _build.load("nms_keep").nms_keep_mask
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def nms_keep_mask_plain(boxes: torch.Tensor, valid: torch.Tensor,
                        iou_threshold: float) -> torch.Tensor:
    """(B, K, 4) xyxy fp32 score-sorted, (B, K) bool -> (B, K) bool.
    alive' = valid & ~exists alive q < p with IoU(q, p) > thr, iterated to
    its fixed point (which is sequential greedy)."""
    k = boxes.shape[1]
    iou = box_iou(boxes, boxes)
    upper = torch.ones((k, k), dtype=torch.bool, device=boxes.device).triu(1)
    m = (iou > iou_threshold) & upper            # m[b, q, p]: q suppresses p
    alive = valid.clone()
    for _ in range(k):
        nxt = valid & ~(alive[:, :, None] & m).any(dim=1)
        if torch.equal(nxt, alive):
            break
        alive = nxt
    return alive


def nms_keep_mask(boxes: torch.Tensor, valid: torch.Tensor,
                  iou_threshold: float) -> torch.Tensor:
    """Batched greedy-NMS keep mask. boxes (B, K, 4) xyxy fp32, each row
    sorted by descending score; valid (B, K) bool. Returns (B, K) bool.
    The CPU takes the plain version; a CUDA tensor launches the kernel."""
    if boxes.ndim != 3 or boxes.shape[-1] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(f"boxes {tuple(boxes.shape)} / valid "
                         f"{tuple(valid.shape)}: want (B, K, 4) / (B, K)")
    if boxes.device.type == "cpu":
        return nms_keep_mask_plain(boxes, valid, iou_threshold)
    if boxes.device.type != "cuda" or valid.device != boxes.device:
        raise ValueError(f"unsupported devices {boxes.device}/{valid.device}")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"want fp32 boxes and bool valid, got {boxes.dtype} "
                        f"/ {valid.dtype}")
    b, k, _ = boxes.shape
    if k > MAX_K:
        raise ValueError(f"K={k} > {MAX_K}: the tiled keep-mask for large K "
                         "is ROADMAP queue 1, item 4")
    boxes = boxes.contiguous()
    valid = valid.contiguous()
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    _build.check(_entry()(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                          b, k, float(iou_threshold), _build.stream_ptr()),
                 "nms_keep_mask")
    nms_keep_mask.launches += 1
    return keep


nms_keep_mask.launches = 0
