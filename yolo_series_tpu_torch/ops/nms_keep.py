"""Greedy-NMS keep-mask (counterpart of `yolo_series_tpu/ops/pallas_nms.py`,
and of the tiled `nms_keep_mask` of `yolo_series_tpu/ops/nms.py` that the
JAX package's `_nms_tail` takes above 1024 candidates).

`nms_keep_mask(boxes, valid, iou_threshold)` returns, per image, the keep
mask of exact sequential greedy NMS over score-sorted boxes, for any K. On
a CUDA tensor it launches a kernel of `csrc/nms_keep.cu`: K1 for K <= 1024
(a cluster of CTAs per image builds the suppression bitmask in shared
memory, one warp scans it), K1L above that (`nms_keep_mask_large`: a mask
kernel writes the upper-triangular 64 x 64 tiles of the suppression mask,
packed, into a workspace in device memory; a cluster of CTAs an image
scans it, each block resolved by the owner of its word and broadcast
through distributed shared memory).
On a CPU tensor it runs `nms_keep_mask_plain`, the whole-matrix fixpoint
of `ops/nms.nms_keep_mask_full` in the JAX package. All run to
convergence, so they agree on any suppression-chain depth; the Pallas
kernel stops after `max_iters` (64) passes and agrees only on shallower
chains.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from yolo_series_tpu_torch.obs import trace
from yolo_series_tpu_torch.ops import _build
from yolo_series_tpu_torch.ops.boxes import box_iou

MAX_K = 1024  # K1's shared-memory capacity (16 B per box); K1L above it
MAX_K_LARGE = 6000 * 64  # K1L's scan: 24 B of shared memory a 64-box word
TILE = 64  # K1L's tile: 64 rows of one uint64 word, 512 bytes


@functools.cache
def _entry():
    """The kernel's C entry point with its argument types, set up once: the
    serving path calls it every forward, and the host's cost shows."""
    fn = _build.load("nms_keep").nms_keep_mask
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _entry_large():
    """K1L's C entry point, set up once."""
    fn = _build.load("nms_keep").nms_keep_mask_large
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def large_tiles(k: int) -> int:
    """Tiles of K1L's packed mask an image: the upper triangle (cb >= rb)
    of the nw x nw grid of 64 x 64 tiles, nw = ceil(k / 64)."""
    nw = -(-k // TILE)
    return nw * (nw + 1) // 2


def large_tile_index(rb: int, cb: int, k: int) -> int:
    """Packed index of tile (rb, cb), rb <= cb, in an image's K1L mask: row
    block by row block (`tile_start` in csrc/nms_keep.cu)."""
    nw = -(-k // TILE)
    if not 0 <= rb <= cb < nw:
        raise ValueError(f"tile ({rb}, {cb}) is not in the upper triangle of {nw} x {nw}")
    return rb * nw - rb * (rb - 1) // 2 + (cb - rb)


def large_workspace_bytes(b: int, k: int) -> int:
    """Bytes of K1L's packed mask for b images of k boxes: 33.8 MB at
    b = 8, k = 8192."""
    return b * large_tiles(k) * TILE * 8


def nms_keep_mask_plain(boxes: torch.Tensor, valid: torch.Tensor,
                        iou_threshold: float) -> torch.Tensor:
    """(B, K, 4) xyxy fp32 score-sorted, (B, K) bool -> (B, K) bool.
    alive' = valid & ~exists alive q < p with IoU(q, p) > thr, iterated to
    its fixed point (which is sequential greedy). Boxes past the last valid
    one of the batch neither suppress nor survive, so the matrices stop
    there."""
    n = int(valid.any(0).nonzero().max()) + 1 if bool(valid.any()) else 0
    if n < boxes.shape[1]:
        keep = torch.zeros_like(valid)
        keep[:, :n] = nms_keep_mask_plain(boxes[:, :n], valid[:, :n], iou_threshold)
        return keep
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


def _check(boxes: torch.Tensor, valid: torch.Tensor) -> bool:
    """Validate the arguments; True for CPU tensors (the plain version)."""
    if boxes.ndim != 3 or boxes.shape[-1] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(f"boxes {tuple(boxes.shape)} / valid "
                         f"{tuple(valid.shape)}: want (B, K, 4) / (B, K)")
    if boxes.device.type == "cpu":
        return True
    if boxes.device.type != "cuda" or valid.device != boxes.device:
        raise ValueError(f"unsupported devices {boxes.device}/{valid.device}")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"want fp32 boxes and bool valid, got {boxes.dtype} "
                        f"/ {valid.dtype}")
    return False


def nms_keep_mask_large(boxes: torch.Tensor, valid: torch.Tensor,
                        iou_threshold: float) -> torch.Tensor:
    """The keep mask for any K up to MAX_K_LARGE with K1L (two launches:
    the packed upper-triangular suppression mask into a workspace allocated
    here, `large_workspace_bytes`, then the scan). The CPU takes the plain
    version."""
    if _check(boxes, valid):
        return nms_keep_mask_plain(boxes, valid, iou_threshold)
    b, k, _ = boxes.shape
    if k > MAX_K_LARGE:
        raise ValueError(f"K={k} > {MAX_K_LARGE}, the largest K1L takes")
    boxes = boxes.contiguous()
    valid = valid.contiguous()
    mask = torch.empty(large_workspace_bytes(b, k) // 8, dtype=torch.int64,
                       device=boxes.device)
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    _build.check(_entry_large()(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                                mask.data_ptr(), b, k, float(iou_threshold),
                                _build.stream_ptr()), "nms_keep_mask_large")
    nms_keep_mask_large.launches += 1
    return keep


nms_keep_mask_large.launches = 0
trace.watch("launches.nms_keep.nms_keep_mask_large", nms_keep_mask_large, "launches")


def nms_keep_mask(boxes: torch.Tensor, valid: torch.Tensor,
                  iou_threshold: float) -> torch.Tensor:
    """Batched greedy-NMS keep mask. boxes (B, K, 4) xyxy fp32, each row
    sorted by descending score; valid (B, K) bool. Returns (B, K) bool.
    The CPU takes the plain version; a CUDA tensor launches K1 (counted
    here) for K <= MAX_K and K1L (counted by `nms_keep_mask_large`) above."""
    if _check(boxes, valid):
        return nms_keep_mask_plain(boxes, valid, iou_threshold)
    b, k, _ = boxes.shape
    if k > MAX_K:
        return nms_keep_mask_large(boxes, valid, iou_threshold)
    boxes = boxes.contiguous()
    valid = valid.contiguous()
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    _build.check(_entry()(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                          b, k, float(iou_threshold), _build.stream_ptr()),
                 "nms_keep_mask")
    nms_keep_mask.launches += 1
    return keep


nms_keep_mask.launches = 0
trace.watch("launches.nms_keep.nms_keep_mask", nms_keep_mask, "launches")
