"""Launcher and plain version of the conv + bias + SiLU kernel that the fused
stem (`ops/fused_stem.py`) and the fused ELAN span (`ops/fused_elan.py`)
chain. JAX counterpart: the per-stage conv of the Pallas kernels
`ops/pallas_stem.py` and `ops/pallas_elan.py` (`conv3` / `_dot` + `_silu`).

Layout: NHWC bf16 activations, HWIO bf16 weights (KH, KW, C, CO), bf16
bias. Rounding: fp32 accumulation, + bias and SiLU in fp32, one round to
bf16 — where the Pallas kernels round. A residual (the Shortcut that
follows an E-ELAN pair, folded into the second span's output conv) is
added in fp32 after SiLU, before that one round.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from yolo_series_tpu_torch.obs import trace
from yolo_series_tpu_torch.ops import _build


def conv_silu_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    stride: int = 1,
                    pad: Tuple[int, int, int, int] = (0, 0, 0, 0),
                    r: Optional[torch.Tensor] = None) -> torch.Tensor:
    """silu(conv(x, w) + b) [+ r] rounded to bf16. x (B, H, W, C) NHWC, w
    HWIO, pad (top, bottom, left, right) zeros, r (B, OH, OW, CO) NHWC.
    Computed in fp32, one round at the end."""
    t, bo, l, rt = pad
    xf = F.pad(x.float().permute(0, 3, 1, 2), (l, rt, t, bo))
    y = F.silu(F.conv2d(xf, w.float().permute(3, 2, 0, 1), b.float(), stride))
    if r is not None:
        y = y + r.float().permute(0, 3, 1, 2)
    return y.to(torch.bfloat16).permute(0, 2, 3, 1)


def conv_ops(h: int, w: int, c: int, co: int, k: int, s: int = 1) -> int:
    """Operations of one image's k x k conv, stride s, pad k // 2, on an
    h x w input: two a multiply-add over the taps inside the input (the
    dense FLOP counter's arithmetic, `utils/general.FlopCounter`)."""
    p = k // 2

    def taps(n):
        return sum(1 for o in range((n + 2 * p - k) // s + 1) for i in range(k)
                   if 0 <= o * s - p + i < n)

    return 2 * c * co * taps(h) * taps(w)


def _check_bf16_cuda(name, t):
    if t.device.type != "cuda" or t.dtype != torch.bfloat16 or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous bf16 CUDA tensor, got "
                         f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")


@functools.cache
def _entry():
    """The kernel's C entry point with its argument types, set up once: a
    serving forward makes 51 launches, and the host's cost of each shows."""
    fn = _build.load("conv_silu").conv_silu_nhwc
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 18 + [ctypes.c_void_p]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p]
                   + [ctypes.POINTER(ctypes.c_int)])
    fn.restype = ctypes.c_int
    return fn


def launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, y: torch.Tensor,
           *, h: int, c: int, stride: int, pad_t: int, pad_l: int,
           x_row0: int = 0, x_coff: int = 0, y_coff: int = 0,
           r: Optional[torch.Tensor] = None, r_coff: int = 0) -> None:
    """One kernel launch on the current stream: y[..., y_coff:y_coff+CO] =
    silu(conv(x rows [x_row0, x_row0+h), channels [x_coff, x_coff+c)) + b)
    [+ r[..., r_coff:r_coff+CO]]. x (B, rows, W, x_cstride), y (B, OH, OW,
    y_cstride), w (KH, KW, c, CO), the residual r (B, OH, OW, r_cstride);
    rows of x outside the h logical rows read as the conv's zero padding.
    Channel strides and offsets are multiples of 8 (16-byte TMA rows);
    stride is 1 or 2. Sets `launch.tile` to the (GEMM rows, N) tile that the
    kernel chose for this launch."""
    named = (("x", x), ("w", w), ("b", b), ("y", y)) + ((("r", r),) if r is not None else ())
    for name, t in named:
        _check_bf16_cuda(name, t)
    bsz, rows, wid, xcs = x.shape
    kh, kw, cw, co = w.shape
    _, oh, ow, ycs = y.shape
    rcs = r.shape[3] if r is not None else 0
    if (cw != c or c % 32 or co % 16 or xcs % 8 or x_coff % 8 or ycs % 8
            or y_coff % 8 or x_coff + c > xcs or y_coff + co > ycs
            or x_row0 < 0 or x_row0 + h > rows or stride not in (1, 2)
            or h < stride or wid < stride or pad_t < 0 or pad_l < 0
            or b.shape != (co,) or y.shape[0] != bsz
            or (r is not None and (r.shape[:3] != y.shape[:3] or rcs % 8 or r_coff % 8
                                   or r_coff < 0 or r_coff + co > rcs))):
        raise ValueError(
            f"conv_silu: x {tuple(x.shape)} rows [{x_row0}, +{h}) ch "
            f"[{x_coff}, +{c}), w {tuple(w.shape)}, y {tuple(y.shape)} ch "
            f"[{y_coff}, +{co}), r {None if r is None else tuple(r.shape)} ch "
            f"[{r_coff}, +{co}), stride {stride}: want c % 32 == 0, co % 16 "
            "== 0, channel strides and offsets % 8 == 0, stride 1 or 2, r of "
            "y's pixels and slices inside their tensors")
    tile = (ctypes.c_int * 2)()
    _build.check(_entry()(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                          bsz, h, wid, c, rows, x_row0, xcs, x_coff,
                          kh, kw, stride, pad_t, pad_l, oh, ow, co, ycs, y_coff,
                          None if r is None else r.data_ptr(), rcs, r_coff,
                          _build.stream_ptr(), tile), "conv_silu_nhwc")
    _LAUNCH.launches += 1
    _LAUNCH.tile = (tile[0], tile[1])


# device launches of the kernel (the stem counts 3, a span n + 2); the body
# updates them through _LAUNCH, so they stay right while a caller wraps
# `launch` (chip_smoke.py records the path's launches that way)
launch.launches = 0
launch.tile = None
trace.watch("launches.conv_silu.launch", launch, "launches")
_LAUNCH = launch
