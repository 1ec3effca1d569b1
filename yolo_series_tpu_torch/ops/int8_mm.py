"""Int8 matmul with a dequant epilogue (counterpart of
`yolo_series_tpu/ops/pallas_int8.py`) and its bench template (counterpart of
`pallas_matmul` in `tools/bench_int8_pallas.py`), both on the kernel
`csrc/int8_mm.cu`.

- K4 `int8_matmul_dequant(xq, wq, scale, bias)`: (M, K) int8 @ (K, N) int8
  with exact int32 sums, then acc * scale[n] + bias[n] in fp32.
  `int8_conv1x1` runs a quantized 1x1 conv through it.
- K4b `matmul(x, w, acc)`: the same product with no epilogue, int8 -> int32
  or bf16 -> fp32.

The weight operand is (K, N) column-major, i.e. the transpose view of an
(N, K) row-major tensor: the OIHW weight of a 1x1 conv viewed as
`wq.reshape(N, K).t()`, so it is read in place. K and N must be multiples
of 128, as for the Pallas kernel; M is free (the kernel guards it).

The output tile of a launch is chosen here, per shape (`pick_tile`), and
each wrapper reports the tile of its last launch in `.tile`.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises. K4 is also an operator of PyTorch's
dispatcher (`torch.ops.yolo_series_tpu_torch.int8_matmul_dequant`,
registered when this module is imported), so a `torch.export` program of
the int8 model holds it as a call; loading such a program needs this
module imported first.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from yolo_series_tpu_torch.obs import trace
from yolo_series_tpu_torch.ops import _build

ALIGN = 128  # K and N of every call (the Pallas kernel's lane constraint)

_K4B_FORMS = {torch.int8: (torch.int32, "int8_mm_raw"),
              torch.bfloat16: (torch.float32, "bf16_mm_raw")}

# the output tiles (rows, columns) the kernel takes, the most work a tile
# first, and the persistent CTAs it keeps on an SM
TILES = ((128, 128), (128, 64), (64, 64))
CTAS_PER_SM = 2
H100_SMS = 132


def pick_tile(m: int, k: int, n: int, sms: int = H100_SMS) -> Tuple[int, int]:
    """The tile of an (M, K) @ (K, N) launch: the largest that gives every
    SM a tile or, where K >= 1024, three quarters of them; where none does,
    the smallest. Either way the tiles fill the SMs or all run in one wave
    of the persistent CTAs. Measured on an H100 at the 41 K4 shapes: with
    K >= 1024 a tile reads >= 256 KB of A and B from L2, and a larger tile
    that leaves a quarter of the SMs idle beats a smaller one that reads
    them more often (the 20 px convs, M = 3200: 50-200 tiles at 128 x
    128); with a shorter K, filling the SMs wins."""
    least = 3 * sms // 4 if k >= 1024 else sms
    for bm, bn in TILES:
        if n % bn == 0 and -(-m // bm) * (n // bn) >= least:
            return bm, bn
    return TILES[-1]


@functools.cache
def _entry(name: str):
    """The C entry point `name` with its argument types, set up once: the
    int8 engine makes 41 launches a forward, and the host's cost shows."""
    fn = getattr(_build.load("int8_mm"), name)
    pointers = 5 if name == "int8_mm_dequant" else 3
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_shape(name, x, m, k, n, tile):
    """(tile, persistent CTAs) of a launch on x's card; `tile` None picks
    one, else it must be one the kernel takes."""
    sms = _sm_count(x.device.index)
    if tile is None:
        tile = pick_tile(m, k, n, sms)
    elif tuple(tile) not in TILES or n % tile[1]:
        raise ValueError(f"{name}: tile {tile} for N={n}: want one of {TILES} "
                         "whose columns divide N")
    return tuple(tile), CTAS_PER_SM * sms


def exact_int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact. The sums run in
    fp64, which holds every partial sum exactly (|sum| <= K * 127^2, far
    below 2^53) and which PyTorch multiplies on the CPU and on the card
    alike (it has no int32 matmul on the card)."""
    return (a.double() @ b.double()).to(torch.int32)


def int8_matmul_dequant_plain(xq: torch.Tensor, wq: torch.Tensor,
                              scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(xq @ wq) in int32, then .float() * scale + bias, each op rounded."""
    return exact_int_mm(xq, wq).float() * scale + bias


def matmul_plain(x: torch.Tensor, w: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """x @ w with `acc` (int32 or fp32) sums, as K4b computes it."""
    if acc == torch.int32:
        return exact_int_mm(x, w)
    return x.float() @ w.float()


def _check(name, x, w, x_dtype, n_extra=()):
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: x {tuple(x.shape)} @ w {tuple(w.shape)}: "
                         "want (M, K) @ (K, N)")
    m, k = x.shape
    n = w.shape[1]
    if k % ALIGN or n % ALIGN:
        raise ValueError(f"{name}: K={k} and N={n} must be multiples of {ALIGN}")
    if x.dtype != x_dtype or w.dtype != x_dtype:
        raise TypeError(f"{name}: want {x_dtype} operands, got {x.dtype} / {w.dtype}")
    for v in n_extra:
        if v.shape != (n,) or v.dtype != torch.float32:
            raise ValueError(f"{name}: scale and bias must be fp32 of shape ({n},), "
                             f"got {v.dtype} {tuple(v.shape)}")
    return m, k, n


def _check_cuda(name, x, w, *rest):
    if any(t.device != x.device for t in (w, *rest)) or x.device.type != "cuda":
        raise ValueError(f"{name}: operands on {x.device}/{w.device}: want one "
                         "CUDA device (or the CPU for the plain version)")
    if not x.is_contiguous() or not w.t().is_contiguous():
        raise ValueError(f"{name}: want x (M, K) row-major and w (K, N) column-major "
                         f"(the .t() view of an (N, K) tensor), got strides "
                         f"{x.stride()} / {w.stride()}")
    for t in (x, w, *rest):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data pointer not 16-byte aligned")


def _launch_k4(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor, tile: Optional[Tuple[int, int]]) -> torch.Tensor:
    """One K4 launch on xq's card, on `tile` or the one `pick_tile` chooses;
    raises where the launch fails."""
    m, k, n = _check("int8_matmul_dequant", xq, wq, torch.int8, (scale, bias))
    scale, bias = scale.contiguous(), bias.contiguous()
    _check_cuda("int8_matmul_dequant", xq, wq, scale, bias)
    (bm, bn), ctas = _launch_shape("int8_matmul_dequant", xq, m, k, n, tile)
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    _build.check(_entry("int8_mm_dequant")(
        xq.data_ptr(), wq.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        m, n, k, bm, bn, ctas, _build.stream_ptr()), "int8_matmul_dequant")
    int8_matmul_dequant.launches += 1
    int8_matmul_dequant.tile = (bm, bn)
    return out


# K4 as an operator of PyTorch's dispatcher, so that `torch.export` keeps it
# in a program as one call (a ctypes launch cannot be traced: it meets fake
# tensors with no storage). Its CPU kernel is the plain version; its CUDA
# kernel launches K4 (on `tile`, or the one `pick_tile` chooses) or raises;
# its fake kernel gives the (M, N) fp32 shape.
@torch.library.custom_op("yolo_series_tpu_torch::int8_matmul_dequant", mutates_args=())
def int8_matmul_dequant_op(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, tile: Optional[List[int]] = None
                           ) -> torch.Tensor:
    _check("int8_matmul_dequant", xq, wq, torch.int8, (scale, bias))
    return int8_matmul_dequant_plain(xq, wq, scale, bias)


@int8_matmul_dequant_op.register_kernel("cuda")
def _(xq, wq, scale, bias, tile=None):
    return _launch_k4(xq, wq, scale, bias, None if tile is None else tuple(tile))


@int8_matmul_dequant_op.register_fake
def _(xq, wq, scale, bias, tile=None):
    return xq.new_empty((xq.shape[0], wq.shape[1]), dtype=torch.float32)


def int8_matmul_dequant(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor,
                        tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """K4. (M, K) int8 @ (K, N) int8 -> (M, N) fp32 = acc * scale[n] +
    bias[n], scale being the combined sx * sw, through the registered op
    `torch.ops.yolo_series_tpu_torch.int8_matmul_dequant`: the CPU takes
    the plain version; a CUDA tensor launches the kernel, on `tile` (one of
    TILES, for the benches) or the one `pick_tile` chooses."""
    if xq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_matmul_dequant: operands on {xq.device}: want one CUDA "
                         "device (or the CPU for the plain version)")
    return int8_matmul_dequant_op(xq, wq, scale, bias, None if tile is None else list(tile))


int8_matmul_dequant.launches = 0
int8_matmul_dequant.tile = None
trace.watch("launches.int8_mm.int8_matmul_dequant", int8_matmul_dequant, "launches")


def int8_conv1x1(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Quantized 1x1 conv: NHWC int8 activations (B, H, W, K) x OIHW int8
    weight (N, K, 1, 1) -> NHWC fp32 (B, H, W, N), through K4. A contiguous
    NHWC input (the channels-last activations' permute) and the weight are
    viewed, not copied."""
    b, h, w, k = xq.shape
    n = wq.shape[0]
    y = int8_matmul_dequant(xq.reshape(b * h * w, k), wq.reshape(n, k).t(),
                            scale, bias)
    return y.view(b, h, w, n)


def matmul(x: torch.Tensor, w: torch.Tensor, acc: torch.dtype = torch.int32,
           tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """K4b. (M, K) @ (K, N) with no epilogue: int8 operands with int32
    sums (acc=torch.int32) or bf16 operands with fp32 sums
    (acc=torch.float32). The CPU takes the plain version; a CUDA tensor
    launches the kernel, on `tile` or the one `pick_tile` chooses."""
    if x.dtype not in _K4B_FORMS or _K4B_FORMS[x.dtype][0] != acc:
        raise TypeError(f"matmul: {x.dtype} operands with {acc} sums: want int8 "
                        "-> int32 or bf16 -> float32")
    m, k, n = _check("matmul", x, w, x.dtype)
    if x.device.type == "cpu":
        return matmul_plain(x, w, acc)
    _check_cuda("matmul", x, w)
    (bm, bn), ctas = _launch_shape("matmul", x, m, k, n, tile)
    out = torch.empty((m, n), dtype=acc, device=x.device)
    _build.check(_entry(_K4B_FORMS[x.dtype][1])(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, bm, bn, ctas,
        _build.stream_ptr()), "matmul")
    matmul.launches += 1
    matmul.tile = (bm, bn)
    return out


matmul.launches = 0
matmul.tile = None
trace.watch("launches.int8_mm.matmul", matmul, "launches")
