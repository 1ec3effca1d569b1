"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc: it is marked `cuda` and skips
without a card. On a machine with one (and no jax), run

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

`--noconftest` skips tests/conftest.py, which configures jax. This file
imports no jax.
"""

import numpy as np
import pytest
import torch

from yolo_series_tpu_torch.infer import quant
from yolo_series_tpu_torch.ops import fused_elan as fe
from yolo_series_tpu_torch.ops import fused_stem as fs
from yolo_series_tpu_torch.ops import int8_mm, nms_keep

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _boxes_with_classes(rng, b, k, nc=80, spread=640.0):
    """Score-sorted xyxy boxes in overlapping clusters, shifted by
    class * 4096 as `_nms_tail` shifts them (coordinates up to ~3.3e5)."""
    centers = rng.uniform(50, spread - 50, (b, max(k // 16, 1), 2))
    idx = rng.integers(0, centers.shape[1], (b, k))
    cxy = np.take_along_axis(centers, idx[..., None], 1) + rng.normal(0, 6, (b, k, 2))
    wh = rng.uniform(20, 90, (b, k, 2))
    cls = rng.integers(0, nc, (b, k, 1)).astype(np.float32)
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1) + cls * 4096.0
    return boxes.astype(np.float32)


@pytest.mark.parametrize("k", [1024, 256, 37])
def test_nms_keep_kernel_equals_plain(cuda, k):
    rng = np.random.default_rng(k)
    boxes = torch.from_numpy(_boxes_with_classes(rng, 4, k, nc=3)).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=(4, k)) < 0.9).to(cuda)
    before = nms_keep.nms_keep_mask.launches
    got = nms_keep.nms_keep_mask(boxes, valid, 0.45)
    torch.cuda.synchronize()
    assert nms_keep.nms_keep_mask.launches == before + 1
    want = nms_keep.nms_keep_mask_plain(boxes, valid, 0.45)
    assert torch.equal(got, want)


def test_nms_keep_kernel_rejects_large_k(cuda):
    boxes = torch.zeros((1, 1025, 4), device=cuda)
    with pytest.raises(ValueError, match="1024"):
        nms_keep.nms_keep_mask(boxes, torch.ones((1, 1025), dtype=torch.bool,
                                                 device=cuda), 0.45)


def _bf16(rng, shape, scale):
    return torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32)).to(
        torch.bfloat16)


def _close(got, want):
    """bf16 outputs of the same fp32-accumulated math: summation order
    differs, so a stage output may round to the neighbouring bf16 value and
    the difference compounds through the chained stages — a few bf16 ulps
    of the output scale."""
    d = (got.float() - want.float()).abs().max().item()
    scale = max(want.float().abs().max().item(), 1.0)
    assert d <= 2e-2 * scale, (d, scale)


def test_fused_stem_kernel_equals_plain(cuda):
    rng = np.random.default_rng(0)
    c1, cm, co, hx, w = 128, 64, 128, 32, 48
    p = {"wk2": _bf16(rng, (2, 2, c1, cm), 0.05), "b1": _bf16(rng, (cm,), 0.1),
         "ws2": _bf16(rng, (3, 3, cm, cm), 0.05), "b2": _bf16(rng, (cm,), 0.1),
         "ws3": _bf16(rng, (3, 3, cm, co), 0.05), "b3": _bf16(rng, (co,), 0.1)}
    x = _bf16(rng, (2, hx + 2 * fs._PAD, w, c1), 1.0)  # halo rows non-zero
    pc = {k: v.to(cuda) for k, v in p.items()}
    got = fs.fused_stem(x.to(cuda), pc)
    torch.cuda.synchronize()
    want = fs.fused_stem_plain(x.to(cuda), pc)
    assert got.shape == want.shape == (2, hx // 2, w // 2, co)
    _close(got, want)


@pytest.mark.parametrize("order", ["backbone", "head"])
def test_fused_elan_kernel_equals_plain(cuda, order):
    rng = np.random.default_rng(1)
    cin, ct, cc, cout, h, w = 64, 32, 64, 96, 20, 24
    _, cat = fe.concat_slots(order, ct, cc)
    p = {"w4": _bf16(rng, (1, 1, cin, ct), 0.1), "b4": _bf16(rng, (ct,), 0.1),
         "w5": _bf16(rng, (1, 1, cin, ct), 0.1), "b5": _bf16(rng, (ct,), 0.1),
         "wc0": _bf16(rng, (3, 3, ct, cc), 0.05), "bc0": _bf16(rng, (cc,), 0.1),
         "wc": _bf16(rng, (3, 3, 3, cc, cc), 0.05), "bc": _bf16(rng, (3, cc), 0.1),
         "w11": _bf16(rng, (1, 1, cat, cout), 0.05), "b11": _bf16(rng, (cout,), 0.1)}
    pc = {k: v.to(cuda) for k, v in p.items()}
    x = _bf16(rng, (2, h, w, cin), 1.0).to(cuda)
    got = fe.fused_elan(x, pc, order)
    torch.cuda.synchronize()
    want = fe.fused_elan_plain(x, pc, order)
    assert got.shape == want.shape == (2, h, w, cout)
    _close(got, want)


def _int8(rng, shape, cuda):
    return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).to(cuda)


# M not a multiple of the 128-row tile, a one-row M, and the widest K and N
# of the yolov7 path
@pytest.mark.parametrize("m,k,n", [(320, 256, 128), (1, 128, 128), (3200, 2048, 1024),
                                   (20000, 128, 384)])
def test_int8_matmul_dequant_kernel_equals_plain(cuda, m, k, n):
    rng = np.random.default_rng(m)
    xq, w = _int8(rng, (m, k), cuda), _int8(rng, (n, k), cuda).t()
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, n).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(cuda)
    before = int8_mm.int8_matmul_dequant.launches
    got = int8_mm.int8_matmul_dequant(xq, w, scale, bias)
    torch.cuda.synchronize()
    assert int8_mm.int8_matmul_dequant.launches == before + 1
    assert torch.equal(got, int8_mm.int8_matmul_dequant_plain(xq, w, scale, bias))


@pytest.mark.parametrize("m,k,n", [(12800, 1024, 512), (3200, 2048, 1024), (200, 128, 256)])
def test_matmul_kernel_equals_plain(cuda, m, k, n):
    """K4b: int8 -> int32 equal; bf16 -> fp32 within K * 2^-22 * sum|x w|
    (two fp32 sums of K terms in different orders)."""
    rng = np.random.default_rng(n)
    x, w = _int8(rng, (m, k), cuda), _int8(rng, (n, k), cuda).t()
    got = int8_mm.matmul(x, w, torch.int32)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32
    assert torch.equal(got, int8_mm.matmul_plain(x, w, torch.int32))
    xb = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(cuda, torch.bfloat16)
    wb = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32) / k ** 0.5).to(
        cuda, torch.bfloat16).t()
    gotb = int8_mm.matmul(xb, wb, torch.float32)
    torch.cuda.synchronize()
    err = (gotb - int8_mm.matmul_plain(xb, wb, torch.float32)).abs()
    assert bool((err <= k * 2.0 ** -22 * (xb.float().abs() @ wb.float().abs())).all())


def test_int8_mm_wrappers_refuse_unaligned_or_transposed(cuda):
    rng = np.random.default_rng(0)
    x, w = _int8(rng, (256, 96), cuda), _int8(rng, (128, 96), cuda).t()
    s = torch.ones(128, device=cuda)
    with pytest.raises(ValueError, match="multiples of 128"):
        int8_mm.int8_matmul_dequant(x, w, s, s)
    x, w = _int8(rng, (256, 128), cuda), _int8(rng, (64, 128), cuda).t()
    with pytest.raises(ValueError, match="multiples of 128"):
        int8_mm.matmul(x, w, torch.int32)
    x, w = _int8(rng, (256, 128), cuda), _int8(rng, (128, 128), cuda)  # row-major (K, N)
    with pytest.raises(ValueError, match="column-major"):
        int8_mm.int8_matmul_dequant(x, w, s, s)


@pytest.mark.parametrize("k,s,c,n", [(1, 1, 128, 256), (3, 1, 32, 64), (3, 2, 3, 32),
                                     (1, 1, 96, 128)])
def test_int8_conv_on_card_equals_cpu(cuda, k, s, c, n):
    """`quant.int8_conv` on the card (K4, or the im2col product through
    torch._int_mm) gives the CPU's result bit for bit."""
    rng = np.random.default_rng(k * 10 + c)
    x = torch.from_numpy(rng.normal(size=(2, c, 20, 20)).astype(np.float32)).contiguous(
        memory_format=torch.channels_last)
    w = torch.from_numpy(rng.normal(size=(n, c, k, k)).astype(np.float32))
    wq, sw = quant.quantize_weight(w)
    b = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    want = quant.int8_conv(x, wq, sw, b, s, k // 2, 1)
    got = quant.int8_conv(x.to(cuda), wq.to(cuda), sw.to(cuda), b.to(cuda), s, k // 2, 1)
    assert torch.equal(got.cpu(), want)
