"""Int8 quantized inference (counterpart of `yolo_series_tpu/infer/quant.py`).

Quantization is a tree transform on the FUSED deploy params
(`models/reparam.fuse_model` first):

- weights: per-output-channel symmetric int8 (scale = absmax / 127);
- activations: per-tensor symmetric int8, with static scales from a
  calibration pass (`calibrate`: the 99.99th percentile of |x| at every conv
  input) or, without one, a dynamic absmax scale computed on the device;
- convs run int8 x int8 with exact int32 sums, then acc * (sx * sw) + b in
  fp32: the K4-eligible 1x1 convs (`pallas_1x1_eligible`) through
  `ops/int8_mm.int8_conv1x1`, every other one as an im2col product (a
  grouped conv, ResX's 32 groups, as one product a group).

A quantized conv leaf is {wq (OIHW int8), sw (O,), b (O,)[, sx ()]}, all
but wq fp32; the blocks of `models/layers.py` take their int8 branch when
they find `wq`. The JAX package's `YOLO_TPU_PALLAS_INT8=0` opt-out is not
carried: on the card the eligible convs always take the kernel.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from yolo_series_tpu_torch.models import extra as X
from yolo_series_tpu_torch.models import layers as L
from yolo_series_tpu_torch.models.graph import GraphPlan
from yolo_series_tpu_torch.ops import int8_mm


def quantize_weight(w: torch.Tensor):
    """OIHW fp32 -> (int8 OIHW weights, per-output-channel scale (O,)):
    sw = max(absmax / 127, 1e-8), wq = clip(round_half_even(w / sw), +-127)."""
    w = w.float()
    absmax = w.abs().amax(dim=(1, 2, 3))
    sw = torch.clamp_min(absmax / 127.0, 1e-8)
    wq = torch.clamp(torch.round(w / sw[:, None, None, None]), -127, 127)
    return wq.to(torch.int8), sw


def _quantize_conv_leaf(params: Dict[str, Any], act_scale=None):
    if "w" not in params or "b" not in params:
        raise ValueError("quantize fused {w, b} conv params only "
                         f"(got keys {sorted(params)})")
    wq, sw = quantize_weight(params["w"])
    out = {"wq": wq, "sw": sw, "b": params["b"].float()}
    if act_scale is not None:
        out["sx"] = torch.tensor(act_scale, dtype=torch.float32, device=sw.device)
    return out


def pallas_1x1_eligible(block) -> bool:
    """True for the convs that mixed=True quantizes, as the JAX package's
    predicate: listed kernel 1, stride 1, no groups, channels multiples of
    128 (the kernel's tiling, as the Pallas kernel's lane constraint). It
    reads the block's listed kernel size; which int8 conv runs on K4 is
    `k4_routes`, on the weight (yolov3's `[512, [1, 1]]` conv is declined
    here and, quantized in full int8, runs on K4)."""
    k = getattr(block, "k", None)
    s = getattr(block, "s", 1)
    g = getattr(block, "g", 1)
    c1 = getattr(block, "c1", 0)
    c2 = getattr(block, "c2", 0)
    return (k == 1 and s in (1, (1, 1)) and g == 1
            and c1 % int8_mm.ALIGN == 0 and c2 % int8_mm.ALIGN == 0)


def k4_routes(wq: torch.Tensor, stride, groups: int) -> bool:
    """True when `int8_conv` sends the conv of OIHW int8 weight `wq` to K4
    (`ops/int8_mm.int8_conv1x1`): a 1 x 1 kernel, stride 1, one group,
    channels multiples of `int8_mm.ALIGN`."""
    n, c, kh, kw = wq.shape
    return (kh == 1 and kw == 1 and groups == 1 and stride in (1, (1, 1))
            and c % int8_mm.ALIGN == 0 and n % int8_mm.ALIGN == 0)


def quantize_tree(block, params, act_scales: Optional[Dict[str, float]] = None,
                  _path: str = "", mixed: bool = False):
    """Recursively quantize the conv leaves of a fused param tree (Focus's
    conv among them, as the JAX package's). With mixed=True only the
    K4-eligible 1x1 convs are quantized and the rest stay fp.

    A composite's own leaves beside its children (RobustConv's 1x1 and
    layer scale, RobustConv2's transposed conv, TransformerBlock's
    linears, Classify's conv; `reparam.fuse_model` keeps them) pass
    through unquantized, and so does a deployed RepConv_OREPA ({w, b}, no
    children left): the JAX package quantizes neither, since its fused
    tree drops the first and its `quantize_tree` raises KeyError on the
    second (ROADMAP queue 3)."""
    if isinstance(block, (L.ConvBnAct, L.Focus, L.RepConv, L.PlainConv)):
        if mixed and not pallas_1x1_eligible(block):
            return params
        scale = act_scales.get(_path) if act_scales else None
        return _quantize_conv_leaf(params, scale)
    if isinstance(block, X.RepConvOREPA) and "w" in params:
        return params
    if isinstance(block, L.Composite):
        return {**params, **{name: quantize_tree(child, params[name], act_scales,
                                                 f"{_path}/{name}", mixed=mixed)
                             for name, child in block.children().items()}}
    return params


def quantize_model(plan: GraphPlan, params, state,
                   act_scales: Optional[Dict[str, float]] = None,
                   mixed: bool = False):
    """Quantize a FUSED model's conv weights; the head stays fp. Paths of
    `act_scales` are those `calibrate` returns ("l3", "l51/cv1", "l7.0")."""
    lp = params["layers"]
    new = []
    for idx, spec in enumerate(plan.layers):
        if spec.is_head:
            new.append(lp[idx])
        elif spec.n_seq > 1:
            new.append([quantize_tree(spec.block, lp[idx][r], act_scales,
                                      f"l{idx}.{r}", mixed=mixed)
                        for r in range(spec.n_seq)])
        else:
            new.append(quantize_tree(spec.block, lp[idx], act_scales,
                                     f"l{idx}", mixed=mixed))
    return {"layers": new}, state


def _pads(padding):
    """int, (ph, pw) or ((top, bottom), (left, right)) -> (t, b, l, r)."""
    if isinstance(padding, int):
        return padding, padding, padding, padding
    if isinstance(padding[0], int):
        return padding[0], padding[0], padding[1], padding[1]
    (t, b), (l, r) = padding
    return t, b, l, r


def _im2col_int_mm(xq: torch.Tensor, wq: torch.Tensor, stride, padding) -> torch.Tensor:
    """Exact int32 conv of NHWC int8 xq with OIHW int8 wq as one product:
    (B*OH*OW, KH*KW*C) taps @ (KH*KW*C, N). Returns (B, OH, OW, N) int32.
    On the card the product is `torch._int_mm` (the JAX package leaves
    these convs to XLA, outside any Pallas kernel), which wants K and N
    multiples of 8: both are zero-padded to that."""
    n, c, kh, kw = wq.shape
    sh, sw_ = (stride, stride) if isinstance(stride, int) else stride
    t, b, l, r = _pads(padding)
    xp = F.pad(xq, (0, 0, l, r, t, b))
    bsz, hp, wp, _ = xp.shape
    oh, ow = (hp - kh) // sh + 1, (wp - kw) // sw_ + 1
    taps = [xp[:, i:i + sh * (oh - 1) + 1:sh, j:j + sw_ * (ow - 1) + 1:sw_]
            for i in range(kh) for j in range(kw)]
    cols = (taps[0] if len(taps) == 1 else torch.cat(taps, dim=-1)).reshape(-1, kh * kw * c)
    wmat = wq.permute(0, 2, 3, 1).reshape(n, kh * kw * c)   # tap-major, as the taps
    kpad, npad = -cols.shape[1] % 8, -n % 8
    if kpad or npad:
        cols = F.pad(cols, (0, kpad))
        wmat = F.pad(wmat, (0, kpad, 0, npad))
    if xq.device.type == "cuda":
        acc = torch._int_mm(cols.contiguous(), wmat.t())
    else:
        acc = cols.int() @ wmat.int().t()
    return acc[:, :n].reshape(bsz, oh, ow, n)


def _grouped_int_mm(xq: torch.Tensor, wq: torch.Tensor, stride, padding,
                    groups: int) -> torch.Tensor:
    """Exact int32 grouped conv (the JAX package's `feature_group_count`):
    group j's output channels are the product of its slice of the input
    channels with its slice of the filters, each group one `_im2col_int_mm`."""
    if groups == 1:
        return _im2col_int_mm(xq, wq, stride, padding)
    n, cg = wq.shape[0], wq.shape[1]
    if xq.shape[-1] != cg * groups or n % groups:
        raise ValueError(f"{groups} groups do not split {xq.shape[-1]} input and {n} "
                         "output channels")
    ng = n // groups
    return torch.cat([_im2col_int_mm(xq[..., j * cg:(j + 1) * cg], wq[j * ng:(j + 1) * ng],
                                     stride, padding) for j in range(groups)], dim=-1)


def int8_conv(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor, b: torch.Tensor,
              stride, padding, groups: int, sx: Optional[torch.Tensor] = None):
    """Quantized conv of NCHW fp32 x (channels-last memory) with OIHW int8
    wq: int8 x int8 -> exact int32 -> acc * (sx * sw) + b, NCHW fp32.

    sx: the static per-tensor scale (calibrated), or None for the dynamic
    one, max(max|x| / 127, 1e-8), computed on the device. x / sx is
    rounded half to even and clipped to +-127. K4-eligible 1x1 convs go to
    `ops/int8_mm.int8_conv1x1` (on the CPU its plain version)."""
    if sx is None:
        sx = torch.clamp_min(x.abs().amax() / 127.0, 1e-8)
    xq = torch.clamp(torch.round(x / sx), -127, 127).to(torch.int8)
    xh = xq.permute(0, 2, 3, 1)          # NHWC view of channels-last memory
    scale = sx * sw
    if k4_routes(wq, stride, groups):
        y = int8_mm.int8_conv1x1(xh.contiguous(), wq, scale, b)
    else:
        y = _grouped_int_mm(xh, wq, stride, padding, groups).float() * scale + b
    return y.permute(0, 3, 1, 2)


def abs_percentile(x: torch.Tensor, q: float) -> float:
    """np.percentile(|x|, q) of the fp32 map x (method 'linear'), from two
    order statistics found on x's device with `torch.topk` from the nearer
    end, so a calibration pass copies two numbers to the host, not the map.
    The index and the interpolation repeat numpy's arithmetic for fp32
    data, in fp32: q / 100, virtual index (n - 1) * q, its fraction, and
    the lerp from the nearer neighbour."""
    a = x.detach().reshape(-1).abs().float()
    n = a.numel()
    virt = (n - 1) * np.asarray(np.true_divide(q, np.float32(100)))
    lo = min(int(np.floor(virt)), n - 1)
    hi = min(lo + 1, n - 1)
    if hi + 1 <= n - lo:   # the two are among the hi + 1 smallest
        vals = torch.topk(a, hi + 1, largest=False).values[lo:]
    else:                  # among the n - lo largest, in descending order
        vals = torch.topk(a, n - lo).values.flip(0)[:hi - lo + 1]
    v = vals.cpu().numpy()
    lo_v, hi_v = v[0], v[-1]
    gamma = np.asarray(virt - np.floor(virt), dtype=virt.dtype)
    diff = hi_v - lo_v
    if gamma >= 0.5:
        return float(hi_v - diff * (1 - gamma))
    return float(lo_v + diff * gamma)


@torch.no_grad()
def calibrate(plan: GraphPlan, params, state, batches: Sequence,
              percentile: float = 99.99) -> Dict[str, float]:
    """Per-conv-leaf activation scales from calibration batches: the fp32
    model runs with the `Ctx.observer` hook, which fires at every conv
    input with the paths `quantize_tree` uses, and each path's scale is
    max(max over batches of the percentile of |x| / 127, 1e-8). batches:
    (B, H, W, 3) float images in [0, 1] (numpy or tensors). Returns {path:
    scale} for `quantize_model`."""
    from yolo_series_tpu_torch.models.model import apply_model, tree_leaves

    dev = tree_leaves(params)[0].device
    records: Dict[str, List[float]] = {}

    def observe(path, x):
        records.setdefault(path, []).append(abs_percentile(x, percentile))

    for xb in batches:
        xt = torch.as_tensor(np.asarray(xb, np.float32)).to(dev)
        apply_model(plan, params, state, xt, dtype=torch.float32, observer=observe)
    return {k: max(max(v) / 127.0, 1e-8) for k, v in records.items()}
