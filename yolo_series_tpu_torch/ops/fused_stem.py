"""Fused stem tail (counterpart of `yolo_series_tpu/ops/pallas_stem.py`).

`make_fused_stem` rewrites the P5 stem (cfg deploy/yolov7.yaml layers
0-3: k3/s1, k3/s2, k3/s1, k3/s2) into [k4/s2 phase conv, FusedStem,
passthrough x2]. The phase conv (`models/faststem.PhasedConv`) emits the
4 output phases of layer 0 stacked in channels, plus _PAD halo rows above
and below; FusedStem runs the rest — the k2 phase-consume conv (pad
(1,0)), the k3/s1 conv and the k3/s2 conv, each + bias + SiLU with bf16
between stages — as one host op `fused_stem` of 3 launches of the
conv + SiLU kernel (`csrc/conv_silu.cu`). The first launch reads past the
halo rows, which hold the phase conv's output over the padding and not
zeros, and zero-pads around the real rows.

Apply after `reparam.fuse_model`; the serving engine then runs
`faststem.make_fast_stem(max_pairs=2)`, a no-op after this rewrite.
"""

from __future__ import annotations

import dataclasses

import torch

from yolo_series_tpu_torch.models.faststem import (PhasedConv, _Passthrough,
                                                   _phase_weights, hwio, oihw)
from yolo_series_tpu_torch.models.graph import GraphPlan
from yolo_series_tpu_torch.models.layers import Block, ConvBnAct
from yolo_series_tpu_torch.obs import trace
from yolo_series_tpu_torch.ops import conv_silu

# halo rows the phase conv emits above and below the real rows
_PAD = 3


def fused_stem_plain(x: torch.Tensor, p) -> torch.Tensor:
    """(B, HX + 2*_PAD, W, C1) bf16 NHWC -> (B, HX/2, W/2, C2) bf16."""
    x = x[:, _PAD:x.shape[1] - _PAD]
    s1 = conv_silu.conv_silu_plain(x, p["wk2"], p["b1"], 1, (1, 0, 1, 0))
    s2 = conv_silu.conv_silu_plain(s1, p["ws2"], p["b2"], 1, (1, 1, 1, 1))
    return conv_silu.conv_silu_plain(s2, p["ws3"], p["b3"], 2, (1, 1, 1, 1))


def fused_stem(x: torch.Tensor, p) -> torch.Tensor:
    """The stem tail on (B, HX + 2*_PAD, W, C1) bf16 NHWC input with halo
    rows; returns (B, HX/2, W/2, C2) bf16 NHWC. The CPU takes the plain
    version; a CUDA tensor launches the kernel 3 times."""
    if x.ndim != 4 or x.shape[1] <= 2 * _PAD or x.shape[3] != p["wk2"].shape[2]:
        raise ValueError(f"x {tuple(x.shape)}: want (B, HX + {2 * _PAD}, W, "
                         f"{p['wk2'].shape[2]})")
    if x.device.type == "cpu":
        return fused_stem_plain(x, p)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    bsz, hp, wid, _ = x.shape
    hx = hp - 2 * _PAD
    cm, c2 = p["wk2"].shape[3], p["ws3"].shape[3]
    s1 = torch.empty((bsz, hx, wid, cm), dtype=torch.bfloat16, device=x.device)
    conv_silu.launch(x, p["wk2"], p["b1"], s1, h=hx, c=x.shape[3], stride=1,
                     pad_t=1, pad_l=1, x_row0=_PAD)
    s2 = torch.empty_like(s1)
    conv_silu.launch(s1, p["ws2"], p["b2"], s2, h=hx, c=cm, stride=1,
                     pad_t=1, pad_l=1)
    out = torch.empty((bsz, (hx - 1) // 2 + 1, (wid - 1) // 2 + 1, c2),
                      dtype=torch.bfloat16, device=x.device)
    conv_silu.launch(s2, p["ws3"], p["b3"], out, h=hx, c=cm, stride=2,
                     pad_t=1, pad_l=1)
    fused_stem.launches += 1
    return out


fused_stem.launches = 0
trace.watch("launches.fused_stem.fused_stem", fused_stem, "launches")


@dataclasses.dataclass(frozen=True)
class FusedStem(Block):
    """Stem tail (k2 phase-consume + k3/s1 + k3/s2) as one host op.

    Params: {wk2 (2, 2, C1, CM), b1, ws2 (3, 3, CM, CM), b2,
    ws3 (3, 3, CM, C2), b3} — HWIO bf16, the kernel's layout; each weight
    is the JAX packed form (`_k2_taps`, `_taps`) before its reshape."""

    c1: int     # input channels (4*c0 phase stack)
    cm: int     # mid width
    c2: int     # output channels

    @property
    def cout(self):
        return self.c2

    stride_factor = 2.0

    def init(self, gen):
        raise NotImplementedError("FusedStem params come from make_fused_stem")

    def apply(self, params, state, x, ctx):
        xh = x.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()
        y = fused_stem(xh, params)
        return y.permute(0, 3, 1, 2).to(ctx.dtype), state


def _stem_matches(plan: GraphPlan, params) -> bool:
    """Layers 0-3 = fused ConvBnAct k3 chain (s1, s2, s1, s2), default act,
    no external refs into 0-2, none of 0-2 in save."""
    if len(plan.layers) < 5:
        return False
    lp = params["layers"]
    want_s = (1, 2, 1, 2)
    for i in range(4):
        s = plan.layers[i]
        b = s.block
        if not (isinstance(b, ConvBnAct) and b.k == 3 and b.s == want_s[i]
                and b.g == 1 and b.p is None and b.act is True
                and s.n_seq == 1 and not s.is_head
                and isinstance(lp[i], dict) and "w" in lp[i] and "b" in lp[i]
                and "bn" not in lp[i]):
            return False
        if i > 0 and s.frm != -1:
            return False
    if plan.layers[0].frm != -1:
        return False
    c0 = plan.layers[0].block.c2
    cm = plan.layers[1].block.c2
    if plan.layers[1].block.c1 != c0 or plan.layers[3].block.c1 != cm:
        return False
    if plan.layers[2].block.c2 != cm or plan.layers[2].block.c1 != cm:
        return False
    if (4 * c0) % 32 or cm % 32 or plan.layers[3].block.c2 % 32:
        return False
    for j, other in enumerate(plan.layers):
        if j <= 3:
            continue
        refs = other.frm if isinstance(other.frm, tuple) else (other.frm,)
        refs = tuple(r if r >= 0 else j + r for r in refs)
        if any(r <= 2 for r in refs):
            return False
    return not any(i in plan.save for i in range(3))


def kernel_weight(w: torch.Tensor) -> torch.Tensor:
    """OIHW weight -> the kernels' contiguous HWIO bf16 layout."""
    return w.detach().permute(2, 3, 1, 0).contiguous().to(torch.bfloat16)


def pack_stem(lp, wk2_hwio) -> dict:
    """FusedStem params from the fused conv params of layers 1-3 and the
    k2 phase kernel (HWIO numpy, from `_phase_weights`)."""
    dev = lp[1]["w"].device
    vec = lambda b: b.detach().to(torch.bfloat16)  # noqa: E731
    wk2 = torch.from_numpy(wk2_hwio).to(device=dev, dtype=torch.bfloat16)
    return {"wk2": wk2, "b1": vec(lp[1]["b"]),
            "ws2": kernel_weight(lp[2]["w"]), "b2": vec(lp[2]["b"]),
            "ws3": kernel_weight(lp[3]["w"]), "b3": vec(lp[3]["b"])}


def make_fused_stem(plan: GraphPlan, params, state):
    """Rewrite the P5 stem (4 fused convs) into [k4/s2 phase conv with
    halo rows, FusedStem, passthrough x2]. Returns the inputs unchanged
    when the stem does not match (P6 ReOrg stems, unfused params)."""
    if not _stem_matches(plan, params):
        return plan, params, state
    layers = list(plan.layers)
    lp = list(params["layers"])
    ls = list(state["layers"])
    l0, l1 = layers[0].block, layers[1].block
    c0, cm = l0.c2, l1.c2
    cout = layers[3].block.c2
    dev = lp[0]["w"].device
    w4, b4, wk2 = _phase_weights(hwio(lp[0]["w"]),
                                 lp[0]["b"].detach().float().cpu().numpy(),
                                 hwio(lp[1]["w"]))
    # the phase conv emits _PAD extra output rows above and below (input
    # row pad 1 + 2*_PAD): the halo band the stem tail reads past
    layers[0] = dataclasses.replace(
        layers[0], block=PhasedConv(l0.c1, 4 * c0, (4, 4), 2,
                                    ((1 + 2 * _PAD, 1 + 2 * _PAD), (1, 1)),
                                    l0.act),
        cout=4 * c0, stride=layers[0].stride * 2)
    packed = pack_stem(lp, wk2)
    lp[0] = {"w": oihw(w4).to(dev), "b": torch.from_numpy(b4).to(dev)}
    ls[0] = {}
    layers[1] = dataclasses.replace(
        layers[1], block=FusedStem(4 * c0, cm, cout), cout=cout,
        stride=layers[1].stride * 2)
    lp[1] = packed
    ls[1] = {}
    for i in (2, 3):
        layers[i] = dataclasses.replace(
            layers[i], block=_Passthrough(cout), cout=cout, frm=-1)
        lp[i] = {}
        ls[i] = {}
    return (dataclasses.replace(plan, layers=tuple(layers)),
            {**params, "layers": lp}, {**state, "layers": ls})
