"""Fused ELAN span (counterpart of `yolo_series_tpu/ops/pallas_elan.py`).

An ELAN span of the yolov7 deploy graph is 8 layers: two 1x1 convs of
the span input (x4, x5), four chained 3x3 convs from x5 (c1..c4), the
channel concat (backbone c4,c2,x5,x4 / head c4,c3,c2,c1,x5,x4) and an
output 1x1 conv, each conv + bias + SiLU. `make_fused_elan` rewrites every
span `find_elan_spans` finds into one FusedELAN block; its host op
`fused_elan` is 6 launches of the conv + SiLU kernel
(`csrc/conv_silu.cu`) that write x4, x5 and c1..c4 straight into their
channel slices of one concat buffer, so the concat costs nothing. x5 and
x4 read the same input and sit side by side in the concat (x5 first), so
one launch computes both with the merged weight [w5 | w4] (`merge_x45`)
and reads the input once. In the backbone order c1 and c3 are not
concatenated and go to a scratch buffer.

Unlike the JAX package, which engages its kernel only where it paid on
the TPU, this rewrite applies to every span found.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from yolo_series_tpu_torch.models.faststem import _Passthrough
from yolo_series_tpu_torch.models.graph import GraphPlan
from yolo_series_tpu_torch.models.layers import Block, Concat, ConvBnAct
from yolo_series_tpu_torch.obs import trace
from yolo_series_tpu_torch.ops import conv_silu
from yolo_series_tpu_torch.ops.fused_stem import kernel_weight

_CHAIN = ("c1", "c2", "c3", "c4")


def concat_slots(order: str, ct: int, cc: int) -> Tuple[Dict[str, int], int]:
    """Channel offset of each concatenated tensor, and the concat width."""
    if order == "head":
        names = ("c4", "c3", "c2", "c1", "x5", "x4")
    elif order == "backbone":
        names = ("c4", "c2", "x5", "x4")
    else:
        raise ValueError(f"order {order!r}")
    slots, off = {}, 0
    for n in names:
        slots[n] = off
        off += ct if n in ("x4", "x5") else cc
    return slots, off


def fused_elan_plain(x: torch.Tensor, p, order: str) -> torch.Tensor:
    """(B, H, W, CIN) bf16 NHWC -> (B, H, W, COUT) bf16, stage by stage."""
    cs = conv_silu.conv_silu_plain
    same = (1, 1, 1, 1)
    t = {"x4": cs(x, p["w4"], p["b4"]), "x5": cs(x, p["w5"], p["b5"])}
    t["c1"] = cs(t["x5"], p["wc0"], p["bc0"], 1, same)
    for j in range(3):
        t[_CHAIN[j + 1]] = cs(t[_CHAIN[j]], p["wc"][j], p["bc"][j], 1, same)
    slots, _ = concat_slots(order, p["w4"].shape[3], p["wc0"].shape[3])
    cat = torch.cat([t[n] for n in slots], dim=-1)
    return cs(cat, p["w11"], p["b11"])


def merge_x45(p) -> dict:
    """`p` with the span's two 1x1 convs merged for one launch: w45 =
    [w5 | w4] along the output channels and b45 = [b5 | b4], the order of
    their concat slots."""
    return {**p, "w45": torch.cat([p["w5"], p["w4"]], dim=3).contiguous(),
            "b45": torch.cat([p["b5"], p["b4"]]).contiguous()}


def fused_elan(x: torch.Tensor, p, order: str) -> torch.Tensor:
    """One ELAN span on (B, H, W, CIN) bf16 NHWC; returns (B, H, W, COUT)
    bf16. The CPU takes the plain version; a CUDA tensor launches the
    kernel 6 times and needs the merged x4/x5 params of `merge_x45`."""
    cin, ct = p["w4"].shape[2], p["w4"].shape[3]
    cc, cout = p["wc0"].shape[3], p["w11"].shape[3]
    if x.ndim != 4 or x.shape[3] != cin:
        raise ValueError(f"x {tuple(x.shape)}: want (B, H, W, {cin})")
    if x.device.type == "cpu":
        return fused_elan_plain(x, p, order)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if "w45" not in p:
        raise ValueError("fused_elan on CUDA wants the merged x4/x5 weight "
                         "'w45' (pack_span / merge_x45)")
    bsz, h, w, _ = x.shape
    slots, cat_w = concat_slots(order, ct, cc)
    cat = torch.empty((bsz, h, w, cat_w), dtype=torch.bfloat16, device=x.device)
    scratch = (None if order == "head" else
               torch.empty((bsz, h, w, cc), dtype=torch.bfloat16, device=x.device))

    def where(name):  # (buffer, channel offset) that holds a chain tensor
        return (cat, slots[name]) if name in slots else (scratch, 0)

    one = dict(stride=1, pad_t=0, pad_l=0)
    same = dict(stride=1, pad_t=1, pad_l=1)
    conv_silu.launch(x, p["w45"], p["b45"], cat, h=h, c=cin,
                     y_coff=slots["x5"], **one)
    src = (cat, slots["x5"], ct)
    weights = [(p["wc0"], p["bc0"])] + [(p["wc"][j], p["bc"][j]) for j in range(3)]
    for name, (wj, bj) in zip(_CHAIN, weights):
        dst, doff = where(name)
        conv_silu.launch(src[0], wj, bj, dst, h=h, c=src[2], x_coff=src[1],
                         y_coff=doff, **same)
        src = (dst, doff, cc)
    out = torch.empty((bsz, h, w, cout), dtype=torch.bfloat16, device=x.device)
    conv_silu.launch(cat, p["w11"], p["b11"], out, h=h, c=cat_w, **one)
    fused_elan.launches += 1
    return out


fused_elan.launches = 0
trace.watch("launches.fused_elan.fused_elan", fused_elan, "launches")


@dataclasses.dataclass(frozen=True)
class FusedELAN(Block):
    """One ELAN span (2x 1x1 + 4-chain 3x3 + concat + 1x1) as one host op.

    Params (HWIO bf16, the kernel's layout; each is the JAX packed form
    of `_pack_span` before its reshape): {w4, b4 (layer i), w5, b5 (layer
    i+1), wc0, bc0 (first chain conv), wc (3, 3, 3, cc, cc), bc (3, cc)
    (chain convs 2-4), w11, b11 (output conv)}, and the kernel's merged
    w45 = [w5 | w4], b45 = [b5 | b4]."""

    c1: int
    ct: int      # 1x1 branch width
    cc: int      # chain conv width
    c2: int      # output width
    order: str   # 'backbone' | 'head'

    @property
    def cout(self):
        return self.c2

    stride_factor = 1.0

    def init(self, gen):
        raise NotImplementedError("FusedELAN params come from make_fused_elan")

    def apply(self, params, state, x, ctx):
        xh = x.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()
        y = fused_elan(xh, params, self.order)
        return y.permute(0, 3, 1, 2).to(ctx.dtype), state


def _is_fused_conv(spec, p, k, s):
    return (isinstance(spec.block, ConvBnAct) and spec.block.k == k
            and spec.block.s == s and spec.block.g == 1
            and spec.block.p is None and spec.block.act is True
            and spec.n_seq == 1
            and isinstance(p, dict) and "w" in p and "b" in p
            and "bn" not in p)


def find_elan_spans(plan: GraphPlan, params) -> Tuple[Tuple[int, str], ...]:
    """(start_index, order) for every fusable ELAN span i..i+7."""
    layers = plan.layers
    lp = params["layers"]
    spans = []
    i = 1
    while i + 7 < len(layers):
        s = layers[i]
        ok = (_is_fused_conv(s, lp[i], 1, 1) and s.frm == -1
              and _is_fused_conv(layers[i + 1], lp[i + 1], 1, 1)
              and layers[i + 1].frm in (i - 1, -2)
              and all(_is_fused_conv(layers[i + 2 + j], lp[i + 2 + j], 3, 1)
                      and layers[i + 2 + j].frm == -1 for j in range(4))
              and type(layers[i + 6].block) is Concat
              and _is_fused_conv(layers[i + 7], lp[i + 7], 1, 1)
              and layers[i + 7].frm == -1)
        if not ok:
            i += 1
            continue
        frm = layers[i + 6].frm
        if frm == (-1, i + 3, i + 1, i):
            order = "backbone"
        elif frm == (-1, i + 4, i + 3, i + 2, i + 1, i):
            order = "head"
        else:
            i += 1
            continue
        cin = s.block.c1
        ct = s.block.c2
        cc = layers[i + 2].block.c2
        cat = (4 * cc + 2 * ct) if order == "head" else (2 * cc + 2 * ct)
        shapes_ok = (layers[i + 1].block.c1 == cin
                     and layers[i + 1].block.c2 == ct
                     and layers[i + 2].block.c1 == ct
                     and all(layers[i + 2 + j].block.c1 == cc
                             and layers[i + 2 + j].block.c2 == cc
                             for j in range(1, 4))
                     and layers[i + 2].block.c2 == cc
                     and layers[i + 7].block.c1 == cat
                     and cc % 32 == 0 and ct % 32 == 0 and cin % 32 == 0)
        # intermediates must not be referenced outside the span
        external = False
        for j, other in enumerate(layers):
            if i <= j <= i + 7:
                continue
            refs = other.frm if isinstance(other.frm, tuple) else (other.frm,)
            if any(i <= r <= i + 6 for r in refs):
                external = True
                break
        if shapes_ok and not external:
            spans.append((i, order))
            i += 8
        else:
            i += 1
    return tuple(spans)


def pack_span(lp, i) -> dict:
    """Fused params of layers i..i+7 -> FusedELAN params (HWIO bf16)."""
    p = [lp[i + j] for j in range(8)]
    vec = lambda b: b.detach().to(torch.bfloat16)  # noqa: E731
    return merge_x45({
        "w4": kernel_weight(p[0]["w"]), "b4": vec(p[0]["b"]),
        "w5": kernel_weight(p[1]["w"]), "b5": vec(p[1]["b"]),
        "wc0": kernel_weight(p[2]["w"]), "bc0": vec(p[2]["b"]),
        "wc": torch.stack([kernel_weight(p[j]["w"]) for j in (3, 4, 5)]),
        "bc": torch.stack([vec(p[j]["b"]) for j in (3, 4, 5)]),
        "w11": kernel_weight(p[7]["w"]), "b11": vec(p[7]["b"]),
    })


def make_fused_elan(plan: GraphPlan, params, state):
    """Rewrite every fusable ELAN span into a FusedELAN block. Apply after
    fuse_model (+ the stem transforms). Returns the inputs unchanged when
    no span matches (training form, other cfgs)."""
    spans = find_elan_spans(plan, params)
    if not spans:
        return plan, params, state
    new_layers = list(plan.layers)
    lp = list(params["layers"])
    ls = list(state["layers"])
    for i, order in spans:
        blk = new_layers[i].block
        cin, ct = blk.c1, blk.c2
        cc = new_layers[i + 2].block.c2
        cout = new_layers[i + 7].block.c2
        packed = pack_span(lp, i)
        for j in range(i, i + 7):
            new_layers[j] = dataclasses.replace(
                new_layers[j], block=_Passthrough(cin), cout=cin, frm=-1)
            lp[j] = {}
            ls[j] = {}
        new_layers[i + 7] = dataclasses.replace(
            new_layers[i + 7], block=FusedELAN(cin, ct, cc, cout, order),
            frm=-1)
        lp[i + 7] = packed
        ls[i + 7] = {}
    return (dataclasses.replace(plan, layers=tuple(new_layers)),
            {**params, "layers": lp}, {**state, "layers": ls})
