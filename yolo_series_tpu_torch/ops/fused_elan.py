"""Fused ELAN span (counterpart of `yolo_series_tpu/ops/pallas_elan.py`).

An ELAN span of the yolov7 deploy graph is n + 4 layers: two 1x1 convs of
the span input (x4, x5), a chain of n 3x3 convs from x5 (c1..cn), the
channel concat (backbone cn, c(n-2), ..., c2, x5, x4 / head cn, ..., c1,
x5, x4) and an output 1x1 conv, each conv + bias + SiLU. yolov7 and w6
have n = 4; the E-ELAN spans of yolov7-e6e have n = 6, in pairs whose
second span reads the pair's input again (not the first span's output)
and whose outputs a Shortcut adds. `make_fused_elan` rewrites every span
`find_elan_spans` finds into one FusedELAN block; its host op
`fused_elan` is n + 2 launches of the conv + SiLU kernel
(`csrc/conv_silu.cu`) that write x4, x5 and the concatenated chain
outputs straight into their channel slices of one concat buffer, so the
concat costs nothing. x5 and x4 read the same input and sit side by side
in the concat (x5 first), so one launch computes both with the merged
weight [w5 | w4] (`merge_x45`) and reads the input once. In the backbone
order the odd chain outputs are not concatenated and go to a scratch
buffer. Where a Shortcut adds the outputs of two fused spans, the second
span's output launch adds the first's output in its epilogue (the
kernel's residual) and the Shortcut becomes a passthrough.

Unlike the JAX package, which engages its kernel only where it paid on
the TPU and knows only the 4-conv chain, this rewrite applies to every
span found.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from yolo_series_tpu_torch.models.faststem import _Passthrough
from yolo_series_tpu_torch.models.graph import GraphPlan
from yolo_series_tpu_torch.models.layers import Block, Concat, ConvBnAct, Shortcut
from yolo_series_tpu_torch.obs import trace
from yolo_series_tpu_torch.ops import conv_silu
from yolo_series_tpu_torch.ops.fused_stem import kernel_weight


def chain_names(n: int) -> Tuple[str, ...]:
    """The chain convs' tensor names c1..cn."""
    return tuple(f"c{j}" for j in range(1, n + 1))


def concat_slots(order: str, ct: int, cc: int, n: int = 4) -> Tuple[Dict[str, int], int]:
    """Channel offset of each concatenated tensor, and the concat width."""
    if order == "head":
        chain = chain_names(n)[::-1]
    elif order == "backbone":
        chain = chain_names(n)[::-2]
    else:
        raise ValueError(f"order {order!r}")
    slots, off = {}, 0
    for name in chain + ("x5", "x4"):
        slots[name] = off
        off += ct if name in ("x4", "x5") else cc
    return slots, off


def _chain(p) -> int:
    """The chain length n of packed span params (wc holds c2..cn)."""
    return p["wc"].shape[0] + 1


def fused_elan_plain(x: torch.Tensor, p, order: str,
                     r: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, W, CIN) bf16 NHWC -> (B, H, W, COUT) bf16, stage by stage;
    r (B, H, W, COUT): a residual added by the output conv."""
    cs = conv_silu.conv_silu_plain
    same = (1, 1, 1, 1)
    n = _chain(p)
    names = chain_names(n)
    t = {"x4": cs(x, p["w4"], p["b4"]), "x5": cs(x, p["w5"], p["b5"])}
    t["c1"] = cs(t["x5"], p["wc0"], p["bc0"], 1, same)
    for j in range(n - 1):
        t[names[j + 1]] = cs(t[names[j]], p["wc"][j], p["bc"][j], 1, same)
    slots, _ = concat_slots(order, p["w4"].shape[3], p["wc0"].shape[3], n)
    cat = torch.cat([t[k] for k in slots], dim=-1)
    return cs(cat, p["w11"], p["b11"], r=r)


def merge_x45(p) -> dict:
    """`p` with the span's two 1x1 convs merged for one launch: w45 =
    [w5 | w4] along the output channels and b45 = [b5 | b4], the order of
    their concat slots."""
    return {**p, "w45": torch.cat([p["w5"], p["w4"]], dim=3).contiguous(),
            "b45": torch.cat([p["b5"], p["b4"]]).contiguous()}


def fused_elan(x: torch.Tensor, p, order: str,
               r: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One ELAN span on (B, H, W, CIN) bf16 NHWC; returns (B, H, W, COUT)
    bf16, plus the residual r (B, H, W, COUT) bf16 where given. The CPU
    takes the plain version; a CUDA tensor launches the kernel n + 2 times
    and needs the merged x4/x5 params of `merge_x45`."""
    cin, ct = p["w4"].shape[2], p["w4"].shape[3]
    cc, cout = p["wc0"].shape[3], p["w11"].shape[3]
    if x.ndim != 4 or x.shape[3] != cin:
        raise ValueError(f"x {tuple(x.shape)}: want (B, H, W, {cin})")
    if r is not None and r.shape != (*x.shape[:3], cout):
        raise ValueError(f"r {tuple(r.shape)}: want {(*x.shape[:3], cout)}")
    if x.device.type == "cpu":
        return fused_elan_plain(x, p, order, r)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if "w45" not in p:
        raise ValueError("fused_elan on CUDA wants the merged x4/x5 weight "
                         "'w45' (pack_span / merge_x45)")
    n = _chain(p)
    bsz, h, w, _ = x.shape
    slots, cat_w = concat_slots(order, ct, cc, n)
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
    weights = [(p["wc0"], p["bc0"])] + [(p["wc"][j], p["bc"][j]) for j in range(n - 1)]
    for name, (wj, bj) in zip(chain_names(n), weights):
        dst, doff = where(name)
        conv_silu.launch(src[0], wj, bj, dst, h=h, c=src[2], x_coff=src[1],
                         y_coff=doff, **same)
        src = (dst, doff, cc)
    out = torch.empty((bsz, h, w, cout), dtype=torch.bfloat16, device=x.device)
    conv_silu.launch(cat, p["w11"], p["b11"], out, h=h, c=cat_w, r=r, **one)
    fused_elan.launches += 1
    return out


fused_elan.launches = 0
trace.watch("launches.fused_elan.fused_elan", fused_elan, "launches")


def _nhwc_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()


@dataclasses.dataclass(frozen=True)
class FusedELAN(Block):
    """One ELAN span (2x 1x1 + n-chain 3x3 + concat + 1x1) as one host op.

    Params (HWIO bf16, the kernel's layout; each is the JAX packed form
    of `_pack_span` before its reshape): {w4, b4 (layer i), w5, b5 (layer
    i+1), wc0, bc0 (first chain conv), wc (n-1, 3, 3, cc, cc), bc (n-1, cc)
    (chain convs 2..n), w11, b11 (output conv)}, and the kernel's merged
    w45 = [w5 | w4], b45 = [b5 | b4]. With `residual` the block takes two
    inputs, the span's and a residual of its output's width, which the
    output conv adds (a folded Shortcut)."""

    c1: int
    ct: int      # 1x1 branch width
    cc: int      # chain conv width
    c2: int      # output width
    order: str   # 'backbone' | 'head'
    n: int = 4   # chained 3x3 convs
    residual: bool = False

    @property
    def cout(self):
        return self.c2

    stride_factor = 1.0

    def init(self, gen):
        raise NotImplementedError("FusedELAN params come from make_fused_elan")

    def apply(self, params, state, x, ctx):
        r = None
        if self.residual:
            x, r = x
            r = _nhwc_bf16(r)
        y = fused_elan(_nhwc_bf16(x), params, self.order, r)
        return y.permute(0, 3, 1, 2).to(ctx.dtype), state


def _is_fused_conv(spec, p, k, s):
    return (isinstance(spec.block, ConvBnAct) and spec.block.k == k
            and spec.block.s == s and spec.block.g == 1
            and spec.block.p is None and spec.block.act is True
            and spec.n_seq == 1
            and isinstance(p, dict) and "w" in p and "b" in p
            and "bn" not in p)


def _match(layers, lp, i) -> Optional[Tuple[str, int]]:
    """(order, n) of a fusable span that starts at layer i, else None: x4
    (i) and x5 (i+1) read the same layer, the previous one or any earlier
    one; an even chain of n >= 4 3x3 convs follows."""
    x4, x5 = layers[i], layers[i + 1]
    src = i - 1 if x4.frm == -1 else x4.frm
    if not (_is_fused_conv(x4, lp[i], 1, 1) and isinstance(x4.frm, int)
            and _is_fused_conv(x5, lp[i + 1], 1, 1) and x5.frm == src):
        return None
    n = 0
    while (i + 2 + n < len(layers) and _is_fused_conv(layers[i + 2 + n], lp[i + 2 + n], 3, 1)
           and layers[i + 2 + n].frm == -1):
        n += 1
    cat_i, out_i = i + 2 + n, i + 3 + n
    if (n < 4 or n % 2 or out_i >= len(layers) or type(layers[cat_i].block) is not Concat
            or not _is_fused_conv(layers[out_i], lp[out_i], 1, 1) or layers[out_i].frm != -1):
        return None
    chain = lambda ks: tuple(i + 1 + k for k in ks)  # noqa: E731  layer of c_k
    frm = layers[cat_i].frm
    if frm == (-1,) + chain(range(n - 2, 0, -2)) + (i + 1, i):
        order, n_cat = "backbone", n // 2
    elif frm == (-1,) + chain(range(n - 1, 0, -1)) + (i + 1, i):
        order, n_cat = "head", n
    else:
        return None
    cin, ct = x4.block.c1, x4.block.c2
    cc = layers[i + 2].block.c2
    out = layers[out_i].block
    shapes_ok = (x5.block.c1 == cin and x5.block.c2 == ct
                 and layers[i + 2].block.c1 == ct
                 and all(layers[i + 2 + j].block.c1 == cc and layers[i + 2 + j].block.c2 == cc
                         for j in range(1, n))
                 and out.c1 == n_cat * cc + 2 * ct
                 and cc % 32 == 0 and ct % 32 == 0 and cin % 32 == 0 and out.c2 % 16 == 0)
    # intermediates must not be referenced outside the span
    for j, other in enumerate(layers):
        if i <= j <= out_i:
            continue
        refs = other.frm if isinstance(other.frm, tuple) else (other.frm,)
        if any(i <= r < out_i for r in refs):
            return None
    return (order, n) if shapes_ok else None


def span_chains(plan: GraphPlan, params) -> Tuple[Tuple[int, str, int], ...]:
    """(start_index, order, n) for every fusable ELAN span i..i+n+3."""
    layers = plan.layers
    lp = params["layers"]
    spans = []
    i = 1
    while i + 7 < len(layers):
        found = _match(layers, lp, i)
        if found is None:
            i += 1
            continue
        spans.append((i, *found))
        i += found[1] + 4
    return tuple(spans)


def find_elan_spans(plan: GraphPlan, params) -> Tuple[Tuple[int, str], ...]:
    """(start_index, order) for every fusable ELAN span (`span_chains`
    without the chain lengths: the JAX package's finder's form)."""
    return tuple((i, order) for i, order, _ in span_chains(plan, params))


def pack_span(lp, i, n: int = 4) -> dict:
    """Fused params of layers i..i+n+3 -> FusedELAN params (HWIO bf16)."""
    p = [lp[i + j] for j in range(n + 4)]
    vec = lambda b: b.detach().to(torch.bfloat16)  # noqa: E731
    return merge_x45({
        "w4": kernel_weight(p[0]["w"]), "b4": vec(p[0]["b"]),
        "w5": kernel_weight(p[1]["w"]), "b5": vec(p[1]["b"]),
        "wc0": kernel_weight(p[2]["w"]), "bc0": vec(p[2]["b"]),
        "wc": torch.stack([kernel_weight(p[j]["w"]) for j in range(3, n + 2)]),
        "bc": torch.stack([vec(p[j]["b"]) for j in range(3, n + 2)]),
        "w11": kernel_weight(p[n + 3]["w"]), "b11": vec(p[n + 3]["b"]),
    })


def _fold_shortcuts(layers, lp, ls, save) -> int:
    """Fold each Shortcut(-1, k) that adds the outputs of two FusedELAN
    blocks of one width, the first the layer before it and read by nothing
    else, into that block as its residual; the Shortcut becomes a
    passthrough. Returns how many were folded."""
    folded = 0
    for s, spec in enumerate(layers):
        if not (isinstance(spec.block, Shortcut) and isinstance(spec.frm, tuple)
                and len(spec.frm) == 2 and spec.frm[0] == -1 and s > 0):
            continue
        prev, k = layers[s - 1], spec.frm[1]
        if not (isinstance(prev.block, FusedELAN) and not prev.block.residual
                and prev.frm == -1 and 0 <= k < s - 1
                and isinstance(layers[k].block, FusedELAN)
                and prev.block.c2 == layers[k].block.c2 == spec.block.cout
                and s - 1 not in save):
            continue
        layers[s - 1] = dataclasses.replace(
            prev, block=dataclasses.replace(prev.block, residual=True), frm=(-1, k))
        layers[s] = dataclasses.replace(spec, block=_Passthrough(spec.block.cout), frm=-1)
        lp[s] = {}
        ls[s] = {}
        folded += 1
    return folded


def make_fused_elan(plan: GraphPlan, params, state):
    """Rewrite every fusable ELAN span into a FusedELAN block, and fold the
    Shortcuts that add two of them. Apply after fuse_model (+ the stem
    transforms). Returns the inputs unchanged when no span matches
    (training form, other cfgs).

    Layers i..i+n+2 become passthroughs, the first reading what x4 read,
    so the block at i+n+3 gets the span's input: the previous layer's
    output, or, for the second span of an E-ELAN pair, the pair's input.
    `make_fused_elan.spans` and `.shortcuts` count what the rewrites of
    this process fused and folded."""
    chains = span_chains(plan, params)
    if not chains:
        return plan, params, state
    new_layers = list(plan.layers)
    lp = list(params["layers"])
    ls = list(state["layers"])
    for i, order, n in chains:
        blk = new_layers[i].block
        cin, ct = blk.c1, blk.c2
        cc = new_layers[i + 2].block.c2
        end = i + n + 3
        cout = new_layers[end].block.c2
        packed = pack_span(lp, i, n)
        src = new_layers[i].frm
        for j in range(i, end):
            new_layers[j] = dataclasses.replace(
                new_layers[j], block=_Passthrough(cin), cout=cin, frm=src if j == i else -1)
            lp[j] = {}
            ls[j] = {}
        new_layers[end] = dataclasses.replace(
            new_layers[end], block=FusedELAN(cin, ct, cc, cout, order, n), frm=-1)
        lp[end] = packed
        ls[end] = {}
    folded = _fold_shortcuts(new_layers, lp, ls, plan.save)
    make_fused_elan.spans += len(chains)
    make_fused_elan.shortcuts += folded
    return (dataclasses.replace(plan, layers=tuple(new_layers)),
            {**params, "layers": lp}, {**state, "layers": ls})


make_fused_elan.spans = 0
make_fused_elan.shortcuts = 0
trace.watch("fused_elan.spans", make_fused_elan, "spans")
trace.watch("fused_elan.shortcuts", make_fused_elan, "shortcuts")
