"""Lane alignment of unaligned concats (counterpart of
`yolo_series_tpu/models/lanealign.py`).

The JAX pass was written for the TPU, whose tiles hold 128 channels: a
concat whose tap boundaries are not multiples of 128 lowers there to
lane-shift copies. The pass makes the padding explicit: every ConvBnAct
that feeds an unaligned concat gets `ceil(c / 128) * 128 - c` extra output
channels that are exactly zero, and every consumer of a padded tensor gets
matching zero rows in its kernel, so each tap starts on a multiple of 128
channels. It is an exact identity, and the port keeps it as the plan
transform it is; no entry point of either package applies it.

Exactness: a pad channel is zero through the conv (zero kernel columns),
through BN in training (batch mean 0, variance 0, scale 0, bias 0) and in
inference ((0 - 0) * rsqrt(1 + eps) * 0 + 0), and through any activation
with f(0) = 0; zero kernel rows make the consumers ignore it. The param
and state trees are untouched: the padding is built from them inside
`apply`, and the running stats are computed padded and sliced back.

Reference behaviour re-expressed: models/common.py:56 (Concat) of
common.py:99 (Conv) outputs, routed as in cfg/training/yolov7-w6.yaml.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from yolo_series_tpu_torch.models import layers as L
from yolo_series_tpu_torch.models.graph import GraphPlan
from yolo_series_tpu_torch.models.layers import Block, ConvBnAct

LANE = 128

# activations with f(0) == 0: zero pad channels stay zero through them
_ZERO_FIXED_ACTS = {True, False, None, "silu", "relu", "lrelu", "leakyrelu",
                    "mish", "identity", "none"}


def _act_zero_fixed(act) -> bool:
    if isinstance(act, str):
        return act.lower() in _ZERO_FIXED_ACTS
    return act in _ZERO_FIXED_ACTS


def _pad_to_lane(c: int) -> int:
    return (-c) % LANE


@dataclasses.dataclass(frozen=True)
class LaneAlignedConv(Block):
    """A ConvBnAct with zero channels inserted in its input and/or appended
    to its output inside `apply`; its param and state trees are `conv`'s.

    in_segments: ((real, pad), ...) over the padded input: each segment's
    real channels are read, its pad channels get zero kernel rows.
    out_pad: zero output channels appended (zero kernel columns, BN scale,
    bias and mean zero, variance one)."""

    conv: ConvBnAct
    in_segments: Tuple[Tuple[int, int], ...]
    out_pad: int = 0

    @property
    def cout(self):
        return self.conv.c2 + self.out_pad

    @property
    def stride_factor(self):
        return self.conv.stride_factor

    def init(self, gen):
        return self.conv.init(gen)

    def _strip_input(self, x):
        """The padded input back to the conv's own channels (the observer
        and int8 paths only)."""
        parts, off = [], 0
        for real, pad in self.in_segments:
            parts.append(x[:, off:off + real])
            off += real + pad
        return parts[0] if len(parts) == 1 else torch.cat(parts, 1)

    def apply(self, params, state, x, ctx):
        if ctx.observer is not None or "wq" in params:
            # calibration and the int8 form run the conv's own semantics on
            # the real channels (what int8_conv sees), then pad the output
            y, ns = self.conv.apply(params, state, self._strip_input(x), ctx)
            if self.out_pad:
                y = torch.nn.functional.pad(y, (0, 0, 0, 0, 0, self.out_pad))
            return y, ns

        c2 = self.conv.c2
        w = params["w"]                                   # OIHW
        if any(p for _, p in self.in_segments):
            parts, off = [], 0
            for real, pad in self.in_segments:
                parts.append(w[:, off:off + real])
                off += real
                if pad:
                    parts.append(w.new_zeros((c2, pad, *w.shape[2:])))
            w = torch.cat(parts, 1)
        if self.out_pad:
            w = torch.cat([w, w.new_zeros((self.out_pad, *w.shape[1:]))], 0)

        cin_pad = sum(r + p for r, p in self.in_segments)
        inner = dataclasses.replace(self.conv, c1=cin_pad, c2=c2 + self.out_pad)
        pp = {"w": w}
        ps = state
        if "bn" in params:
            pp["bn"] = params["bn"]
            if self.out_pad:
                z = params["bn"]["scale"].new_zeros((self.out_pad,))
                pp["bn"] = {"scale": torch.cat([params["bn"]["scale"], z]),
                            "bias": torch.cat([params["bn"]["bias"], z])}
                ps = {"bn": {"mean": torch.cat([state["bn"]["mean"], z]),
                             "var": torch.cat([state["bn"]["var"], torch.ones_like(z)])}}
        if "b" in params:
            b = params["b"]
            pp["b"] = torch.cat([b, b.new_zeros((self.out_pad,))]) if self.out_pad else b
        y, ns = inner.apply(pp, ps, x, ctx)
        if self.out_pad and "bn" in params:
            ns = {"bn": {k: v[:c2] for k, v in ns["bn"].items()}}
        return y, ns


def _refs(spec, j):
    frm = spec.frm
    if isinstance(frm, tuple):
        return [j - 1 if r == -1 else r for r in frm]
    return [j - 1 if frm == -1 else frm]


def _plain_conv(spec) -> bool:
    return (not spec.is_head and spec.n_seq == 1
            and isinstance(spec.block, ConvBnAct) and spec.block.g == 1)


def make_lane_align(plan: GraphPlan) -> GraphPlan:
    """Zero-pad the taps of every lane-misaligned Concat to multiples of
    128 channels and give its consumers matching zero kernel rows.
    Plan-only and exact. Returns the plan unchanged when every concat is
    aligned or no pattern matches. Composes with the fast stems."""
    layers = list(plan.layers)
    n = len(layers)
    consumers = {i: [] for i in range(n)}
    for j, spec in enumerate(layers):
        for r in _refs(spec, j):
            if 0 <= r < n:
                consumers[r].append(j)

    out_pad = {}        # layer index -> pad channels appended
    new_cins = {}       # concat index -> its padded taps
    for i, spec in enumerate(layers):
        blk = spec.block
        if (not isinstance(blk, L.Concat) or spec.is_head or spec.n_seq != 1
                or not isinstance(spec.frm, tuple)):
            continue
        cins = tuple(blk.cins)
        bounds = [sum(cins[:k]) for k in range(1, len(cins) + 1)]
        if all(b % LANE == 0 for b in bounds):
            continue
        srcs = tuple(i - 1 if r == -1 else r for r in spec.frm)
        if len(srcs) != len(cins) or any(s < 0 for s in srcs):
            continue
        ok = True
        for s, c in zip(srcs, cins):
            if c % LANE == 0:
                continue
            sp = layers[s]
            # every consumer of a padded tap must absorb the padding: a
            # plain conv (zero rows) or this concat
            if not (_plain_conv(sp) and _act_zero_fixed(sp.block.act) and sp.cout == c
                    and all(j == i or _plain_conv(layers[j]) for j in consumers[s])):
                ok = False
                break
        if not ok or not all(_plain_conv(layers[j]) for j in consumers[i]):
            continue
        for s, c in zip(srcs, cins):
            if c % LANE:
                out_pad[s] = _pad_to_lane(c)
        new_cins[i] = tuple(c + _pad_to_lane(c) for c in cins)

    if not out_pad:
        return plan

    def seg_of(r):
        """The (real, pad) segments of layer r's padded output."""
        if r in new_cins:
            return tuple((c, _pad_to_lane(c)) for c in layers[r].block.cins)
        return ((layers[r].cout, out_pad.get(r, 0)),)

    new_layers = list(layers)
    for j, spec in enumerate(layers):
        if isinstance(spec.block, L.Concat):
            if j in new_cins:
                new_layers[j] = dataclasses.replace(spec, block=L.Concat(new_cins[j]),
                                                    cout=sum(new_cins[j]))
            continue
        refs = _refs(spec, j)
        touched = any(r in out_pad or r in new_cins for r in refs)
        if not touched and j not in out_pad:
            continue
        if touched:
            if not (len(refs) == 1 and _plain_conv(spec)):
                raise AssertionError(f"lane_align: layer {j} reads a padded input but is "
                                     "not a plain conv")
            segs = seg_of(refs[0])
        else:
            segs = ((spec.block.c1, 0),)
        pad = out_pad.get(j, 0)
        new_layers[j] = dataclasses.replace(
            spec, block=LaneAlignedConv(spec.block, segs, pad), cout=spec.block.c2 + pad)
    return dataclasses.replace(plan, layers=tuple(new_layers))
