"""Fast-stem deploy transform: fold the first conv pairs into phase space
(counterpart of the deploy side of `yolo_series_tpu/models/faststem.py`).

Layer 0 (k3/s1, C -> c0) becomes a k4/s2 conv that emits the 4 output
phases stacked in channels (C -> 4*c0), and layer 1 (k3/s2, c0 -> c1) a
k2 conv over that phase layout with asymmetric (1, 0) padding. The fold
is an exact reshuffle of the weights; downstream layers are untouched.
`PhasedConv` applies the folded convs' own activation (SiLU, LeakyReLU or
any other of `layers.get_activation`). Apply after `reparam.fuse_model`
(it needs {w, b} conv forms).

The training side (`make_train_fast_stem`) folds the same pairs, and the
P6 stem's [ReOrg, k3/s1 conv] into one 6x6/s2 conv, in the train step's
plan only: `TrainPhasedConvA`, `TrainPhasedConvB` and `TrainReorgConv`
keep the original ConvBnAct's param and state trees and build the phase
kernels from them inside `apply`, so gradients reach the original weights
and checkpoints, the EMA and the optimizer see the same trees.
`TrainPhasedConvA`'s BN takes its moments over the batch, the four phases
and the map, as the unfolded conv's BN does over the full map: JAX's
one-pass moments about the running mean, synced over `Ctx.group`
(SyncBN); with `Ctx.bn_shards` > 1 each replica's own two-pass moments, as
`layers._batch_norm_per_replica` takes them, so the fold equals the
unfolded step there too (the JAX block ignores `bn_shards`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from yolo_series_tpu_torch.models.graph import GraphPlan
from yolo_series_tpu_torch.models.layers import (BN_EPS, Block, ConvBnAct, ReOrg, _running,
                                                 batch_norm, conv2d, get_activation)
from yolo_series_tpu_torch.parallel.dist import world_size

_PHASES = ((0, 0), (1, 0), (0, 1), (1, 1))


def hwio(w: torch.Tensor) -> np.ndarray:
    """OIHW tensor -> HWIO fp32 numpy array."""
    return w.detach().float().permute(2, 3, 1, 0).cpu().numpy()


def oihw(w: np.ndarray) -> torch.Tensor:
    """HWIO numpy array -> OIHW fp32 tensor."""
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


@dataclasses.dataclass(frozen=True)
class PhasedConv(Block):
    """Plain fused conv + act with any kernel, stride and padding."""

    c1: int
    c2: int
    k: Tuple[int, int]
    s: int
    pad: Tuple[Tuple[int, int], Tuple[int, int]]
    act: Any = True

    @property
    def cout(self):
        return self.c2

    @property
    def stride_factor(self):
        return float(self.s)

    def init(self, gen):
        raise NotImplementedError("PhasedConv params come from the transform")

    def apply(self, params, state, x, ctx):
        _, fn = get_activation(self.act)
        return fn(conv2d(x, params["w"], params["b"], self.s, self.pad, 1,
                         ctx.dtype)), state


def _phase_weights(w0: np.ndarray, b0: np.ndarray, w1: np.ndarray):
    """HWIO (3,3,C,c0), (c0,), (3,3,c0,c1) -> HWIO k4 and k2 phase kernels."""
    c_in, c0 = w0.shape[2], w0.shape[3]
    c1 = w1.shape[3]
    w4 = np.zeros((4, 4, c_in, 4 * c0), np.float32)
    for pi, (a, b) in enumerate(_PHASES):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                w4[a + dy + 1, b + dx + 1, :, pi * c0:(pi + 1) * c0] = \
                    w0[dy + 1, dx + 1]
    b4 = np.tile(b0, 4)
    w2 = np.zeros((2, 2, 4 * c0, c1), np.float32)
    for ci, (c, d) in enumerate(_PHASES):
        for r in range(2):
            for s in range(2):
                dy = 2 * r + c - 2
                dx = 2 * s + d - 2
                if -1 <= dy <= 1 and -1 <= dx <= 1:
                    w2[r, s, ci * c0:(ci + 1) * c0, :] = w1[dy + 1, dx + 1]
    return w4, b4, w2


def _pair_matches(plan, params, i):
    layers = plan.layers
    if i + 1 >= len(layers) or layers[i].is_head or layers[i + 1].is_head:
        return False
    l0, l1 = layers[i].block, layers[i + 1].block
    p0, p1 = params["layers"][i], params["layers"][i + 1]
    return (isinstance(l0, ConvBnAct) and isinstance(l1, ConvBnAct)
            and l0.k == 3 and l0.s == 1 and l1.k == 3 and l1.s == 2
            and l0.g == 1 and l1.g == 1 and l0.p is None and l1.p is None
            and isinstance(p0, dict) and isinstance(p1, dict)
            and "w" in p0 and "b" in p0 and "w" in p1 and "b" in p1
            and layers[i].frm == -1 and layers[i + 1].frm == -1
            and i not in plan.save)


@dataclasses.dataclass(frozen=True)
class _Passthrough(Block):
    """Stands in for a layer a transform folded into its neighbour:
    forwards x unchanged."""

    c1: int

    @property
    def cout(self):
        return self.c1

    stride_factor = 1.0

    def init(self, gen):
        return {}, {}

    def apply(self, params, state, x, ctx):
        return x, state


def make_fast_stem(plan: GraphPlan, params, state, max_pairs: int = 1):
    """Fold up to `max_pairs` consecutive (k3/s1, k3/s2) conv pairs into
    phase space, scanning from layer 0. Returns the inputs unchanged when
    no pair matches (non-P5 stem / unfused params)."""
    new_layers = list(plan.layers)
    lp = list(params["layers"])
    folded = 0
    i = 0
    while i + 1 < len(new_layers) and folded < max_pairs:
        if not _pair_matches(dataclasses.replace(plan, layers=tuple(new_layers)),
                             {"layers": lp}, i):
            i += 1
            continue
        l0, l1 = new_layers[i].block, new_layers[i + 1].block
        p0, p1 = lp[i], lp[i + 1]
        dev = p0["w"].device
        w4, b4, w2 = _phase_weights(hwio(p0["w"]),
                                    p0["b"].detach().float().cpu().numpy(),
                                    hwio(p1["w"]))
        blk0 = PhasedConv(l0.c1, 4 * l0.c2, (4, 4), 2, ((1, 1), (1, 1)), l0.act)
        blk1 = PhasedConv(4 * l0.c2, l1.c2, (2, 2), 1, ((1, 0), (1, 0)), l1.act)
        new_layers[i] = dataclasses.replace(new_layers[i], block=blk0,
                                            cout=4 * l0.c2,
                                            stride=new_layers[i].stride * 2)
        new_layers[i + 1] = dataclasses.replace(new_layers[i + 1], block=blk1)
        lp[i] = {"w": oihw(w4).to(dev), "b": torch.from_numpy(b4).to(dev)}
        lp[i + 1] = {"w": oihw(w2).to(dev), "b": p1["b"]}
        folded += 1
        i += 2
    if folded == 0:
        return plan, params, state
    return (dataclasses.replace(plan, layers=tuple(new_layers)),
            {**params, "layers": lp}, state)


def _pmean_diff(t, group):
    """The mean of t over the group's ranks, differentiable: its backward
    sums the ranks' cotangents, as JAX's `pmean` does (the moments of every
    rank's slice reach every rank's output)."""
    if group is None:
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t.contiguous(), group=group) / world_size(group)


def _phase_w4(w0):
    """OIHW (c0, C, 3, 3) -> the (4*c0, C, 4, 4) phase kernel as a traced,
    differentiable op: phase (a, b)'s block is w0 placed at rows a..a+2,
    columns b..b+2."""
    return torch.cat([torch.nn.functional.pad(w0, (b, 1 - b, a, 1 - a))
                      for a, b in _PHASES], 0)


def _phase_w2(w1):
    """OIHW (c1, c0, 3, 3) -> the (c1, 4*c0, 2, 2) phase-consuming kernel
    (traced): tap (r, s) of phase (c, d) is w1's (2r + c - 1, 2s + d - 1),
    zero where that lies outside the 3x3."""
    zero = w1.new_zeros(w1.shape[:2])
    blocks = []
    for c, d in _PHASES:
        rows = []
        for r in range(2):
            dy = 2 * r + c - 2
            rows.append(torch.stack([
                w1[:, :, dy + 1, 2 * s + d - 1] if -1 <= dy <= 1 and -1 <= 2 * s + d - 2 <= 1
                else zero for s in range(2)], -1))
        blocks.append(torch.stack(rows, -2))
    return torch.cat(blocks, 1)


@dataclasses.dataclass(frozen=True)
class TrainPhasedConvA(Block):
    """The pair's first conv (k3/s1 ConvBnAct) folded for training: a k4/s2
    conv emits the 4 output phases stacked in channels (c2 -> 4*c2). Param
    and state trees are the original ConvBnAct's ({w (c2, c1, 3, 3), bn},
    bn state (c2,)); the BN moments go over the phase axis too, which is
    the original map's spatial reduction (module docstring)."""

    c1: int
    c2: int
    act: Any = True

    @property
    def cout(self):
        return 4 * self.c2

    stride_factor = 2.0

    def init(self, gen):
        return ConvBnAct(self.c1, self.c2, 3, 1, None, 1, self.act).init(gen)

    def apply(self, params, state, x, ctx):
        y = conv2d(x, _phase_w4(params["w"]), None, 2, ((1, 1), (1, 1)), 1, ctx.dtype)
        bnp, bns = params["bn"], state["bn"]
        if ctx.training:
            b_, _, h_, w_ = y.shape
            world = world_size(ctx.group)
            yf = y.float()
            m0 = bns["mean"].detach()
            if ctx.bn_shards > 1:
                if ctx.bn_shards % world:
                    raise ValueError(f"{ctx.bn_shards} BN groups do not split over "
                                     f"{world} ranks")
                g = ctx.bn_shards // world
                if b_ % g:
                    raise ValueError(f"batch {b_} does not split into {g} BN groups")
                rg = yf.reshape(g, b_ // g, 4, self.c2, h_, w_)
                axes = (1, 2, 4, 5)
                mean = rg.mean(axes)                                   # (g, c2)
                var = (rg - mean[:, None, None, :, None, None]).square().mean(axes)
                new_bns = _running(bns, mean[0], var[0], (b_ // g) * 4 * h_ * w_)
                inv = torch.rsqrt(var + BN_EPS) * bnp["scale"]
                yn = ((rg - mean[:, None, None, :, None, None])
                      * inv[:, None, None, :, None, None]
                      + bnp["bias"][:, None, None]).reshape(y.shape)
                _, fn = get_activation(self.act)
                return fn(yn).to(y.dtype), {"bn": new_bns}
            r = yf.reshape(b_, 4, self.c2, h_, w_) - m0[:, None, None]
            axes = (0, 1, 3, 4)
            mc, msq = _pmean_diff(torch.stack([r.mean(axes), r.square().mean(axes)]),
                                  ctx.group)
            mean = bns["mean"] + mc
            var = torch.clamp(msq - mc.square(), min=0.0)
            new_bns = _running(bns, mean, var, b_ * 4 * h_ * w_ * world)
        else:
            mean, var = bns["mean"], bns["var"]
            new_bns = bns
        inv = torch.rsqrt(var + BN_EPS) * bnp["scale"]
        # the scale and shift tiled over the 4 phases
        yn = ((y.float() - mean.repeat(4)[:, None, None]) * inv.repeat(4)[:, None, None]
              + bnp["bias"].repeat(4)[:, None, None])
        _, fn = get_activation(self.act)
        return fn(yn).to(y.dtype), {"bn": new_bns}


@dataclasses.dataclass(frozen=True)
class TrainPhasedConvB(Block):
    """The pair's second conv (k3/s2 ConvBnAct) folded for training: a k2/s1
    conv over the phase layout with (1, 0) padding, emitting the standard
    stride-2 map. Param and state trees are the original ConvBnAct's."""

    c1: int
    c2: int
    act: Any = True

    @property
    def cout(self):
        return self.c2

    stride_factor = 1.0

    def init(self, gen):
        return ConvBnAct(self.c1 // 4, self.c2, 3, 2, None, 1, self.act).init(gen)

    def apply(self, params, state, x, ctx):
        y = conv2d(x, _phase_w2(params["w"]), None, 1, ((1, 0), (1, 0)), 1, ctx.dtype)
        y, new_bns = batch_norm(params["bn"], state["bn"], y, ctx)
        _, fn = get_activation(self.act)
        return fn(y), {"bn": new_bns}


def _reorg_w6(w3):
    """OIHW (c2, 4*C, 3, 3) conv-after-ReOrg kernel -> the (c2, C, 6, 6)
    stride-2 kernel on the raw image (traced): tap (2*di + a + 2, 2*dj + b
    + 2) carries w3[:, p*C:(p+1)*C, di + 1, dj + 1] for ReOrg's phase p =
    (a, b) = ((0, 0), (1, 0), (0, 1), (1, 1))[p], i.e. p = a + 2b. ReOrg
    then conv3x3/s1/pad1 equals conv6x6/s2/pad2 exactly."""
    c2, c4 = w3.shape[:2]
    c_in = c4 // 4
    # (c2, b, a, C, i, j) -> (c2, C, i, a, j, b) -> rows 2i + a, columns 2j + b
    return (w3.reshape(c2, 2, 2, c_in, 3, 3).permute(0, 3, 4, 2, 5, 1)
            .reshape(c2, c_in, 6, 6))


@dataclasses.dataclass(frozen=True)
class TrainReorgConv(Block):
    """[ReOrg, ConvBnAct(4c -> c2, k3, s1)] (the P6 stem) folded for
    training into one 6x6/s2 conv on the raw image. Param and state trees
    are the original ConvBnAct's ({w (c2, 4c, 3, 3), bn})."""

    c1: int     # raw input channels
    c2: int
    act: Any = True

    @property
    def cout(self):
        return self.c2

    stride_factor = 2.0

    def init(self, gen):
        return ConvBnAct(4 * self.c1, self.c2, 3, 1, None, 1, self.act).init(gen)

    def apply(self, params, state, x, ctx):
        y = conv2d(x, _reorg_w6(params["w"]), None, 2, 2, 1, ctx.dtype)
        y, new_bns = batch_norm(params["bn"], state["bn"], y, ctx)
        _, fn = get_activation(self.act)
        return fn(y), {"bn": new_bns}


def _train_pair_matches(layers, save, i):
    if i + 1 >= len(layers) or layers[i].is_head or layers[i + 1].is_head:
        return False
    l0, l1 = layers[i].block, layers[i + 1].block
    return (isinstance(l0, ConvBnAct) and isinstance(l1, ConvBnAct)
            and l0.k == 3 and l0.s == 1 and l1.k == 3 and l1.s == 2
            and l0.g == 1 and l1.g == 1 and l0.p is None and l1.p is None
            and layers[i].n_seq == 1 and layers[i + 1].n_seq == 1
            and layers[i].frm == -1 and layers[i + 1].frm == -1
            and i not in save)


def make_train_fast_stem(plan: GraphPlan, max_pairs: int = 2) -> GraphPlan:
    """Rewrite up to `max_pairs` (k3/s1, k3/s2) ConvBnAct pairs from layer 0
    into the phase-space training blocks, and a P6 stem's [ReOrg, k3/s1
    ConvBnAct] into `TrainReorgConv` (counting as one). Plan-only: the
    param and state trees are unchanged. Returns the plan unchanged when
    nothing matches."""
    new_layers = list(plan.layers)
    folded = 0
    i = 0
    l0 = new_layers[0].block
    if (len(new_layers) > 1 and isinstance(l0, ReOrg)
            and isinstance(new_layers[1].block, ConvBnAct)
            and new_layers[1].block.k == 3 and new_layers[1].block.s == 1
            and new_layers[1].block.g == 1 and new_layers[1].block.p is None
            and new_layers[0].frm == -1 and new_layers[1].frm == -1
            and 0 not in plan.save and new_layers[1].n_seq == 1):
        conv = new_layers[1].block
        new_layers[0] = dataclasses.replace(new_layers[0], block=_Passthrough(l0.c1),
                                            cout=l0.c1, stride=new_layers[0].stride / 2)
        new_layers[1] = dataclasses.replace(new_layers[1],
                                            block=TrainReorgConv(l0.c1, conv.c2, conv.act))
        folded += 1
        i = 2
    while i + 1 < len(new_layers) and folded < max_pairs:
        if not _train_pair_matches(new_layers, plan.save, i):
            i += 1
            continue
        l0, l1 = new_layers[i].block, new_layers[i + 1].block
        new_layers[i] = dataclasses.replace(
            new_layers[i], block=TrainPhasedConvA(l0.c1, l0.c2, l0.act),
            cout=4 * l0.c2, stride=new_layers[i].stride * 2)
        new_layers[i + 1] = dataclasses.replace(
            new_layers[i + 1], block=TrainPhasedConvB(4 * l0.c2, l1.c2, l1.act))
        folded += 1
        i += 2
    if folded == 0:
        return plan
    return dataclasses.replace(plan, layers=tuple(new_layers))
