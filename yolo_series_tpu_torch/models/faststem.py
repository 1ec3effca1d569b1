"""Fast-stem deploy transform: fold the first conv pairs into phase space
(counterpart of the deploy side of `yolo_series_tpu/models/faststem.py`).

Layer 0 (k3/s1, C -> c0) becomes a k4/s2 conv that emits the 4 output
phases stacked in channels (C -> 4*c0), and layer 1 (k3/s2, c0 -> c1) a
k2 conv over that phase layout with asymmetric (1, 0) padding. The fold
is an exact reshuffle of the weights; downstream layers are untouched.
`PhasedConv` applies the folded convs' own activation (SiLU, LeakyReLU or
any other of `layers.get_activation`). Apply after `reparam.fuse_model`
(it needs {w, b} conv forms). The training-side blocks of the JAX module
(`make_train_fast_stem`) are ROADMAP queue 1, item 20.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from yolo_series_tpu_torch.models.graph import GraphPlan
from yolo_series_tpu_torch.models.layers import (Block, ConvBnAct, conv2d,
                                                 get_activation)

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
