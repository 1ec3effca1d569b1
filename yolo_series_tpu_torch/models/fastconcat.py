"""Concat elimination for the ELAN routing pattern (counterpart of
`yolo_series_tpu/models/fastconcat.py`).

Every wide concat of the v7 family (the ELAN taps, the ELAN-W heads of
P6, the FPN merges) is read only by 1x1 Conv+BN+act layers, and

    conv1x1(concat(x_1..x_n), W) == sum_i conv1x1(x_i, W[:, off_i:off_i+c_i])

so each consumer can take the concat's inputs directly, one partial
product a tap, and the concatenated tensor is never read. The rewrite is
plan-only: the consumer keeps its full (c2, sum(c_i), 1, 1) kernel and its
BN, sliced per tap inside `apply`, so params, state, gradients, the EMA
and checkpoints see the same trees. The Concat layer stays in the plan
(its output is computed and unused). Only the 1x1's K-reduction order
changes: fp32-level differences.

Reference behaviour re-expressed: models/common.py:56 (Concat) followed by
common.py:99 (Conv), routed by cfg/training/*.yaml.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from yolo_series_tpu_torch.models import layers as L
from yolo_series_tpu_torch.models.graph import GraphPlan
from yolo_series_tpu_torch.models.layers import (Block, ConvBnAct, _int8_conv, batch_norm,
                                                 conv2d, get_activation)


@dataclasses.dataclass(frozen=True)
class SplitConcatConv(Block):
    """A 1x1 ConvBnAct applied to the un-concatenated route inputs: `apply`
    takes the concat's input list and slices the original kernel's input
    channels per tap. init() and the param / state trees are those of the
    ConvBnAct it replaces."""

    cins: Tuple[int, ...]
    c2: int
    act: Any = True

    @property
    def cout(self):
        return self.c2

    stride_factor = 1.0

    def init(self, gen):
        return ConvBnAct(sum(self.cins), self.c2, 1, 1, None, 1, self.act).init(gen)

    def apply(self, params, state, xs, ctx):
        _, fn = get_activation(self.act)
        if ctx.observer is not None or "wq" in params:
            # int8 calibration and the int8 form see the conv's own input
            # layout (the observer's scales must be what int8_conv sees)
            x = torch.cat([x.to(ctx.dtype) for x in xs], dim=1)
            if ctx.observer is not None:
                ctx.observer(ctx.path, x)
            if "wq" in params:
                return fn(_int8_conv(params, x, 1, 0, 1)).to(x.dtype), state
            xs, cins = [x], (sum(self.cins),)
        else:
            cins = self.cins
        w = params["w"]
        y, off = None, 0
        for x_i, ci in zip(xs, cins):
            yi = conv2d(x_i, w[:, off:off + ci], None, 1, 0, 1, ctx.dtype)
            y = yi if y is None else y + yi
            off += ci
        if "bn" in params:
            y, bns = batch_norm(params["bn"], state["bn"], y, ctx)
            return fn(y), {"bn": bns}
        return fn(y + params["b"].to(y.dtype)[:, None, None]), state


def _refs(spec, j):
    """The absolute input indices of layer j."""
    frm = spec.frm
    if isinstance(frm, tuple):
        return [j - 1 if r == -1 else r for r in frm]
    return [j - 1 if frm == -1 else frm]


def _one_by_one(spec) -> bool:
    b = spec.block
    return (not spec.is_head and isinstance(b, ConvBnAct) and b.k == 1 and b.s == 1
            and b.g == 1 and b.p in (None, 0) and spec.n_seq == 1)


def make_split_concat(plan: GraphPlan) -> GraphPlan:
    """Rewrite every Concat whose consumers are all 1x1 ConvBnActs: each
    consumer becomes a SplitConcatConv routed to the concat's inputs.
    Plan-only; composes with the fast stems and `reparam.fuse_model` in any
    order, and after the serving transforms (a conv a fused ELAN span
    absorbed is no ConvBnAct any more and is left alone). Returns the plan
    unchanged when nothing matches."""
    layers = list(plan.layers)
    n = len(layers)
    consumers = {i: [] for i in range(n)}
    for j, spec in enumerate(layers):
        for r in _refs(spec, j):
            if 0 <= r < n:
                consumers[r].append(j)

    new_layers = list(layers)
    extra_save = set()
    for i, spec in enumerate(layers):
        blk = spec.block
        if (not isinstance(blk, L.Concat) or spec.is_head or spec.n_seq != 1
                or not isinstance(spec.frm, tuple)):
            continue
        cons = consumers[i]
        if not cons or not all(_one_by_one(layers[j]) for j in cons):
            continue
        srcs = tuple(i - 1 if r == -1 else r for r in spec.frm)
        if any(s < 0 for s in srcs):
            continue
        for j in cons:
            conv = new_layers[j].block
            new_layers[j] = dataclasses.replace(
                new_layers[j], block=SplitConcatConv(tuple(blk.cins), conv.c2, conv.act),
                frm=srcs)
        extra_save.update(srcs)

    if not extra_save:
        return plan
    return dataclasses.replace(plan, layers=tuple(new_layers),
                               save=tuple(sorted(set(plan.save) | extra_save)))
