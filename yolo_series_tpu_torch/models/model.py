"""Model: init and inference forward over a compiled GraphPlan
(counterpart of `yolo_series_tpu/models/model.py`).

`apply_model` runs the reference `Model.forward_once` routing
(models/yolo.py:601-631) eagerly: a loop over the plan's layers with the
save-list outputs kept by index. Inputs and head inputs are NHWC at this
boundary, as in the JAX package; inside, activations are NCHW tensors in
`channels_last` memory, so the NHWC views are permutes, not copies.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from yolo_series_tpu_torch.device import device as _device
from yolo_series_tpu_torch.models.graph import GraphPlan, compile_graph
from yolo_series_tpu_torch.models.layers import Ctx


def tree_map(fn, tree):
    """Apply fn to every tensor leaf of a dict/list param tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def init_model(plan: GraphPlan, generator: torch.Generator) -> Tuple[Any, Any]:
    """(params, state) trees on the CPU from a seeded generator, with the
    detect-head bias priors applied (reference yolo.py:540)."""
    params: List[Any] = []
    state: List[Any] = []
    for spec in plan.layers:
        if spec.n_seq > 1:
            ps, ss = zip(*[spec.block.init(generator) for _ in range(spec.n_seq)])
            params.append(list(ps))
            state.append(list(ss))
        else:
            p, s = spec.block.init(generator)
            params.append(p)
            state.append(s)
    params[-1] = plan.layers[-1].block.init_biases(params[-1])
    return {"layers": params}, {"layers": state}


def _run_layer(ctx, spec, p, s, inp, idx=0):
    """One non-head layer. With an observer, the blocks see the param path
    of layer `idx` ("l{idx}", or "l{idx}.{r}" for a repeat)."""
    def at(path):
        return dataclasses.replace(ctx, path=path) if ctx.observer is not None else ctx

    if spec.n_seq > 1:
        cur = inp
        for r in range(spec.n_seq):
            cur, _ = spec.block.apply(p[r], s[r], cur, at(f"l{idx}.{r}"))
        return cur
    return spec.block.apply(p, s, inp, at(f"l{idx}"))[0]


def apply_model(plan: GraphPlan, params, state, x, *, training: bool = False,
                dtype: torch.dtype = torch.float32, observer=None,
                return_head_inputs: bool = False):
    """Run the graph. x: (B, H, W, C) NHWC in [0, 1].

    Returns (out, state): the head's {"pred": (B, A, no), "raw": [...]}, or
    with return_head_inputs=True the head's per-level NHWC inputs (the
    serving path fuses the head with NMS, ops/nms.fused_head_nms).

    observer(path, x): fired at every conv input with the paths of
    `infer/quant.quantize_tree` ("l3", "l51/cv1", "l7.0"; the head's convs
    with path "", as in the JAX package), for int8 calibration.
    """
    if training:
        raise NotImplementedError(
            "the training-mode forward is ROADMAP queue 1, slice 2 (item 8)")
    ctx = Ctx(dtype=dtype, observer=observer)
    lp, ls = params["layers"], state["layers"]
    saved: Dict[int, torch.Tensor] = {}
    y = x.to(dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    for idx, spec in enumerate(plan.layers):
        if isinstance(spec.frm, tuple):
            inp = [y if j == -1 else saved[j] for j in spec.frm]
        else:
            inp = y if spec.frm == -1 else saved[spec.frm]
        if spec.is_head:
            if return_head_inputs:
                return [t.permute(0, 2, 3, 1) for t in inp], state
            out, _ = spec.block.apply(lp[idx], ls[idx], inp, ctx)
            return out, state
        y = _run_layer(ctx, spec, lp[idx], ls[idx], inp, idx)
        if idx in plan.save:
            saved[idx] = y
    raise ValueError("graph plan ended without a head layer")


class Model(torch.nn.Module):
    """Owner of (plan, params, state), mirroring the reference
    `Model(cfg, ch, nc, anchors)` constructor surface (yolo.py:508). All
    compute goes through `apply_model`."""

    def __init__(self, plan: GraphPlan, params, state):
        super().__init__()
        self.plan = plan
        self.params = params
        self.state = state

    @classmethod
    def from_yaml(cls, cfg, ch: int = 3, nc: Optional[int] = None,
                  anchors: Optional[list] = None, seed: int = 0,
                  device=None) -> "Model":
        """Compile `cfg` and draw its weights from a torch.Generator seeded
        with `seed`, on `device` (the card unless "cpu" is asked for)."""
        dev = _device(device)
        plan = compile_graph(cfg, ch=ch, nc=nc, anchors=anchors)
        gen = torch.Generator().manual_seed(seed)
        params, state = init_model(plan, gen)
        move = lambda t: t.to(dev)  # noqa: E731
        return cls(plan, tree_map(move, params), tree_map(move, state))

    @property
    def strides(self):
        return self.plan.strides

    def forward(self, x, dtype: torch.dtype = torch.float32):
        return apply_model(self.plan, self.params, self.state, x, dtype=dtype)[0]

    def num_params(self) -> int:
        return sum(t.numel() for t in tree_leaves(self.params))
