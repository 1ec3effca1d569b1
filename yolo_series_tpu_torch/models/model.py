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
    """Every tensor leaf, dicts walked in sorted key order (as
    `jax.tree_util` walks them), so two trees with the same keys flatten
    leaf for leaf alike whatever order their dicts were built in."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def tree_rebuild(tree, new: List[Any]) -> Any:
    """`tree` with its tensor leaves replaced by `new`, in the order
    `tree_leaves` gives them."""
    it = iter(new)

    def build(t):
        if isinstance(t, dict):
            done = {k: build(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it) if isinstance(t, torch.Tensor) else t

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


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
    """One non-head layer -> (its output, its new state). With an observer,
    the blocks see the param path of layer `idx` ("l{idx}", or "l{idx}.{r}"
    for a repeat)."""
    def at(path):
        return dataclasses.replace(ctx, path=path) if ctx.observer is not None else ctx

    if spec.n_seq > 1:
        cur, states = inp, []
        for r in range(spec.n_seq):
            cur, s_r = spec.block.apply(p[r], s[r], cur, at(f"l{idx}.{r}"))
            states.append(s_r)
        return cur, states
    return spec.block.apply(p, s, inp, at(f"l{idx}"))


def apply_model(plan: GraphPlan, params, state, x, *, training: bool = False,
                dtype: torch.dtype = torch.float32, observer=None,
                return_head_inputs: bool = False, bn_shards: int = 1,
                remat_prefix: int = 0, group=None):
    """Run the graph. x: (B, H, W, C) NHWC in [0, 1].

    Returns (out, new_state): the head's {"pred": (B, A, no), "raw": [...]}
    in inference, {"raw": [per-level (B, na, ny, nx, no)]} in training, or
    with return_head_inputs=True the head's per-level NHWC inputs (the
    serving path fuses the head with NMS, ops/nms.fused_head_nms). In
    training, BN normalizes with the batch's moments and new_state holds
    every layer's updated running stats; in inference it is `state`.

    observer(path, x): fired at every conv input with the paths of
    `infer/quant.quantize_tree` ("l3", "l51/cv1", "l7.0"; the head's convs
    with path "", as in the JAX package), for int8 calibration.
    bn_shards > 1: per-replica BN in training (`layers.Ctx`). group: the
    process group over whose ranks the global batch is split (SyncBN in
    training, `layers.Ctx.group`).
    remat_prefix > 0 (recompute the first layers in the backward, a TPU
    memory-for-FLOPs lever) is ROADMAP queue 1 item 21 and raises.
    """
    if remat_prefix > 0:
        raise NotImplementedError(
            "remat_prefix is not ported yet: ROADMAP queue 1, item 21")
    ctx = Ctx(dtype=dtype, observer=observer, training=training, bn_shards=bn_shards,
              group=group)
    lp, ls = params["layers"], state["layers"]
    new_state = list(ls)
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
                return [t.permute(0, 2, 3, 1) for t in inp], {"layers": new_state}
            out, new_state[idx] = spec.block.apply(lp[idx], ls[idx], inp, ctx)
            return out, {"layers": new_state}
        y, new_state[idx] = _run_layer(ctx, spec, lp[idx], ls[idx], inp, idx)
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
