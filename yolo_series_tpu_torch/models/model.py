"""Model: init and inference forward over a compiled GraphPlan
(counterpart of `yolo_series_tpu/models/model.py`).

`apply_model` runs the reference `Model.forward_once` routing
(models/yolo.py:601-631) eagerly: a loop over the plan's layers with the
save-list outputs kept by index. Inputs and head inputs are NHWC at this
boundary, as in the JAX package; inside, activations are NCHW tensors in
`channels_last` memory, so the NHWC views are permutes, not copies.
`profile_layers` (and `Model.profile`) times and sizes it layer by layer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

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


def _layer_input(spec, y, saved):
    """A layer's input: the last output (-1) or saved outputs, by `frm`."""
    if isinstance(spec.frm, tuple):
        return [y if j == -1 else saved[j] for j in spec.frm]
    return y if spec.frm == -1 else saved[spec.frm]


def _run_layers(ctx, plan, lp, ls, lo, hi, y, saved, new_state):
    """Layers lo..hi-1 (no head) from the last output y and the saved
    outputs: their last output; `saved` and `new_state` are updated in
    place."""
    for idx in range(lo, hi):
        spec = plan.layers[idx]
        y, new_state[idx] = _run_layer(ctx, spec, lp[idx], ls[idx],
                                       _layer_input(spec, y, saved), idx)
        if idx in plan.save:
            saved[idx] = y
    return y


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
    remat_prefix = k > 0: the first k layers run under
    `torch.utils.checkpoint` (non-reentrant), so the backward recomputes
    their activations from the input instead of keeping them: memory for
    operations. Saved entries of the prefix that later layers read are
    outputs of the checkpoint, kept, not recomputed; the recompute's BN
    state is discarded, and under a group it repeats the prefix's
    collectives in the backward, in the same order on every rank. It
    takes no observer, as in the JAX package.
    """
    ctx = Ctx(dtype=dtype, observer=observer, training=training, bn_shards=bn_shards,
              group=group)
    lp, ls = params["layers"], state["layers"]
    new_state = list(ls)
    saved: Dict[int, torch.Tensor] = {}
    y = x.to(dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    k = 0
    if remat_prefix > 0:
        if observer is not None:
            raise ValueError("remat_prefix recomputes layers in the backward and takes "
                             "no observer")
        k = min(remat_prefix, len(plan.layers) - 1)
        save_out = sorted(i for i in plan.save if i < k)

        def prefix(yv):
            sv, ns = {}, list(ls)
            yv = _run_layers(ctx, plan, lp, ls, 0, k, yv, sv, ns)
            return yv, [sv[i] for i in save_out], ns[:k]

        if torch.is_grad_enabled():
            y, saved_list, ns = torch.utils.checkpoint.checkpoint(prefix, y,
                                                                  use_reentrant=False)
        else:
            y, saved_list, ns = prefix(y)
        saved.update(zip(save_out, saved_list))
        new_state[:k] = ns
    head = len(plan.layers) - 1
    y = _run_layers(ctx, plan, lp, ls, k, head, y, saved, new_state)
    spec = plan.layers[head]
    if not spec.is_head:
        raise ValueError("graph plan ended without a head layer")
    inp = _layer_input(spec, y, saved)
    if return_head_inputs:
        return [t.permute(0, 2, 3, 1) for t in inp], {"layers": new_state}
    out, new_state[head] = spec.block.apply(lp[head], ls[head], inp, ctx)
    return out, {"layers": new_state}


def profile_layers(plan: GraphPlan, params, state, x, *, iters: int = 10,
                   dtype: torch.dtype = torch.float32, printout: bool = True):
    """Per-layer forward profile, the reference
    `Model.forward_once(profile=True)` (yolo.py:614-623: each module timed
    over `iters` calls, with its GFLOPs and parameter count, printed as a
    table). x: (B, H, W, 3) NHWC in [0, 1].

    Each layer, the head included, runs alone on the output of the layer
    before, after one call under `utils/general.FlopCounter` that counts
    its operations. On the card its time is the steady-state device time
    a call (`utils/chiprate.chip_rate`: the slope between `iters` and
    2 * `iters` calls in a CUDA graph, each run between two CUDA events),
    so the host's launch gaps, which a whole forward hides behind the
    card's work, are not counted and the rows sum to about the forward's
    device time. On the CPU it is the mean of `iters` calls on the host
    clock (`utils/general.profile_fn`).

    Returns a list of {idx, module, ms, gflops, params, shape} dicts."""
    from yolo_series_tpu_torch.utils.chiprate import chip_rate
    from yolo_series_tpu_torch.utils.general import FlopCounter, profile_fn

    ctx = Ctx(dtype=dtype)
    lp, ls = params["layers"], state["layers"]
    saved: Dict[int, torch.Tensor] = {}
    y = x.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    rows = []
    for idx, spec in enumerate(plan.layers):
        inp = _layer_input(spec, y, saved)
        if spec.is_head:
            def layer(inp=inp, spec=spec, p=lp[idx], s=ls[idx]):
                return spec.block.apply(p, s, inp, ctx)[0]
        else:
            def layer(inp=inp, spec=spec, p=lp[idx], s=ls[idx], idx=idx):
                return _run_layer(ctx, spec, p, s, inp, idx)[0]
        with torch.inference_mode():
            with FlopCounter() as c:
                out = layer()
            ms = 1e3 * (chip_rate(lambda _: layer(), x, iters=iters) if x.is_cuda
                        else profile_fn(layer, n=iters))
        probe = out["pred"] if isinstance(out, dict) else out
        n_par = sum(t.numel() for t in tree_leaves(lp[idx]))
        rows.append({"idx": idx, "module": type(spec.block).__name__, "ms": ms,
                     "gflops": c.flops / 1e9, "params": n_par, "shape": tuple(probe.shape)})
        if printout:
            print(f"{ms:8.2f}ms {rows[-1]['gflops']:8.2f} GFLOPs {n_par:10d} params  "
                  f"l{idx:<3d} {rows[-1]['module']}")
        if spec.is_head:
            break
        y = out
        if idx in plan.save:
            saved[idx] = y
    if printout:
        print(f"{sum(r['ms'] for r in rows):8.2f}ms total "
              f"({sum(r['params'] for r in rows):,d} params)")
    return rows


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

    def profile(self, x, iters: int = 10, dtype: torch.dtype = torch.float32):
        """Per-layer timing and GFLOPs table (reference
        forward_once(profile=True), yolo.py:614-623)."""
        return profile_layers(self.plan, self.params, self.state, x, iters=iters, dtype=dtype)
