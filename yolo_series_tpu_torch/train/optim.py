"""3-group SGD (nesterov) / Adam with YOLO warmup semantics (counterpart
of `yolo_series_tpu/train/optim.py`; reference train.py:115-187).

  group 0: BN scales, implicit knowledge and other 1-D params, no decay
  group 1: conv weights, weight decay
  group 2: biases (BN's too), no decay, their own warmup ramp from
           warmup_bias_lr (train.py:349-357)

The update is the JAX package's formula in its order of operations
(torch-SGD: d = g + wd p; v = mu v + d; step = d + mu v with nesterov),
with the per-group learning rates and the momentum as arguments of every
update, as warmup changes them each step. It runs as `torch._foreach_*`
ops over each group's leaves: yolov7 has several hundred.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from yolo_series_tpu_torch.models.model import tree_leaves as leaves
from yolo_series_tpu_torch.models.model import tree_rebuild as rebuild


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    kind: str = "sgd"        # 'sgd' | 'adam'
    lr0: float = 0.01
    momentum: float = 0.937
    weight_decay: float = 0.0005
    nesterov: bool = True
    adam_b2: float = 0.999


GROUP_DECAY = 1    # conv weights
GROUP_NODECAY = 0  # bn / implicit / 1-D params
GROUP_BIAS = 2     # biases


def _named_leaves(tree, name: str = ""):
    """[(name of the nearest dict key, tensor)], in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named_leaves(tree[k], k)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _named_leaves(v, name)]
    return [(name, tree)] if isinstance(tree, torch.Tensor) else []


def _group(name: str, leaf: torch.Tensor) -> int:
    if name in ("b", "bias"):
        return GROUP_BIAS
    if name == "w" and leaf.ndim >= 2:
        return GROUP_DECAY
    return GROUP_NODECAY


def param_groups(params: Any) -> Any:
    """The group id of every leaf, as a tree shaped like `params`: a leaf
    named 'b' or 'bias' goes to group 2, a 'w' with ndim >= 2 to group 1,
    everything else to group 0 (the reference's module walk)."""
    return rebuild(params, [_group(n, t) for n, t in _named_leaves(params)])


def _f32(x) -> float:
    """x rounded to fp32, as a Python number (a fp32 tensor times it
    computes in fp32 with this value, as the JAX package's fp32 scalars)."""
    return float(np.float32(x))


def make_optimizer(cfg: OptimConfig, params: Any):
    """(init_fn, update_fn).

    update_fn(opt_state, params, grads, lr_groups, momentum) -> (new_params,
    new_opt_state): lr_groups, the 3 per-group learning rates, and momentum
    are host numbers (fp32 values; warmup changes them every step). The
    trees come back new: the inputs are not modified. It is
    `make_update`'s two parts in turn.
    """
    scalars, apply = make_update(cfg, params)

    def init(params):
        zeros = lambda t: torch.zeros_like(t)  # noqa: E731
        mom = rebuild(params, [zeros(t) for t in leaves(params)])
        if cfg.kind == "adam":
            return {"m": mom, "v": rebuild(params, [zeros(t) for t in leaves(params)]),
                    "t": 0}
        return {"v": mom}

    def update(opt_state, params, grads, lr_groups, momentum):
        s, host = scalars(opt_state, lr_groups, momentum)
        new_params, slots = apply(opt_state, params, grads, s)
        return new_params, {**slots, **host}

    return init, update


def make_update(cfg: OptimConfig, params: Any):
    """(scalars_fn, apply_fn): the update in two parts, the host arithmetic
    of a step's numbers and the device work that uses them, so that a CUDA
    graph of the device work takes new numbers every step.

    scalars_fn(opt_state, lr_groups, momentum) -> (s, host): s the step's
    numbers as fp32 values in Python floats, "lr0".."lr2" and "mu", and for
    Adam "one_b1", "bc1" and "bc2" (its bias corrections, which change with
    the step count) and "inv_bc1", "inv_bc2" (their fp32 reciprocals, for
    `_div`); host the new state's entries that are no tensors (Adam's count
    "t").
    apply_fn(opt_state, params, grads, s) -> (new_params, the new state's
    tensor slots): the numbers of s as scalars_fn gives them, or, on the
    card, as 0-d fp32 tensors there that hold the same values (a captured
    graph's inputs), with the same result bit for bit.
    """
    gids = [_group(n, t) for n, t in _named_leaves(params)]
    index = {g: [i for i, x in enumerate(gids) if x == g] for g in (0, 1, 2)}

    def take(xs, g):
        return [xs[i] for i in index[g]]

    def scalars(opt_state, lr_groups, momentum):
        lr_groups = [_f32(x) for x in np.asarray(lr_groups, np.float64).reshape(-1)]
        mu = _f32(momentum)
        s = {"lr0": lr_groups[0], "lr1": lr_groups[1], "lr2": lr_groups[2], "mu": mu}
        if cfg.kind != "adam":
            return s, {}
        t = opt_state["t"] + 1
        b1 = torch.tensor(mu, dtype=torch.float32)
        b2 = torch.tensor(cfg.adam_b2, dtype=torch.float32)
        tf = torch.tensor(float(t), dtype=torch.float32)
        s["one_b1"] = float(1 - b1)                      # fp32 arithmetic
        s["bc1"] = float(1 - torch.pow(b1, tf))
        s["bc2"] = float(1 - torch.pow(b2, tf))
        s["inv_bc1"] = _f32(np.float32(1) / np.float32(s["bc1"]))
        s["inv_bc2"] = _f32(np.float32(1) / np.float32(s["bc2"]))
        return s, {"t": t}

    def apply(opt_state, params, grads, s):
        mu = s["mu"]
        ps, gs = leaves(params), leaves(grads)
        new_p = [None] * len(ps)
        if cfg.kind == "adam":
            ms, vs = leaves(opt_state["m"]), leaves(opt_state["v"])
            new_m, new_v = [None] * len(ps), [None] * len(ps)
            for gid in (0, 1, 2):
                if not index[gid]:
                    continue
                p, g, m, v = take(ps, gid), take(gs, gid), take(ms, gid), take(vs, gid)
                if gid == GROUP_DECAY and cfg.weight_decay:
                    g = torch._foreach_add(g, torch._foreach_mul(p, cfg.weight_decay))
                m2 = torch._foreach_add(torch._foreach_mul(m, mu),
                                        torch._foreach_mul(g, s["one_b1"]))
                v2 = torch._foreach_add(torch._foreach_mul(v, cfg.adam_b2),
                                        torch._foreach_mul(torch._foreach_mul(g, g),
                                                           1 - cfg.adam_b2))
                mhat = _div(m2, s["bc1"], s["inv_bc1"])
                vhat = _div(v2, s["bc2"], s["inv_bc2"])
                den = torch._foreach_add(torch._foreach_sqrt(vhat), 1e-8)
                step = torch._foreach_div(torch._foreach_mul(mhat, s[f"lr{gid}"]), den)
                for j, i in enumerate(index[gid]):
                    new_m[i], new_v[i] = m2[j], v2[j]
                _scatter(new_p, index[gid], torch._foreach_sub(p, step))
            return rebuild(params, new_p), {"m": rebuild(params, new_m),
                                            "v": rebuild(params, new_v)}

        vs = leaves(opt_state["v"])
        new_v = [None] * len(ps)
        for gid in (0, 1, 2):
            if not index[gid]:
                continue
            p, g, v = take(ps, gid), take(gs, gid), take(vs, gid)
            d = g
            if gid == GROUP_DECAY and cfg.weight_decay:
                d = torch._foreach_add(g, torch._foreach_mul(p, cfg.weight_decay))
            v2 = torch._foreach_add(torch._foreach_mul(v, mu), d)
            step = (torch._foreach_add(d, torch._foreach_mul(v2, mu)) if cfg.nesterov
                    else v2)
            _scatter(new_v, index[gid], v2)
            _scatter(new_p, index[gid],
                     torch._foreach_sub(p, torch._foreach_mul(step, s[f"lr{gid}"])))
        return rebuild(params, new_p), {"v": rebuild(params, new_v)}

    return scalars, apply


def _div(xs, d, inv):
    """xs / d. A host number d divides (`_foreach_div`), as the update
    always has; CUDA computes that as the product with d's fp32 reciprocal.
    Given as 0-d tensors (a captured graph's inputs, on the card), the
    product with inv, that reciprocal, so that the graph's update is the
    eager one bit for bit (a tensor divisor would divide exactly)."""
    return torch._foreach_mul(xs, inv) if torch.is_tensor(d) else torch._foreach_div(xs, d)


def _scatter(out, idx, vals):
    for i, v in zip(idx, vals):
        out[i] = v
