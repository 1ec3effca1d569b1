"""Weight bridge between the JAX package's param trees and the port's.

JAX counterpart: the param/state trees of `yolo_series_tpu.models.model`
(`init_model`, `reparam.fuse_model`). `from_jax_params` takes those trees
with numpy leaves — unfused (BN) or fused ({w, b}) — and returns the
port's trees: the same nesting and keys, torch tensors on the CPU, conv
weights (`w`, and `wq` of the int8 trees of `infer/quant.py`) turned
from HWIO into OIHW; the int8 leaves' `sw`, `sx` and `b` stay fp32. Both
packages then compute the same function of the same weights.
`to_jax_params` is its inverse: the port's trees, on any device, back to
numpy leaves in the JAX layout (OIHW -> HWIO). `from_jax_tree` and
`to_jax_tree` convert any tree shaped like the params (grads, the
optimizer's slots, the EMA) the same way, leaf by leaf.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from yolo_series_tpu_torch.models.graph import GraphPlan


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16 leaf: exact via fp32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def from_jax_tree(tree, key=None):
    """A JAX-layout tree with numpy leaves -> torch tensors on the CPU,
    HWIO -> OIHW for `w` and `wq`; lists and tuples become lists."""
    if isinstance(tree, dict):
        return {k: from_jax_tree(v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_jax_tree(v, key) for v in tree]
    t = _tensor(tree)
    if key in ("w", "wq") and t.ndim == 4:  # HWIO -> OIHW (fp32 or int8)
        t = t.permute(3, 2, 0, 1).contiguous()
    return t


def to_jax_tree(tree, key=None):
    """The inverse of `from_jax_tree`: tensor leaves (any device) -> numpy,
    OIHW -> HWIO for `w` and `wq`; a leaf that is not a tensor passes as it
    is."""
    if isinstance(tree, dict):
        return {k: to_jax_tree(v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_jax_tree(v, key) for v in tree]
    if not isinstance(tree, torch.Tensor):
        return tree
    t = tree.detach()
    if key in ("w", "wq") and t.ndim == 4:  # OIHW -> HWIO
        t = t.permute(2, 3, 1, 0)
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().contiguous().numpy()


def _check_layers(plan: GraphPlan, lp, ls):
    if len(lp) != len(plan.layers) or len(ls) != len(plan.layers):
        raise ValueError(f"param trees have {len(lp)}/{len(ls)} layers, "
                         f"the plan {len(plan.layers)}")


def from_jax_params(plan: GraphPlan, params_np, state_np) -> Tuple[Any, Any]:
    """JAX (params, state) with numpy leaves -> the port's (params, state)."""
    lp, ls = params_np["layers"], state_np["layers"]
    _check_layers(plan, lp, ls)
    return {"layers": from_jax_tree(list(lp))}, {"layers": from_jax_tree(list(ls))}


def to_jax_params(plan: GraphPlan, params, state) -> Tuple[Any, Any]:
    """The port's (params, state) -> the JAX package's, numpy leaves."""
    _check_layers(plan, params["layers"], state["layers"])
    return to_jax_tree(params), to_jax_tree(state)
