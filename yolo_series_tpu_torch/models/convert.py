"""Weight bridge from the JAX package's param trees to the port's.

JAX counterpart: the param/state trees of `yolo_series_tpu.models.model`
(`init_model`, `reparam.fuse_model`). `from_jax_params` takes those trees
with numpy leaves — unfused (BN) or fused ({w, b}) — and returns the
port's trees: the same nesting and keys, torch tensors on the CPU, conv
weights (`w`, and `wq` of the int8 trees of `infer/quant.py`) turned
from HWIO into OIHW; the int8 leaves' `sw`, `sx` and `b` stay fp32. Both
packages then compute the same function of the same weights.
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


def _convert(tree, key=None):
    if isinstance(tree, dict):
        return {k: _convert(v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, key) for v in tree]
    t = _tensor(tree)
    if key in ("w", "wq") and t.ndim == 4:  # HWIO -> OIHW (fp32 or int8)
        t = t.permute(3, 2, 0, 1).contiguous()
    return t


def from_jax_params(plan: GraphPlan, params_np, state_np) -> Tuple[Any, Any]:
    """JAX (params, state) with numpy leaves -> the port's (params, state)."""
    lp, ls = params_np["layers"], state_np["layers"]
    if len(lp) != len(plan.layers) or len(ls) != len(plan.layers):
        raise ValueError(f"param trees have {len(lp)}/{len(ls)} layers, "
                         f"the plan {len(plan.layers)}")
    return {"layers": _convert(list(lp))}, {"layers": _convert(list(ls))}
