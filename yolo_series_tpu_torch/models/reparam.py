"""Train -> deploy re-parameterization as param-tree transforms
(counterpart of `yolo_series_tpu/models/reparam.py`).

Conv+BN fusion (reference torch_utils.py:181-201; Focus's conv, composite
blocks such as SPPCSPC and DownC child by child), the RepConv 3-branch
collapse (common.py:509-552), the OREPA family's `deploy` (weight_gen and
BN into one conv, common.py:1323-1345) and the folding of IDetect's,
IAuxDetect's, IBin's and IKeypoint's implicit layers into their lead 1x1
convs (yolo.py:178-190): (params, state) -> (params', state') with the
same inference output and the same GraphPlan. `prune_model` and
`sparsity` are the reference's L1 pruning and its zero count.

A composite block's own leaves beside its children (RobustConv's 1x1 conv
and layer scale, RobustConv2's transposed conv, TransformerBlock's
linears, Classify's conv) have no BN and pass through as they are. The
JAX package's `fuse_block` keeps a composite's children only, so its
fused tree of such a block lacks them and its forward raises KeyError
(ROADMAP queue 3); the port's fused forward equals the unfused one.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from yolo_series_tpu_torch.models import extra as X
from yolo_series_tpu_torch.models import layers as L
from yolo_series_tpu_torch.models.graph import GraphPlan
from yolo_series_tpu_torch.models.layers import BN_EPS


def fuse_conv_bn(w, bn_params, bn_state, eps=BN_EPS):
    """(OIHW weight, BN) -> (w', b') with identical inference output."""
    scale = bn_params["scale"] / torch.sqrt(bn_state["var"] + eps)   # (O,)
    return w * scale[:, None, None, None], \
        bn_params["bias"] - bn_state["mean"] * scale


def _bn_as_conv(c, g, bn_params, bn_state, eps=BN_EPS):
    """Identity 3x3 kernel through BN (RepConv identity branch,
    common.py:533-546)."""
    cin_per_group = c // g
    k = torch.zeros((c, cin_per_group, 3, 3), dtype=torch.float32,
                    device=bn_params["scale"].device)
    for o in range(c):
        k[o, o % cin_per_group, 1, 1] = 1.0
    return fuse_conv_bn(k, bn_params, bn_state, eps)


def fuse_repconv(block: L.RepConv, params, state):
    """RepConv train params -> single {w, b} 3x3 conv."""
    if "w" in params:  # already fused
        return params, {}
    w3, b3 = fuse_conv_bn(params["dense"]["w"], params["dense"]["bn"],
                          state["dense"]["bn"])
    w1, b1 = fuse_conv_bn(params["one"]["w"], params["one"]["bn"],
                          state["one"]["bn"])
    w, b = w3 + F.pad(w1, (1, 1, 1, 1)), b3 + b1
    if block.has_identity:
        wi, bi = _bn_as_conv(block.c1, block.g, params["idbn"], state["idbn"])
        w, b = w + wi, b + bi
    return {"w": w, "b": b}, {}


def fuse_head_implicit(head, params):
    """Fold the implicit layers ia / im into the 1x1 convs `m`
    (yolo.py:178-190): b += w @ ia, then w and b scale by im. IAuxDetect's
    aux convs `m2` and IKeypoint's keypoint convs `m_kpt` have none and
    stay as they are. A head without ia / im is returned as is."""
    if "ia" not in params:
        return params
    ms = []
    for mp, ia, im in zip(params["m"], params["ia"], params["im"]):
        w, b = mp["w"], mp["b"]                  # w: (O, C, 1, 1)
        b = b + torch.einsum("c,oc->o", ia["v"], w[:, :, 0, 0])
        ms.append({"w": w * im["v"][:, None, None, None], "b": b * im["v"]})
    return {k: v for k, v in params.items() if k not in ("ia", "im")} | {"m": ms}


def fuse_block(block, params, state) -> Tuple[Any, Any]:
    if isinstance(block, L.RepConv):
        return fuse_repconv(block, params, state)
    if isinstance(block, (X.OREPA3x3, X.RepConvOREPA)):
        return (params, state) if "w" in params else block.deploy(params, state)
    if isinstance(block, (L.ConvBnAct, L.Focus)):
        if "bn" in params:
            w, b = fuse_conv_bn(params["w"], params["bn"], state["bn"])
            return {"w": w, "b": b}, {}
        return params, state
    if isinstance(block, L.Composite):
        kids = block.children()
        new_p = {k: v for k, v in params.items() if k not in kids}
        new_s = {k: v for k, v in state.items() if k not in kids}
        for name, child in kids.items():
            new_p[name], new_s[name] = fuse_block(child, params[name], state[name])
        return new_p, new_s
    return params, state


def fuse_model(plan: GraphPlan, params, state) -> Tuple[Any, Any]:
    """Full train -> deploy fusion (the reference attempt_load always
    fuses, experimental.py:253)."""
    lp, ls = params["layers"], state["layers"]
    new_p, new_s = [], []
    for idx, spec in enumerate(plan.layers):
        if spec.is_head:
            new_p.append(fuse_head_implicit(spec.block, lp[idx]))
            new_s.append(ls[idx])
        elif spec.n_seq > 1:
            ps, ss = zip(*[fuse_block(spec.block, lp[idx][r], ls[idx][r])
                           for r in range(spec.n_seq)])
            new_p.append(list(ps))
            new_s.append(list(ss))
        else:
            p, s = fuse_block(spec.block, lp[idx], ls[idx])
            new_p.append(p)
            new_s.append(s)
    return {"layers": new_p}, {"layers": new_s}


def prune_model(params, amount: float = 0.3):
    """Per-leaf L1 unstructured pruning of conv kernels (reference
    torch_utils.prune, :228-236: l1_unstructured per Conv2d module): every
    4-d leaf named "w" loses its `amount` fraction of smallest |w|, every
    value at or below the k-th smallest |w| set to 0 (ties at the
    threshold included, as the JAX package's `prune_model`). The zeros
    persist through the deploy transforms and quantization."""
    def prune(tree, name=""):
        if isinstance(tree, dict):
            return {k: prune(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(prune(v, name) for v in tree)
        if name != "w" or not isinstance(tree, torch.Tensor) or tree.ndim != 4:
            return tree
        flat = tree.detach().abs().cpu().numpy().ravel()
        k = int(len(flat) * amount)
        if k == 0:
            return tree
        thr = float(np.partition(flat, k - 1)[k - 1])
        return torch.where(tree.abs() <= thr, torch.zeros_like(tree), tree)

    return prune(params)


def sparsity(params) -> float:
    """Global fraction of zero weights (reference torch_utils.sparsity)."""
    from yolo_series_tpu_torch.models.model import tree_leaves

    leaves = tree_leaves(params)
    zeros = sum(int((t == 0).sum()) for t in leaves)
    return zeros / max(sum(t.numel() for t in leaves), 1)
