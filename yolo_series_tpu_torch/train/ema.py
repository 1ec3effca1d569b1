"""Model EMA over param and BN-state trees (counterpart of
`yolo_series_tpu/train/ema.py`; reference torch_utils.py:269-303
ModelEMA): decay(t) = base (1 - exp(-t / tau)), the reference's warm ramp,
applied to the params and the BN running stats."""

from __future__ import annotations

import torch

from yolo_series_tpu_torch.models.model import tree_leaves as leaves
from yolo_series_tpu_torch.models.model import tree_rebuild as rebuild


def ema_decay(updates, base=0.9999, tau=2000.0):
    """fp32 0-d CPU tensor."""
    u = torch.as_tensor(updates, dtype=torch.float32)
    return base * (1.0 - torch.exp(-u / tau))


def ema_scalars(updates, base=0.9999, tau=2000.0):
    """(d, 1 - d) with d = ema_decay(updates): fp32 values as Python floats."""
    d = ema_decay(updates, base, tau)
    return float(d), float(1.0 - d)


def ema_mix(ema_tree, new_tree, d, one_d):
    """A new tree e * d + one_d * p, in that order, for every float leaf;
    non-float leaves take p's. d and one_d: `ema_scalars`' numbers, or 0-d
    fp32 tensors on the trees' device that hold them (a captured graph's
    inputs), with the same result bit for bit."""
    es, ps = leaves(ema_tree), leaves(new_tree)
    idx = [i for i, e in enumerate(es) if e.is_floating_point()]
    out = list(ps)
    if idx:
        mixed = torch._foreach_add(torch._foreach_mul([es[i] for i in idx], d),
                                   torch._foreach_mul([ps[i] for i in idx], one_d))
        for i, t in zip(idx, mixed):
            out[i] = t.to(es[i].dtype)
    return rebuild(ema_tree, out)


def ema_update(ema_tree, new_tree, updates, base=0.9999, tau=2000.0):
    """A new tree e * d + (1 - d) * p, in that order, for every float leaf
    (in fp32 with d = ema_decay(updates)); non-float leaves take p's."""
    return ema_mix(ema_tree, new_tree, *ema_scalars(updates, base, tau))
