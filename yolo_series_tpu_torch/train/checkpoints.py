"""Checkpoint reading (counterpart of the read side of
`yolo_series_tpu/train/checkpoints.py`: `load_checkpoint`,
`load_checkpoint_any`).

The native format is one pickle of numpy trees plus the model cfg dict
(`format: yolo-series-tpu-ckpt-v1`), as the JAX trainer's
`save_checkpoint` writes it: fp16 weights by default, EMA weights beside
the raw ones. Loading compiles the embedded cfg with the port's
`compile_graph`, takes the EMA trees when present (`prefer_ema`), casts
every float leaf to fp32 as the JAX loader does, and converts the trees
with `models/convert.from_jax_params`. Saving, resume and strip come with
the training slice (ROADMAP queue 1, item 11); a reference `.pt` needs the
torch importer, which is not ported (item 11).
"""

from __future__ import annotations

import pickle
from typing import Optional

import numpy as np

from yolo_series_tpu_torch.models.convert import from_jax_params
from yolo_series_tpu_torch.models.graph import compile_graph


def load_checkpoint(path):
    """The checkpoint's dict, as the JAX trainer pickled it."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    if not str(blob.get("format", "")).startswith("yolo-series-tpu-ckpt"):
        raise ValueError(f"not a yolo-series-tpu checkpoint: {path}")
    return blob


def _fp32(tree):
    """Every floating numpy leaf as fp32 (the checkpoint stores fp16)."""
    if isinstance(tree, dict):
        return {k: _fp32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_fp32(v) for v in tree]
    a = np.asarray(tree)
    return a.astype(np.float32) if np.issubdtype(a.dtype, np.floating) else a


def load_checkpoint_any(weights: str, cfg: Optional[str] = None,
                        prefer_ema: bool = True):
    """Weights -> (plan, params, state): the port's trees on the CPU, fp32.

    .ckpt    native checkpoint (cfg embedded; `cfg` overrides it)
    .pt      reference/upstream torch checkpoint: not ported yet
    """
    w = str(weights)
    if w.endswith(".pt"):
        raise NotImplementedError(
            "reference .pt checkpoints need the torch importer, which the port "
            "does not have yet (ROADMAP queue 1, item 11); convert with the JAX "
            "package and load the .ckpt it writes")
    blob = load_checkpoint(w)
    plan = compile_graph(blob["cfg"] if cfg is None else cfg)
    params_np = (blob["ema_params"] if prefer_ema and blob.get("ema_params")
                 else blob["params"])
    state_np = (blob["ema_state"] if prefer_ema and blob.get("ema_state")
                else blob["state"])
    params, state = from_jax_params(plan, _fp32(params_np), _fp32(state_np))
    return plan, params, state
