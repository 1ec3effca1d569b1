"""Checkpoints: save, load, resume, strip (counterpart of
`yolo_series_tpu/train/checkpoints.py`; reference train.py:465-489,
general.py:820 strip_optimizer, experimental.py:247 attempt_load).

The format is the JAX package's (`format: yolo-series-tpu-ckpt-v1`), so
each package reads what the other writes: one pickle of numpy trees in the
JAX layout (conv weights HWIO, `models/convert.to_jax_tree`) plus the
model cfg dict, with {epoch, best_fitness, results, hyp, step, params,
state, ema_params, ema_state, opt_state}. The params and EMA params are
stored fp16 (the reference saves fp16 copies), the BN state and the
optimizer state as they are: SGD's {"v"}, Adam's {"m", "v", "t"} with `t`
an int32 scalar, as the JAX optimizer holds them. Loading compiles the
embedded cfg with the port's `compile_graph`, casts every float leaf of
the weights to fp32, as the JAX loader does, and converts the trees with
`models/convert.from_jax_tree`. `load_checkpoint_any` also reads a
reference `.pt` through `models/torch_import.load_torch_checkpoint`.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Optional

import numpy as np

from yolo_series_tpu_torch.device import device as _device
from yolo_series_tpu_torch.models.convert import (from_jax_params, from_jax_tree,
                                                  to_jax_tree)
from yolo_series_tpu_torch.models.graph import compile_graph
from yolo_series_tpu_torch.models.model import tree_map

FORMAT = "yolo-series-tpu-ckpt-v1"


def _dump(blob, path):
    """Pickle through `<path>.tmp` and `os.replace`, so a reader never
    sees half a file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = str(path) + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(blob, f, protocol=4)
    os.replace(tmp, path)


def _half(tree):
    """fp32 leaves -> fp16, the others as they are (the JAX `cast`)."""
    if isinstance(tree, dict):
        return {k: _half(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_half(v) for v in tree]
    a = np.asarray(tree)
    return a.astype(np.float16) if a.dtype == np.float32 else a


def _opt_to_jax(opt_state):
    out = to_jax_tree(opt_state)
    if "t" in out:   # Adam's step count: an int32 scalar, as JAX holds it
        out["t"] = np.asarray(out["t"], np.int32)
    return out


def save_checkpoint(path, train_state, cfg: dict, *, epoch: int = 0,
                    best_fitness: float = 0.0, results=None, hyp=None,
                    half: bool = True):
    """Write a training checkpoint of the port's `TrainState` in the JAX
    format. `half` stores fp16 params and EMA params (the reference saves
    fp16 copies, train.py:467-469)."""
    weights = (lambda t: _half(to_jax_tree(t))) if half else to_jax_tree  # noqa: E731
    blob = {
        "format": FORMAT,
        "epoch": epoch,
        "best_fitness": best_fitness,
        "results": results,
        "hyp": hyp,
        "cfg": cfg,
        "step": int(train_state.step),
        "params": weights(train_state.params),
        "state": to_jax_tree(train_state.state),
        "ema_params": weights(train_state.ema_params),
        "ema_state": to_jax_tree(train_state.ema_state),
        "opt_state": _opt_to_jax(train_state.opt_state),
    }
    _dump(blob, path)


def load_checkpoint(path):
    """The checkpoint's dict, as it was pickled."""
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


def restore_train_state(blob, opt_cfg, device=None):
    """Checkpoint blob -> the port's `TrainState` on `device` (the card
    unless "cpu" is asked for): fp32 params, BN state and EMA, the
    optimizer state as it was saved. `opt_cfg` is taken for the JAX
    function's signature; the slots carry their own structure."""
    from yolo_series_tpu_torch.train.step import TrainState

    dev = _device(device)
    to_dev = lambda t: tree_map(lambda x: x.to(dev), t)  # noqa: E731
    weights = lambda k: to_dev(from_jax_tree(_fp32(blob[k])))  # noqa: E731
    opt = {k: (int(v) if k == "t" else to_dev(from_jax_tree(v, k)))
           for k, v in blob["opt_state"].items()}
    return TrainState(params=weights("params"), state=weights("state"),
                      opt_state=opt, ema_params=weights("ema_params"),
                      ema_state=weights("ema_state"), step=int(blob["step"]))


def strip_checkpoint(src, dst=None):
    """Finalize for deploy: ema -> params, drop optimizer/results, fp16
    (reference strip_optimizer, general.py:820-833). Returns dst."""
    blob = load_checkpoint(src)
    out = {
        "format": FORMAT,
        "epoch": -1, "best_fitness": blob.get("best_fitness", 0.0),
        "results": None, "hyp": blob.get("hyp"), "cfg": blob["cfg"],
        "step": blob.get("step", 0),
        "params": blob.get("ema_params") or blob["params"],
        "state": blob.get("ema_state") or blob["state"],
        "ema_params": None, "ema_state": None, "opt_state": None,
    }
    dst = dst or src
    _dump(out, dst)
    return dst


def get_latest_run(search_dir="runs"):
    """Newest last.ckpt under search_dir (reference general.py:47-50)."""
    paths = sorted(Path(search_dir).rglob("last.ckpt"),
                   key=lambda p: p.stat().st_mtime)
    return str(paths[-1]) if paths else ""


def load_checkpoint_any(weights: str, cfg: Optional[str] = None,
                        prefer_ema: bool = True):
    """Weights -> (plan, params, state): the port's trees on the CPU, fp32.

    .ckpt    native checkpoint (cfg embedded; `cfg` overrides it)
    .pt      reference/upstream torch checkpoint (`cfg` required;
             `models/torch_import.load_torch_checkpoint`)
    """
    w = str(weights)
    if w.endswith(".pt"):
        if cfg is None:
            raise ValueError("--cfg is required to import a .pt checkpoint")
        from yolo_series_tpu_torch.models.torch_import import load_torch_checkpoint

        plan = compile_graph(cfg)
        params, state = load_torch_checkpoint(w, plan, prefer_ema=prefer_ema)
        return plan, params, state
    blob = load_checkpoint(w)
    plan = compile_graph(blob["cfg"] if cfg is None else cfg)
    params_np = (blob["ema_params"] if prefer_ema and blob.get("ema_params")
                 else blob["params"])
    state_np = (blob["ema_state"] if prefer_ema and blob.get("ema_state")
                else blob["state"])
    params, state = from_jax_params(plan, _fp32(params_np), _fp32(state_np))
    return plan, params, state
