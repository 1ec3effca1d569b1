"""The train step: forward, loss, backward, optimizer update and EMA
(counterpart of `yolo_series_tpu/train/step.py`; reference hot loop
train.py:344-389).

  * compute_dtype (bf16 by default) goes to `apply_model(dtype=...)`, as
    in the JAX package: convs in that dtype, BN in fp32, fp32 params and
    grads; no autocast, which would cast at other points;
  * gradient accumulation sums the grads of `accumulate` micro-batches and
    threads the BN state through them (reference train.py:372-384);
  * the EMA of the params and the BN state follows every update
    (train.py:389).

The step runs eagerly on the params' device; its metrics are 0-d tensors
on that device, so it makes no host sync.

Data parallel (`mesh=` a `torch.distributed` process group, the JAX
argument's name for the port's group handle): every rank holds a replica
of the TrainState (broadcast from rank 0 by the caller, `parallel/dist.
broadcast_tensors`) and its contiguous slice of the global batch. The forward
and loss run on the slice with SyncBN and globally normalized losses, so
the SUM of the ranks' gradients is the global batch's gradient: the
micro-batches' grads are summed locally and all-reduced once a step, in
buckets of a flat buffer (`parallel/dist.allreduce_grads`). The optimizer
and EMA then run alike on every rank. The metrics are the global batch's.
With bn_shards > 1 (per-replica BN, `--no-sync-bn`) the new BN state is
rank 0's, broadcast, as the JAX package's replicated state is shard 0's.

Spans while the tracer is on (`obs/trace`): `train.step` (identifier: the
step's number), and in it `train.forward` (`_images`, `apply_model`),
`train.loss`, `train.backward` (the gradients and the zeros of unused
ones), each once a micro-batch, `train.allreduce` (with `mesh`),
`train.optim` (the update and `freeze`) and `train.ema`; the step's self
time is the input placement and the tree walks. Counter `train.steps`.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from yolo_series_tpu_torch.device import device as _device
from yolo_series_tpu_torch.models.model import apply_model
from yolo_series_tpu_torch.obs import trace
from yolo_series_tpu_torch.train.ema import ema_update
from yolo_series_tpu_torch.train.optim import OptimConfig, make_optimizer
from yolo_series_tpu_torch.models.model import tree_leaves as leaves
from yolo_series_tpu_torch.models.model import tree_rebuild as rebuild
from yolo_series_tpu_torch.parallel.dist import allreduce_grads, broadcast_tensors


class TrainState(NamedTuple):
    params: Any
    state: Any          # BN running stats
    opt_state: Any
    ema_params: Any
    ema_state: Any
    step: int           # optimizer steps taken


def _copy(tree, dev):
    return rebuild(tree, [t.detach().to(dev, copy=True) for t in leaves(tree)])


def init_train_state(params, state, opt_cfg: OptimConfig, device=None) -> TrainState:
    """A TrainState on `device` (the card unless "cpu" is asked for; raises
    when no card is visible) with independent copies of params and state
    for the params, the EMA and the BN state, and a zero optimizer state."""
    dev = _device(device)
    opt_init, _ = make_optimizer(opt_cfg, params)
    p = _copy(params, dev)
    return TrainState(params=p, state=_copy(state, dev), opt_state=opt_init(p),
                      ema_params=_copy(params, dev), ema_state=_copy(state, dev), step=0)


def _images(images, resize_to):
    """uint8 -> fp32 / 255 on the device; then the bilinear resize of
    `jax.image.resize`, which antialiases when it shrinks."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    if resize_to is not None and resize_to != images.shape[-3]:
        x = images.permute(0, 3, 1, 2)
        x = F.interpolate(x, size=(resize_to, resize_to), mode="bilinear",
                          align_corners=False, antialias=True)
        images = x.permute(0, 2, 3, 1)
    return images


def make_train_step(plan, loss_fn: Callable, opt_cfg: OptimConfig,
                    mesh=None, accumulate: int = 1,
                    compute_dtype=torch.bfloat16,
                    ema_base: float = 0.9999,
                    freeze: int = 0,
                    resize_to: Optional[int] = None,
                    loss_scale: float = 1.0,
                    bn_shards: int = 1,
                    remat_prefix: int = 0):
    """train_step(ts, images, labels, label_mask, lr_groups, momentum) ->
    (new_ts, metrics).

    images: (accumulate, B, H, W, 3) when accumulate > 1, else (B, H, W,
    3), uint8 or float in [0, 1]; labels (B, M, 5) and label_mask (B, M)
    with the same leading layout. loss_fn(raw, labels, mask) -> (loss x B,
    items). lr_groups (3,) and momentum: host numbers (`warmup_factors`).
    The accumulated gradient is the sum over micro-batches; the logged
    losses are their mean. loss_scale scales the gradient only. freeze > 0
    keeps the params and the optimizer's "v" slot of the first `freeze`
    layers as they were (for Adam that is the second moment; "m" moves, as
    in the JAX package). bn_shards > 1: per-replica BN over that many
    groups of the global batch. remat_prefix k > 0: the first k layers are
    recomputed in the backward (`apply_model`), with the same numbers.
    metrics {"box", "obj", "cls", "total"}: 0-d
    tensors on the device. The step builds new trees and leaves `ts` as it
    was.

    mesh: a process group: the batch arguments are this rank's slice of
    the global batch (the micro-batch axis leading, as above), loss_fn
    takes `group=` (the port's losses do), and the step is the global
    batch's (module docstring).
    """
    if mesh is not None and not isinstance(mesh, dist.ProcessGroup):
        raise TypeError(f"mesh must be a torch.distributed process group, not "
                        f"{type(mesh).__name__}")
    built = {}

    def loss_and_grad(params, state, images, labels, mask):
        ps = [t.detach().requires_grad_() for t in leaves(params)]
        tree = rebuild(params, ps)
        with trace.span("train.forward"):
            images = _images(images, resize_to)
            out, new_state = apply_model(plan, tree, state, images,
                                         training=True, dtype=compute_dtype,
                                         bn_shards=bn_shards, group=mesh,
                                         remat_prefix=remat_prefix)
        with trace.span("train.loss"):
            total, items = loss_fn(out["raw"], labels, mask, group=mesh)
            scaled = total * loss_scale
        with trace.span("train.backward"):
            grads = torch.autograd.grad(scaled, ps, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(ps, grads)]
        items = {k: v.detach() for k, v in items.items()}
        return scaled.detach() / loss_scale, items, new_state, grads

    def train_step(ts: TrainState, images, labels, mask, lr_groups, momentum):
        with trace.span("train.step", ident=ts.step + 1):
            trace.count("train.steps")
            return step_body(ts, images, labels, mask, lr_groups, momentum)

    def step_body(ts, images, labels, mask, lr_groups, momentum):
        dev = leaves(ts.params)[0].device
        images = torch.as_tensor(images).to(dev, non_blocking=True)
        labels = torch.as_tensor(labels, dtype=torch.float32).to(dev, non_blocking=True)
        mask = torch.as_tensor(mask, dtype=torch.bool).to(dev, non_blocking=True)
        if "opt" not in built:
            built["opt"] = make_optimizer(opt_cfg, ts.params)
        _, opt_update = built["opt"]

        if accumulate > 1:
            grads, state_c, total, seq = None, ts.state, 0.0, []
            for a in range(accumulate):
                tot, items, state_c, g = loss_and_grad(ts.params, state_c, images[a],
                                                       labels[a], mask[a])
                grads = g if grads is None else torch._foreach_add(grads, g)
                total = total + tot
                seq.append(items)
            new_state = state_c
            total = total / accumulate
            items = {k: torch.stack([s[k] for s in seq]).mean() for k in seq[0]}
        else:
            total, items, new_state, grads = loss_and_grad(ts.params, ts.state, images,
                                                           labels, mask)
        if mesh is not None:
            with trace.span("train.allreduce"):
                # this rank's total is its share of the global batch's
                total = total.clone()
                dist.all_reduce(total, group=mesh)
                grads = allreduce_grads(grads, mesh)
                if bn_shards > 1:
                    broadcast_tensors(leaves(new_state), 0, mesh)

        grad_tree = rebuild(ts.params, grads)
        with trace.span("train.optim"):
            new_params, new_opt = opt_update(ts.opt_state, ts.params, grad_tree,
                                             lr_groups, momentum)
            if freeze > 0:
                # hard-freeze the first `freeze` layers: params and the "v"
                # slot (reference --freeze, train.py:102-107)
                pl = list(new_params["layers"])
                vl = list(new_opt["v"]["layers"])
                for li in range(min(freeze, len(pl))):
                    pl[li] = ts.params["layers"][li]
                    vl[li] = ts.opt_state["v"]["layers"][li]
                new_params = {**new_params, "layers": pl}
                new_opt = {**new_opt, "v": {**new_opt["v"], "layers": vl}}
        step = ts.step + 1
        with trace.span("train.ema"):
            ema_params = ema_update(ts.ema_params, new_params, step, ema_base)
            ema_state = ema_update(ts.ema_state, new_state, step, ema_base)
        new_ts = TrainState(new_params, new_state, new_opt, ema_params, ema_state, step)
        return new_ts, {**items, "total": total}

    return train_step
