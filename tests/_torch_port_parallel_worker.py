"""Rank functions of the port's data-parallel tests, run in processes that
`yolo_series_tpu_torch.parallel.dist.launch` spawns (gloo on the CPU, one
thread each). They import torch, numpy and the port only (no JAX), take
and return numpy data, and run a list of cases in one group, so that a
test file pays for one launch a kind of case. What each returns is what
its test holds against the JAX package's result on the whole batch."""

import torch

from yolo_series_tpu_torch.losses import (LossHyp, make_compute_loss,
                                          make_compute_loss_aux_ota, make_compute_loss_ota)
from yolo_series_tpu_torch.models import layers as L
from yolo_series_tpu_torch.models.convert import from_jax_params, to_jax_tree
from yolo_series_tpu_torch.models.graph import compile_graph
from yolo_series_tpu_torch.models.model import tree_leaves
from yolo_series_tpu_torch.parallel.dist import host_local_slice, init_distributed
from yolo_series_tpu_torch.train.optim import OptimConfig
from yolo_series_tpu_torch.train.step import TrainState, make_train_step

LOSSES = {"plain": make_compute_loss, "ota": make_compute_loss_ota,
          "aux_ota": make_compute_loss_aux_ota}


def bn_rank(rank, world, init_method, cases):
    """Per case (x NCHW, scale, bias, state, gy, bn_shards): `layers.
    batch_norm` in training on this rank's slice of x, SyncBN over the
    group (per-replica with bn_shards > 1), and its backward from this
    rank's slice of gy: (y, new state, dx, dscale, dbias), the last two
    this rank's own sums."""
    group = init_distributed(rank, world, init_method, "cpu")
    out = []
    for x, scale, bias, state, gy, bn_shards in cases:
        sl = host_local_slice(x.shape[0], rank, world)
        xt = torch.from_numpy(x[sl]).requires_grad_()
        st, bt = (torch.from_numpy(a).requires_grad_() for a in (scale, bias))
        y, new = L.batch_norm({"scale": st, "bias": bt},
                              {k: torch.from_numpy(v) for k, v in state.items()}, xt,
                              L.Ctx(training=True, bn_shards=bn_shards, group=group))
        dx, ds, db = torch.autograd.grad(y, (xt, st, bt), torch.from_numpy(gy[sl]))
        out.append((y.detach().numpy(), {k: v.numpy() for k, v in new.items()}, dx.numpy(),
                    ds.numpy(), db.numpy()))
    return out


def bn_core_rank(rank, world, init_method, cases):
    """Per case (x NCHW, scale, bias, m0, gy, gm, gv): `layers.BnTrainCore`
    under the group on this rank's slice of x, and its backward from this
    rank's slice of gy and its share of the mean's and var's cotangents
    gm and gv (rank r takes r + 1 parts of 1 + ... + world, so the shares
    sum to gm and gv and differ between the ranks): (y, mean, var, dx,
    dscale, dbias), the last two this rank's own sums."""
    group = init_distributed(rank, world, init_method, "cpu")
    share = (rank + 1) / (world * (world + 1) / 2)
    out = []
    for x, scale, bias, m0, gy, gm, gv in cases:
        sl = host_local_slice(x.shape[0], rank, world)
        xt = torch.from_numpy(x[sl]).requires_grad_()
        st, bt = (torch.from_numpy(a).requires_grad_() for a in (scale, bias))
        y, mean, var = L.BnTrainCore.apply(xt, st, bt, torch.from_numpy(m0), group)
        cots = (torch.from_numpy(gy[sl]), torch.from_numpy(gm) * share,
                torch.from_numpy(gv) * share)
        dx, ds, db = torch.autograd.grad((y, mean, var), (xt, st, bt), cots)
        out.append(tuple(t.detach().numpy() for t in (y, mean, var, dx, ds, db)))
    return out


def loss_rank(rank, world, init_method, cases):
    """Per case (loss kind, the port's head, raw maps, labels, mask): the
    loss on this rank's slice of the batch, under the group: (this rank's
    total, the items, the grads of this rank's raw maps)."""
    group = init_distributed(rank, world, init_method, "cpu")
    out = []
    for kind, head, raw, labels, mask in cases:
        sl = host_local_slice(labels.shape[0], rank, world)
        rt = [torch.from_numpy(r[sl]).requires_grad_() for r in raw]
        total, items = LOSSES[kind](head, LossHyp())(
            rt, torch.from_numpy(labels[sl]), torch.from_numpy(mask[sl]), group=group)
        grads = torch.autograd.grad(total, rt)
        out.append((float(total), {k: float(v) for k, v in items.items()},
                    [g.numpy() for g in grads]))
    return out


def port_train_state(plan, ts):
    """A TrainState of the JAX package as numpy trees ({params, state,
    opt_state, ema_params, ema_state, step}) as the port's TrainState."""
    params, state = from_jax_params(plan, ts["params"], ts["state"])
    ema_p, ema_s = from_jax_params(plan, ts["ema_params"], ts["ema_state"])
    opt = {k: from_jax_params(plan, v, ts["state"])[0]
           for k, v in ts["opt_state"].items() if k != "t"}
    if "t" in ts["opt_state"]:
        opt["t"] = int(ts["opt_state"]["t"])
    return TrainState(params, state, opt, ema_p, ema_s, int(ts["step"]))


def step_result(new, metrics):
    """A port step's result as the tests compare it: the new params, state,
    ema_params, ema_state and momentum buffer "v" as JAX-form numpy trees,
    and the metrics as floats."""
    trees = {k: to_jax_tree(getattr(new, k))
             for k in ("params", "state", "ema_params", "ema_state")}
    return {**trees, "v": to_jax_tree(new.opt_state["v"])}, \
        {k: float(v) for k, v in metrics.items()}


def step_rank(rank, world, init_method, cases):
    """Per case (cfg, loss kind, JAX TrainState as numpy trees, batch
    (images, labels, mask; the micro-batch axis leading when accumulate >
    1), lr_groups, momentum, make_train_step options): one fp32 SGD step of
    `make_train_step(mesh=group)` on this rank's slice of the batch, as
    `step_result` gives it."""
    group = init_distributed(rank, world, init_method, "cpu")
    out = []
    for cfg, kind, ts, batch, lr, mom, opts in cases:
        plan = compile_graph(cfg)
        axis = 1 if opts.get("accumulate", 1) > 1 else 0
        sl = host_local_slice(batch[0].shape[axis], rank, world)
        part = [a[:, sl] if axis else a[sl] for a in batch]
        fn = make_train_step(plan, LOSSES[kind](plan.head, LossHyp()), OptimConfig(),
                             mesh=group, compute_dtype=torch.float32, **opts)
        out.append(step_result(*fn(port_train_state(plan, ts), *part, lr, mom)))
    return out


def collectives_rank(rank, world, init_method, sizes, bucket_bytes):
    """`allreduce_grads` (each rank's tensors: rank + 1 times a ramp, in
    buckets of bucket_bytes, set in place of BUCKET_BYTES) and
    `broadcast_tensors` (the leaves of rank 1's tree of ranks, broadcast
    from it): (the reduced tensors, the broadcast tree's leaves, the number
    of buckets)."""
    from yolo_series_tpu_torch.parallel import dist as D

    D.BUCKET_BYTES = bucket_bytes
    group = init_distributed(rank, world, init_method, "cpu")
    grads = [torch.arange(n, dtype=torch.float32) * (rank + 1) for n in sizes]
    summed = D.allreduce_grads(grads, group)
    tree = {"a": [torch.full((3,), float(rank)), torch.full((2, 2), rank, dtype=torch.int64)],
            "b": torch.full((5,), -float(rank)), "step": 7}
    D.broadcast_tensors(tree_leaves(tree), 1, group)
    return ([s.numpy() for s in summed], [t.numpy() for t in tree_leaves(tree)],
            len(D._flat_groups(grads)))


def failing_rank(rank, world, init_method):
    """Rank 1 raises; rank 0 waits at a barrier it never passes."""
    from yolo_series_tpu_torch.parallel.dist import sync_processes

    group = init_distributed(rank, world, init_method, "cpu")
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    sync_processes("never passed", group)


def hanging_rank(rank, world, init_method):
    """Every rank sleeps far past any test's timeout."""
    import time

    time.sleep(3600)


def imported_rank(rank, world, init_method):
    """The names of the modules of JAX (or its TensorFlow relatives) that
    this rank's interpreter holds."""
    import sys

    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tensorflow",
                                                                "yolo_series_tpu"))
