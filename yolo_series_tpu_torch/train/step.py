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

The step runs on the params' device; its metrics are 0-d tensors on that
device, so it makes no host sync.

On a card the step replays a CUDA graph where it can, so that the host
no longer enqueues its several thousand launches every step. The host
computes the step's numbers (learning rates, momentum, Adam's bias
corrections, the EMA's decay) exactly as the eager step does, and fills
them into 0-d tensors that the graph reads. A call is captured when the
params are on a card, there is no group (`mesh`) and no `remat_prefix`,
its signature (the shapes and dtypes of images, labels and mask, and the
numeric flags of cuDNN and matmuls) repeats the previous call's, and the
first call of that signature made no synchronizing CUDA call
(`torch.cuda.set_sync_debug_mode`). Every other call runs eagerly.
Capture warms the step up on a side stream, then records it once; a
replay copies the caller's trees and batch into the graph's inputs and
the graph's outputs into new tensors (views of new buffers, one a dtype
for each output tree), so the caller's `ts` stays as it was and what a
call returns is its own. The process keeps one graph alive: its memory
pool, about an eager step's activations, stays reserved while other
steps (a trainer builds one for each accumulation and size) or other
signatures run eagerly beside it. An eager call that runs out of the
card's memory with a graph alive drops that graph, releases its pool and
runs again (`_eager`); a step leaves its inputs as they were, so the
second call is the first. A `mesh` step does not retry: its ranks would
part in their collectives.

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
time is the input placement and the tree walks. A replay runs none of the
phases: its `train.step` holds the inputs' copy, the replay's launch and
the outputs' copy. `train.capture` spans a capture (warm-up and record).
Counters: `train.steps` every call, and each call once in one of
`train.replays`, `train.captures` and `train.eager.<why>`, why one of
"cpu", "mesh", "remat", "new" (the signature differs from the previous
call's; its first call is checked for syncs), "sync" (that check found
one), "evicted" (its graph was dropped, for another's or for an eager
call's memory) and "capture" (the capture raised).
"""

from __future__ import annotations

import warnings
import weakref
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from yolo_series_tpu_torch.device import device as _device
from yolo_series_tpu_torch.device import graph_capture
from yolo_series_tpu_torch.models.model import apply_model
from yolo_series_tpu_torch.obs import trace
from yolo_series_tpu_torch.train.ema import ema_mix, ema_scalars
from yolo_series_tpu_torch.train.optim import OptimConfig, make_optimizer, make_update
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


def _signature(images, labels, mask):
    """What a captured step is specific to: the batch's shapes, dtypes and
    device, and the flags that choose cuDNN's and the matmuls' numerics."""
    cudnn = torch.backends.cudnn
    return (tuple(images.shape), images.dtype, tuple(labels.shape), labels.dtype,
            tuple(mask.shape), mask.dtype, images.device, cudnn.allow_tf32,
            cudnn.deterministic, cudnn.benchmark, torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision(), torch.are_deterministic_algorithms_enabled())


def _set_sync_debug_mode(mode):
    """`torch.cuda.set_sync_debug_mode` without its notice that the mode is
    a prototype."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Synchronization debug mode is a prototype")
        torch.cuda.set_sync_debug_mode(mode)


def _checking_syncs(fn):
    """(fn(), whether fn made a synchronizing CUDA call): run under
    `torch.cuda.set_sync_debug_mode("warn")`, the sync warnings recorded
    and the mode restored. Under the caller's "error" mode a sync raises,
    as the caller asked; the other warnings are shown as usual."""
    mode = torch.cuda.get_sync_debug_mode()
    if mode == 2:
        return fn(), False
    try:
        _set_sync_debug_mode(1)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        _set_sync_debug_mode(mode)
    synced = False
    for w in caught:
        is_sync = "synchronizing CUDA operation" in str(w.message)
        synced |= is_sync
        if mode or not is_sync:
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
    return out, synced


def _dense_stride(t):
    """t's strides where t is dense (contiguous, or channels-last), else
    the contiguous ones: a layout that spans t.numel() elements."""
    if t.is_contiguous() or (t.dim() == 4
                             and t.is_contiguous(memory_format=torch.channels_last)):
        return t.stride()
    return torch.empty(t.shape, device="meta").stride()


def _by_dtype(ts):
    """{dtype: [indices of ts with it]}, for `_foreach_copy_`'s fast path."""
    out = {}
    for i, t in enumerate(ts):
        out.setdefault(t.dtype, []).append(i)
    return out


class _StepGraph:
    """One step captured as a CUDA graph for one signature: the tensors it
    reads (the TrainState's leaves, the batch, the step's numbers as 0-d
    fp32 tensors) and the tensors it writes."""

    def __init__(self, compute, sig, ts, images, labels, mask, s):
        dev = images.device
        self.sig = sig
        src = leaves(ts) + [images, labels, mask]
        self.inputs = [torch.empty_like(t) for t in src]
        self.in_groups = _by_dtype(self.inputs)
        self.load(src)
        self.nums = {k: torch.full((), v, dtype=torch.float32, device=dev)
                     for k, v in s.items()}
        n = len(src) - 3
        args = (TrainState(*rebuild(tuple(ts), self.inputs[:n])), *self.inputs[n:], self.nums)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            compute(*args)     # warm-up on a side stream, as capture asks
        torch.cuda.current_stream(dev).wait_stream(side)
        # the warm-up's blocks are cached for the side stream, where neither
        # the graph's pool nor a later eager call can use them
        torch.cuda.empty_cache()
        self.graph = torch.cuda.CUDAGraph()
        with graph_capture(self.graph, side):
            out = compute(*args)
        self.dev = dev
        self.parts = [self._layout(part) for part in out]

    @staticmethod
    def _layout(tree):
        """(tree, its leaves, where each lies in a buffer of its dtype,
        the buffers' sizes, the leaves' indices by dtype) of one output."""
        outs, layout, sizes = leaves(tree), [], {}
        for t in outs:
            at = sizes.get(t.dtype, 0)
            layout.append((t.dtype, tuple(t.shape), _dense_stride(t), at))
            sizes[t.dtype] = at + t.numel()
        return tree, outs, layout, sizes, _by_dtype(outs)

    def load(self, src):
        for idx in self.in_groups.values():
            torch._foreach_copy_([self.inputs[i] for i in idx], [src[i] for i in idx])

    def copy_out(self, tree, outs, layout, sizes, groups):
        """A copy of one output tree whose leaves are views of new buffers,
        one a dtype. Each output (params, BN state, optimizer slots, the
        EMA's two, metrics) has buffers of its own, so a caller that keeps
        one (a loss it logs) keeps no other alive."""
        bufs = {dt: torch.empty(n, dtype=dt, device=self.dev) for dt, n in sizes.items()}
        views = [bufs[dt].as_strided(shape, stride, at) for dt, shape, stride, at in layout]
        for idx in groups.values():
            torch._foreach_copy_([views[i] for i in idx], [outs[i] for i in idx])
        return rebuild(tree, views)

    def __call__(self, ts, images, labels, mask, s):
        """The step on these inputs: the caller's copy of the graph's
        outputs, in compute's trees."""
        self.load(leaves(ts) + [images, labels, mask])
        for k, t in self.nums.items():
            t.fill_(s[k])
        self.graph.replay()
        return tuple(self.copy_out(*part) for part in self.parts)


# The captured step alive in the process (a weak reference to its
# `_Capture`): a graph's memory pool holds the step's activations for as
# long as the graph lives, so a capture first drops another step's graph.
_alive = None


def _live():
    """The `_Capture` whose graph is alive in the process, or None."""
    holder = _alive() if _alive is not None else None
    return holder if holder is not None and holder.graph is not None else None


def _eager(run):
    """run(), an eager step's call. Where it runs out of the card's memory
    while a captured step's graph is alive, that graph is dropped, its pool
    released and run called again."""
    try:
        return run()
    except torch.cuda.OutOfMemoryError:
        holder = _live()
        if holder is None:
            raise
    # out of the handler: the failed call's tensors are freed with its traceback
    holder.evict()
    torch.cuda.empty_cache()
    return run()


class _Capture:
    """Whether a train step's call replays, captures or runs eagerly
    (module docstring), and the one graph it holds."""

    def __init__(self):
        self.graph = None
        self.synced = {}       # signature -> whether its first call synced
        self.dropped = {}      # signature -> "evicted" or "capture"
        self.last = None       # the previous call's signature

    def evict(self):
        if self.graph is not None:
            self.dropped[self.graph.sig] = "evicted"
            self.graph = None

    def __call__(self, compute, ts, images, labels, mask, s):
        global _alive
        sig = _signature(images, labels, mask)
        last, self.last = self.last, sig
        run = lambda: compute(ts, images, labels, mask, s)  # noqa: E731
        if self.graph is not None and self.graph.sig == sig:
            trace.count("train.replays")
            return self.graph(ts, images, labels, mask, s)
        if sig not in self.synced:
            out, self.synced[sig] = _eager(lambda: _checking_syncs(run))
            trace.count("train.eager.new")
            return out
        why = ("sync" if self.synced[sig] else self.dropped.get(sig)
               or ("new" if last != sig else None))
        if why is not None:
            trace.count("train.eager." + why)
            return _eager(run)
        holder = _live()
        if holder is not None:
            holder.evict()
        self.evict()
        mode = torch.cuda.get_sync_debug_mode()
        _set_sync_debug_mode(0)              # capture synchronizes on purpose
        try:
            torch.cuda.empty_cache()         # the dropped graph's pool
            with trace.span("train.capture"):
                self.graph = _StepGraph(compute, sig, ts, images, labels, mask, s)
        except RuntimeError:
            pass                             # the capture raised: eagerly below
        finally:
            _set_sync_debug_mode(mode)
        if self.graph is None:
            # out of the handler, so that what the failed capture held is freed
            torch.cuda.empty_cache()
            self.dropped[sig] = "capture"
            trace.count("train.eager.capture")
            return run()
        _alive = weakref.ref(self)
        trace.count("train.captures")
        return self.graph(ts, images, labels, mask, s)


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
    was; nothing it returns is written by a later call.

    mesh: a process group: the batch arguments are this rank's slice of
    the global batch (the micro-batch axis leading, as above), loss_fn
    takes `group=` (the port's losses do), and the step is the global
    batch's (module docstring).

    On a card, without a group or remat, a call whose inputs repeat the
    previous call's shapes and dtypes replays a CUDA graph of the step
    (module docstring, `_Capture`); its numbers are the eager step's.
    """
    if mesh is not None and not isinstance(mesh, dist.ProcessGroup):
        raise TypeError(f"mesh must be a torch.distributed process group, not "
                        f"{type(mesh).__name__}")
    built = {}
    capture = _Capture()

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
            built["opt"] = make_update(opt_cfg, ts.params)
        opt_scalars, _ = built["opt"]
        s, host = opt_scalars(ts.opt_state, lr_groups, momentum)
        s["ema_d"], s["ema_1d"] = ema_scalars(ts.step + 1, ema_base)
        eager = ("cpu" if dev.type != "cuda" else "mesh" if mesh is not None
                 else "remat" if remat_prefix else None)
        if eager is None:
            out = capture(compute, ts, images, labels, mask, s)
        else:
            trace.count("train.eager." + eager)
            run = lambda: compute(ts, images, labels, mask, s)  # noqa: E731
            out = run() if mesh is not None else _eager(run)
        params, state, slots, ema_params, ema_state, metrics = out
        return TrainState(params, state, {**slots, **host}, ema_params, ema_state,
                          ts.step + 1), metrics

    def compute(ts, images, labels, mask, s):
        """The step's device work: (params, BN state, the optimizer's tensor
        slots, EMA params, EMA state, metrics) from the inputs on the
        device and the step's numbers `s` (host numbers, or 0-d tensors
        that hold them in a captured graph)."""
        _, opt_apply = built["opt"]
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
            items = {k: torch.stack([it[k] for it in seq]).mean() for k in seq[0]}
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
            new_params, new_opt = opt_apply(ts.opt_state, ts.params, grad_tree, s)
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
        with trace.span("train.ema"):
            ema_params = ema_mix(ts.ema_params, new_params, s["ema_d"], s["ema_1d"])
            ema_state = ema_mix(ts.ema_state, new_state, s["ema_d"], s["ema_1d"])
        return new_params, new_state, new_opt, ema_params, ema_state, {**items, "total": total}

    return train_step
