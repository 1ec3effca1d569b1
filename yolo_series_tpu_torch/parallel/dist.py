"""Data parallelism across processes: one process a card, `torch.distributed`
collectives, each rank holding its contiguous slice of the global batch and a
full copy of the train state (counterpart of
`yolo_series_tpu/parallel/mesh.py`).

  JAX package (mesh.py)                  | here
  ---------------------------------------+-----------------------------------
  make_mesh, batch_sharding, replicated, | each rank holds its slice of the
  shard_batch,                           |   global batch (`host_local_slice`)
  global_batch_from_host_local           |   and a replica of the state; the
                                         |   group of `init_distributed`
                                         |   stands where the mesh did
  host_local_slice                       | host_local_slice (the same slices)
  init_distributed (jax.distributed)     | init_distributed: NCCL on the card,
                                         |   gloo on the CPU
  sync_processes (sync_global_devices)   | sync_processes (a barrier)
  the gradient reduction XLA inserts     | allreduce_grads: one all_reduce a
                                         |   bucket of a flat buffer
  the replicated TrainState              | broadcast_tensors from rank 0
  process launch (one per host)          | launch: spawns one worker a rank;
                                         |   torchrun's RANK / WORLD_SIZE /
                                         |   LOCAL_RANK read by `env_rank`
  param_partition_specs (tensor-parallel | not here: ROADMAP queue 1 item 12,
  head convs), sharded serving           |   "serving on several cards"

Under the group the train step keeps the JAX package's one-global-batch
semantics: each rank's loss is its share of the global batch's loss (the
losses normalize by all-reduced counts), so the SUM of the ranks' gradients
is the gradient of the global batch, and SyncBN's moments are the global
batch's (`models/layers.py`).
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# rank 0 alone validates and writes checkpoints while the others wait at
# the next collective: the group's timeout has to outlast that
TIMEOUT = datetime.timedelta(minutes=30)
# the gradient all-reduce's bucket (DistributedDataParallel's default size)
BUCKET_BYTES = 25 << 20


def host_local_slice(n: int, rank: int, world: int) -> slice:
    """Rank `rank`'s contiguous slice of a length-n global batch (the
    slices of the JAX package's `host_local_slice`; DistributedSampler's
    partition)."""
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s data generators: `seed` itself on rank 0
    (so rank 0 draws what a one-process run draws), a number drawn from
    (seed, rank) on the others."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def env_rank() -> Optional[Tuple[int, int, int]]:
    """(rank, world, local_rank) from torchrun's RANK, WORLD_SIZE and
    LOCAL_RANK, or None when this process was not started by torchrun."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    rank = int(os.environ["RANK"])
    return rank, int(os.environ["WORLD_SIZE"]), int(os.environ.get("LOCAL_RANK", rank))


def init_distributed(rank: int, world: int, init_method: str, device="cuda",
                     local_rank: Optional[int] = None):
    """Join the process group as rank `rank` of `world` and return the group.

    The backend follows the device: on "cuda" this process takes card
    `local_rank` (`rank` when None; raises when fewer cards are visible)
    and the group is NCCL; on "cpu" it is gloo. One is never swapped for
    the other: NCCL failing on the card raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        local = rank if local_rank is None else local_rank
        n = torch.cuda.device_count()
        if local >= n:
            raise RuntimeError(f"rank {rank} needs CUDA device {local}, but {n} "
                               f"{'is' if n == 1 else 'are'} visible")
        torch.cuda.set_device(local)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {dev}")
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=TIMEOUT)
    return dist.group.WORLD


def world_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank_of(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def sync_processes(tag: str = "barrier", group=None):
    """A barrier over the group (the reference's torch_distributed_zero_first
    and dist.barrier); a no-op with no group or at world 1. `tag` names the
    point in the error a failed barrier raises."""
    if world_size(group) > 1:
        try:
            dist.barrier(group=group)
        except RuntimeError as e:
            raise RuntimeError(f"barrier {tag!r} failed: {e}") from e


def broadcast_object(obj: Any, src: int = 0, group=None) -> Any:
    """Rank src's `obj` (picklable) on every rank; `obj` itself with no group."""
    if world_size(group) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def _flat_groups(tensors: Sequence[torch.Tensor]):
    """The tensors in runs of one dtype and device, each run at most
    BUCKET_BYTES (a tensor larger than that is a run of its own)."""
    runs, cur, size = [], [], 0
    for t in tensors:
        nb = t.numel() * t.element_size()
        if cur and (size + nb > BUCKET_BYTES or t.dtype != cur[0].dtype
                    or t.device != cur[0].device):
            runs.append(cur)
            cur, size = [], 0
        cur.append(t)
        size += nb
    if cur:
        runs.append(cur)
    return runs


def allreduce_grads(grads: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The SUM over the group's ranks of each tensor of `grads`, as a new
    list: the tensors flattened into buckets of at most BUCKET_BYTES, one
    all_reduce a bucket. A sum over one rank is its input, bit for bit."""
    out = []
    for run in _flat_groups(grads):
        flat = torch.cat([g.reshape(-1) for g in run])
        dist.all_reduce(flat, group=group)
        out.extend(c.view_as(g) for c, g in
                   zip(torch.split(flat, [g.numel() for g in run]), run))
    return out


@torch.no_grad()
def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0, group=None):
    """Set every tensor of `tensors` (a tree's leaves) to rank src's, in
    place, one broadcast a bucket of a flat buffer."""
    if world_size(group) == 1:
        return
    for run in _flat_groups(tensors):
        flat = torch.cat([t.reshape(-1) for t in run])
        dist.broadcast(flat, src=src, group=group)
        for c, t in zip(torch.split(flat, [t.numel() for t in run]), run):
            t.copy_(c.view_as(t))


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(fn, rank, world, init_method, args, threads, results):
    if threads:
        torch.set_num_threads(threads)
    try:
        out = fn(rank, world, init_method, *args)
    except BaseException:  # noqa: BLE001 — reported to the parent, then re-raised
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    results.put((rank, True, out))


def launch(fn: Callable, world: int, args: Sequence = (), timeout: Optional[float] = None,
           threads: Optional[int] = None) -> List[Any]:
    """Run fn(rank, world, init_method, *args) in `world` spawned processes
    (`torch.multiprocessing`, "spawn") and return their return values in
    rank order. `init_method` is a tcp:// address on localhost for
    `init_distributed`; fn and args are pickled (a module-level function)
    and so are the return values (return host data). `threads`: each
    worker's torch thread count.

    A worker that raises or dies fails the launch; so does one still
    running `timeout` seconds after the start. Either way every worker is
    killed and RuntimeError (TimeoutError for the timeout) raised, with the
    failed worker's traceback."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://localhost:{free_port()}"
    procs = [ctx.Process(target=_worker, args=(fn, r, world, init_method, tuple(args),
                                               threads, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    got = {}
    try:
        # drain the queue before joining: a worker exits only once what it
        # put has been read
        while len(got) < world:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world - len(got)} of {world} workers still running "
                                   f"after {timeout} s")
            try:
                rank, ok, out = results.get(timeout=0.5)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"worker {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"worker {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(None if deadline is None else max(deadline - time.monotonic(), 1.0))
            if p.is_alive():
                raise TimeoutError(f"a worker did not exit after {timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        results.close()
    return [got[r] for r in range(world)]
