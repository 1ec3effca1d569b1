"""The ('data', 'model') device grid and the tensor-parallel sharding rule
(counterpart of `yolo_series_tpu/parallel/mesh.py`'s `make_mesh` and
`param_partition_specs`).

JAX's mesh is driven by one controller: `jax.jit(serve, in_shardings=...)`
runs one program over a grid of devices. Its counterpart here is one
process driving a grid of `torch.device`s: no process group and no
collective library, so a grid may name one card several times (a 2x2
grid over four views of `cuda:0`) or the CPU four times, as the tests do.

  data axis   each row of the grid holds a contiguous slice of the batch
              (`dist.host_local_slice`) and a replica of the weights;
  model axis  every conv weight named "w" whose output channels divide the
              axis size is cut along its output channels (OIHW dim 0; JAX
              cuts HWIO axis 3): each device of the row computes its own
              channels, and the row gathers them (`ShardedWeight`).

The rest of JAX's mesh.py (batch sharding, host-local slices, process
init, barriers) is `parallel/dist.py`'s; the sharded engine that uses the
grid is `infer/serving.ShardedServingEngine`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (n_data, n_model) grid of devices, axes ('data', 'model')."""

    devices: np.ndarray     # object array of torch.device, (n_data, n_model)

    @property
    def n_data(self) -> int:
        return self.devices.shape[0]

    @property
    def n_model(self) -> int:
        return self.devices.shape[1]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ('data', 'model') grid over `devices` in JAX's order:
    `devices[: n_data * n_model].reshape(n_data, n_model)`. devices: every
    visible card when None (raises when there is none); any list of
    devices, repeats included. n_data: as many rows as the devices fill."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device is visible; pass devices=['cpu', ...] "
                               "to build a grid on the CPU")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > len(devices):
        raise ValueError(f"a {n_data} x {n_model} grid needs {n_data * n_model} devices, "
                         f"{len(devices)} given")
    grid = np.empty((n_data, n_model), dtype=object)
    for i, d in enumerate(devices[: n_data * n_model]):
        grid[i // n_model, i % n_model] = d
    return Mesh(grid)


def param_partition_specs(params, n_model: int):
    """The tensor-parallel rule of the JAX package: the tree of `params`
    with each leaf the dim to cut over the model axis, or None to
    replicate. A leaf named "w" (its nearest dict key) of ndim 4 whose
    output channels (OIHW dim 0) divide `n_model` is cut along dim 0;
    biases, BN, implicit vectors, odd-channel head convs and int8 "wq"
    leaves are replicated."""
    def spec(t, name):
        if isinstance(t, dict):
            return {k: spec(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(spec(v, name) for v in t)
        if (name == "w" and isinstance(t, torch.Tensor) and t.ndim == 4
                and t.shape[0] % n_model == 0):
            return 0
        return None

    return spec(params, None)


def shard_params(params, specs, devices: Sequence) -> List[Any]:
    """One tree a device of the model axis: tree k holds the k-th of
    len(devices) equal slices of every leaf cut by `specs`
    (`param_partition_specs`) and a copy of every other leaf, on
    devices[k]."""
    n = len(devices)

    def cut(t, s, k):
        if isinstance(t, dict):
            return {key: cut(v, s[key], k) for key, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(cut(v, sv, k) for v, sv in zip(t, s))
        if not isinstance(t, torch.Tensor):
            return t
        if s is not None:
            t = t.chunk(n, dim=s)[k]
        return t.to(devices[k]).contiguous()

    return [cut(params, specs, k) for k in range(n)]


class ShardedWeight:
    """A conv weight cut along its output channels over a row of the grid.

    `layers.conv2d` calls it in place of F.conv2d: the input goes to each
    device of the row, each device convolves it with its own slice of the
    weight and of the bias, and the slices are gathered in channel order
    on the row's lead device (devices[0]), where the replicated work (BN,
    activations, pools, concats, the head's NMS) runs once. The gathered
    output is the unsharded conv's, channel for channel."""

    def __init__(self, shards: Sequence[torch.Tensor]):
        self.shards = list(shards)
        self.lead = self.shards[0].device
        self.sizes = [s.shape[0] for s in self.shards]

    def conv2d(self, x, b, stride, padding, groups, dtype):
        if groups != 1 and groups % len(self.shards):
            raise ValueError(f"a conv of {groups} groups does not cut over "
                             f"{len(self.shards)} devices")
        gk = groups if groups == 1 else groups // len(self.shards)
        cin_k = x.shape[1] // len(self.shards) if groups != 1 else x.shape[1]
        outs, off = [], 0
        for k, (w, n) in enumerate(zip(self.shards, self.sizes)):
            xk = x if groups == 1 else x[:, k * cin_k:(k + 1) * cin_k]
            xk = xk.to(w.device, dtype)
            bk = None if b is None else b[off:off + n].to(w.device, dtype)
            outs.append(torch.nn.functional.conv2d(xk, w.to(dtype), bk, stride, padding,
                                                   1, gk))
            off += n
        return torch.cat([y.to(self.lead) for y in outs], dim=1)


def tensor_parallel_params(params, devices: Sequence):
    """`params` for a row of the grid: every leaf that
    `param_partition_specs` cuts becomes a `ShardedWeight` over `devices`,
    every other leaf sits on devices[0]."""
    specs = param_partition_specs(params, len(devices))
    trees = shard_params(params, specs, devices)

    def join(s, *ts):
        if isinstance(s, dict):
            return {key: join(s[key], *(t[key] for t in ts)) for key in s}
        if isinstance(s, (list, tuple)):
            return type(s)(join(sv, *(t[i] for t in ts)) for i, sv in enumerate(s))
        return ShardedWeight(ts) if s is not None else ts[0]

    return join(specs, *trees)
