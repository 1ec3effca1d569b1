"""Device selection for the port's entry points.

JAX counterpart: none as a module — the JAX package places arrays with
`jax.devices()` / `jax.default_device`. Here every entry point takes an
explicit `device` and runs on CUDA unless the caller asks for the CPU.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Union

import torch


def device(name: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on.

    `None` means the card: CUDA device 0 of this process. Raises when no
    CUDA device is visible, so a missing card is never silently replaced
    by the CPU; pass `"cpu"` to run on the CPU on purpose.
    """
    d = torch.device("cuda" if name is None else name)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run on the CPU")
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {d}")
    return d


# the pins entered and not yet left, and the flags the first one replaced
_pins = {"depth": 0, "saved": None}
_pins_lock = threading.Lock()


@contextlib.contextmanager
def full_fp32(enabled: bool = True) -> Iterator[None]:
    """Inside, when `enabled`: cuDNN convolutions and CUDA matmuls in full
    fp32, not TF32.

    Torch's default lets cuDNN run fp32 convolutions in TF32 (about three
    decimal digits); the JAX package computes fp32 in fp32. The entry
    points that promise an fp32 forward run it in here, whatever the
    caller's global flags are: cuDNN's flags (`torch.backends.cudnn.
    set_flags`, TF32 off, the others as they were) and the matmul precision
    (`torch.get_float32_matmul_precision`, "highest") are restored on the
    way out, exactly as they were. Not enabled (a bf16 forward), the flags
    are left alone.

    The flags are process-global: while one thread is in here, every
    thread's fp32 convolutions and matmuls run without TF32. Pins entered
    from several threads at once restore the flags when the last one
    leaves, so none restores them under another.
    """
    if not enabled:
        yield
        return
    cudnn = torch.backends.cudnn
    with _pins_lock:
        if _pins["depth"] == 0:
            matmul = torch.get_float32_matmul_precision()
            flags = cudnn.set_flags(cudnn.enabled, cudnn.benchmark, cudnn.benchmark_limit,
                                    cudnn.deterministic, False)
            torch.set_float32_matmul_precision("highest")
            _pins["saved"] = flags, matmul
        _pins["depth"] += 1
    try:
        yield
    finally:
        with _pins_lock:
            _pins["depth"] -= 1
            if _pins["depth"] == 0:
                flags, matmul = _pins["saved"]
                cudnn.set_flags(*flags)
                torch.set_float32_matmul_precision(matmul)


@contextlib.contextmanager
def graph_capture(graph: "torch.cuda.CUDAGraph", stream: "torch.cuda.Stream",
                  **kw) -> Iterator[None]:
    """`torch.cuda.graph(graph, stream=stream, **kw)` on a memory pool of
    its own, which a capture that raises gives back, with the caller's
    stream current again.

    Where `CUDAGraph.capture_end` raises before it ends (a capture that the
    stream had invalidated, by a host sync say), PyTorch leaves the
    capture's stream current and the allocator routing the stream's
    allocations to the graph's pool, which no graph then releases: every
    later allocation asks its stream whether it is captured, and no cache
    is emptied again in the process.
    """
    pool = torch.cuda.graph_pool_handle()
    caller = torch.cuda.current_stream(stream.device)
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream, **kw):
            yield
    except Exception:
        torch.cuda.set_stream(caller)
        _end_failed_capture(graph, stream.device.index, pool)
        raise


def _end_failed_capture(graph, index: int, pool) -> None:
    """End the allocator's routing to a failed capture's pool and release
    the pool, unless `capture_end` got that far."""
    try:
        graph.pool()            # raises unless the capture ended
        return                  # ended: the graph releases its pool
    except RuntimeError:
        pass
    try:
        torch._C._cuda_endAllocateToPool(index, pool)
    except RuntimeError:
        return                  # capture_end had ended the routing
    torch._C._cuda_releasePool(index, pool)
