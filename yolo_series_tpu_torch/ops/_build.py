"""Build and load the port's CUDA kernels (`csrc/*.cu`).

JAX counterpart: none — Pallas kernels are traced and compiled by JAX
itself. Here each source is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface under `build/torch_kernels/` at the root
of the checkout (listed in .gitignore), at first use, and loaded with
`ctypes`. A library is named by a hash of its source and flags, so an
edited source is rebuilt and an unchanged one is reused.

Every C entry point takes device pointers and the CUDA stream as
`c_void_p`, launches on that stream without synchronising, and returns
`cudaGetLastError()`; `check()` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
# per-source extra flags: the keep-mask's IoU and the int8 matmul's dequant
# epilogue must round exactly as their plain PyTorch versions do, so no
# multiply-add contraction in those files. conv_silu reaches libcuda's
# cuTensorMapEncodeTiled (TMA descriptors) through the runtime's entry-point
# query (cudaGetDriverEntryPoint), so no -lcuda, and it is raw PTX with no
# CUTLASS include; int8_mm takes the same route. -Xptxas -v puts the
# registers, shared memory and spills of each kernel in its build log.
PTXAS_V = ["-Xptxas", "-v"]
EXTRA_FLAGS = {"nms_keep": ["-fmad=false"] + PTXAS_V, "int8_mm": ["-fmad=false"] + PTXAS_V,
               "conv_silu": PTXAS_V}
SOURCES = ("nms_keep", "conv_silu", "int8_mm")

_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output of each source compiled by this process
LOGS: Dict[str, str] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, [])
    tag = hashlib.sha1(src + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _command(name: str, out: Path) -> List[str]:
    return ([_nvcc()] + NVCC_FLAGS + EXTRA_FLAGS.get(name, [])
            + ["-o", str(out), str(CSRC / f"{name}.cu")])


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every named source that has no current library, one `nvcc`
    per source, all started together. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs.append((name, out, tmp, subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        LOGS[name] = log
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(stream: Optional[object] = None) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream as a ctypes pointer."""
    import torch

    s = stream if stream is not None else torch.cuda.current_stream()
    return ctypes.c_void_p(s.cuda_stream)
