"""ctypes binding of the port's native loader core
(`yolo_series_tpu_torch/native/loader.cc`; counterpart of
`yolo_series_tpu/data/native.py`).

`load_letterbox_batch(paths, img_size)` decodes and letterboxes a whole
batch in one C++ call over a thread pool. The library is built from the
port's own source at first use, `g++ -O3 -shared -fPIC` against OpenCV,
into `build/native/` at the root of the checkout (one file a version of
the source, so an edited source is rebuilt). Where g++ or OpenCV's headers
are missing, or the build fails, `load_letterbox_batch` returns None, as
the JAX binding does, and `native_status()` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "yolo_series_tpu_torch" / "native" / "loader.cc"
BUILD_DIR = _ROOT / "build" / "native"
OPENCV_INCLUDE = Path("/usr/include/opencv4")
_state = {"lib": None, "checked": False, "status": "not built yet"}
_lock = threading.Lock()


def library_path() -> Path:
    """Where this version of the source builds to."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libysl_loader_{digest}.so"


def _build(so: Path) -> Optional[str]:
    """Compile the source into `so`; None on success, else the reason."""
    if shutil.which("g++") is None:
        return "no g++ on PATH"
    if not (OPENCV_INCLUDE / "opencv2" / "core.hpp").exists():
        return f"no OpenCV headers under {OPENCV_INCLUDE}"
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", f"-I{OPENCV_INCLUDE}",
           str(SOURCE), "-lopencv_core", "-lopencv_imgcodecs", "-lopencv_imgproc",
           "-lpthread", "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"g++ failed to run: {e!r}"
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"g++ exited with {res.returncode}: {res.stderr.strip()[-2000:]}"
    os.replace(tmp, so)   # atomic: a concurrent build sees the old file or the new
    return None


def _load_lib():
    with _lock:
        if _state["checked"]:
            return _state["lib"]
        _state["checked"] = True
        so = library_path()
        if not so.exists():
            why = _build(so)
            if why is not None:
                _state["status"] = f"not built: {why}"
                return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            _state["status"] = f"built, not loadable: {e}"
            return None
        lib.ysl_load_letterbox_batch.restype = ctypes.c_int
        lib.ysl_load_letterbox_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        _state["lib"] = lib
        _state["status"] = f"loaded {so.relative_to(_ROOT)}"
        return lib


def native_available() -> bool:
    return _load_lib() is not None


def native_status() -> str:
    """What happened to the library: loaded from where, or why not."""
    _load_lib()
    return _state["status"]


def load_letterbox_batch(paths: Sequence[str], img_size: int, scaleup: bool = False,
                         n_threads: int = 4) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(images (n, s, s, 3) uint8 RGB, metas (n, 6) fp32 rows [ratio, dw,
    dh, h0, w0, ok]), or None when the library is missing. An image that
    does not decode is 114-grey with ok 0."""
    lib = _load_lib()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, img_size, img_size, 3), np.uint8)
    metas = np.empty((n, 6), np.float32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.ysl_load_letterbox_batch(
        arr, n, img_size, int(scaleup),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        metas.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads)
    return out, metas
