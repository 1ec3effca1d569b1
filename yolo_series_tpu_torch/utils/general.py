"""Host utilities (counterpart of `yolo_series_tpu/utils/general.py`:
seeds, image-size rounding, class and image weights, dataset checks,
polygon helpers, `increment_path`, and the timing and size summaries
`profile_fn` and `model_info`; reference utils/general.py,
torch_utils.py).

`model_info`'s GFLOPs count what the JAX package's XLA cost analysis
counts, from the forward's own operations (`FlopCounter`), in two parts.
The dense part, two per multiply-add of every convolution over the taps
that fall inside the input (XLA counts no padding tap) and of every
matmul, and window - 1 compares per output of a max pool, is XLA's own
arithmetic and equals its count of those operations. The pointwise part,
one per output element of every other floating-point operation, cannot
equal XLA's, which spells the elementwise work in other operations (SiLU
as 4 an element, LeakyReLU as 3, the conv bias as its own add): it is
0.58-0.66 of XLA's on yolov7 and tiny at 64 px, where XLA's is 0.7-1.2%
of its total. `tools/torch_zoo_flops.py` reports the dense part.
"""

from __future__ import annotations

import glob
import math
import random
import re
from pathlib import Path
from typing import Sequence

import numpy as np


def set_seeds(seed: int = 0):
    """Seed Python's `random`, numpy's global generator and torch's
    (reference init_seeds, general.py:34-44)."""
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def make_divisible(x, divisor=8):
    return math.ceil(x / divisor) * divisor


def check_img_size(img_size: int, stride: int = 32) -> int:
    """Round image size up to a stride multiple (reference general.py:124)."""
    new = make_divisible(img_size, stride)
    if new != img_size:
        print(f"WARNING: --img-size {img_size} updated to multiple of "
              f"max stride {stride}: {new}")
    return new


def colorstr(*input_):
    *args, string = input_ if len(input_) > 1 else ("blue", "bold", input_[0])
    colors = {"black": "\033[30m", "red": "\033[31m", "green": "\033[32m",
              "yellow": "\033[33m", "blue": "\033[34m", "magenta": "\033[35m",
              "cyan": "\033[36m", "white": "\033[37m", "bold": "\033[1m",
              "end": "\033[0m"}
    return "".join(colors[x] for x in args) + f"{string}" + colors["end"]


def labels_to_class_weights(labels: Sequence[np.ndarray], nc: int = 80):
    """Inverse-frequency class weights (reference general.py:181-196)."""
    if not len(labels):
        return np.ones(nc)
    classes = np.concatenate([lb[:, 0] for lb in labels if len(lb)]).astype(int)
    weights = np.bincount(classes, minlength=nc).astype(float)
    weights[weights == 0] = 1
    weights = 1.0 / weights
    return weights / weights.sum()


def labels_to_image_weights(labels, nc=80, class_weights=None):
    """Per-image sampling weights from class weights (general.py:199-205)."""
    if class_weights is None:
        class_weights = np.ones(nc)
    counts = np.array(
        [np.bincount(lb[:, 0].astype(int), minlength=nc) for lb in labels])
    return (class_weights.reshape(1, nc) * counts).sum(1)


def _first_cuda(tree):
    """The device of the first CUDA tensor in a (nested) output, or None."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.device if tree.is_cuda else None
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else ())
    for t in items:
        dev = _first_cuda(t)
        if dev is not None:
            return dev
    return None


def profile_fn(fn, *args, n=10, name=""):
    """Seconds per call of fn(*args), the mean of n calls after one warm-up
    call (reference torch_utils.profile, :96-132): between two CUDA events
    on the current stream when the output lies on the card, on the host
    clock otherwise."""
    import time

    import torch

    out = fn(*args)
    dev = _first_cuda(out)
    if dev is not None:
        torch.cuda.synchronize(dev)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n):
            fn(*args)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / n
    else:
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*args)
        dt = (time.perf_counter() - t0) / n
    if name:
        print(f"{name}: {dt * 1e3:.2f} ms")
    return dt


def _valid_taps(n_in: int, n_out: int, k: int, s: int, p: int, d: int) -> int:
    """(output, kernel) index pairs of one spatial axis whose input index
    falls inside the input: the taps a convolution multiplies by data."""
    return sum(1 for o in range(n_out) for j in range(k) if 0 <= o * s - p + j * d < n_in)


class FlopCounter:
    """Operations of the torch calls made inside `with FlopCounter() as c`,
    counted as the module docstring says, in two parts: `c.dense`, the
    convolutions', matmuls' and max pools' (XLA's arithmetic for the same
    operations), and `c.pointwise`, every other floating-point element
    written; `c.flops` is their sum."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                counter._count(func, args, out)
                return out

        self.dense = self.pointwise = 0
        self._mode = _Mode()

    @property
    def flops(self) -> int:
        return self.dense + self.pointwise

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)

    def _count(self, func, args, out):
        import torch

        aten = torch.ops.aten
        if func in (aten.convolution.default, aten.conv2d.default):
            self.dense += _conv_flops(func is aten.convolution.default, args, out)
        elif func is aten.conv_transpose2d.input:   # every input pixel meets every tap
            self.dense += 2 * args[0].numel() * args[1][0].numel()
        elif func in (aten.mm.default, aten.bmm.default, aten.matmul.default):
            self.dense += 2 * out.numel() * args[0].shape[-1]
        elif func in (aten.addmm.default, aten.baddbmm.default, aten.linear.default):
            a = args[0] if func is aten.linear.default else args[1]
            self.dense += 2 * out.numel() * a.shape[-1]
        elif func in (aten.max_pool2d.default, aten.max_pool2d_with_indices.default):
            k = args[1] if len(args[1]) == 2 else [args[1][0]] * 2   # window - 1 compares
            o = out[0] if isinstance(out, tuple) else out
            self.dense += o.numel() * (k[0] * k[1] - 1)
        elif (torch.Tag.pointwise in func.tags and isinstance(out, torch.Tensor)
              and out.is_floating_point()):
            self.pointwise += out.numel()


def _conv_flops(full: bool, args, out) -> int:
    """Operations of aten.convolution (full=True: its signature, with
    `transposed`) or aten.conv2d over the taps inside the input."""
    x, w = args[0], args[1]
    if full:
        stride, pad, dil, transposed = args[3:7]
        if transposed:   # every input pixel meets every tap
            return 2 * x.numel() * w[0].numel()
    else:
        stride, pad, dil = (list(args[i]) if len(args) > i else [d]
                            for i, d in ((3, 1), (4, 0), (5, 1)))
    nd = x.ndim - 2
    stride, dil = ([v[0]] * nd if len(v) == 1 else v for v in (stride, dil))
    if isinstance(pad, str):
        pad = [0] * nd if pad == "valid" else [(k - 1) * d // 2
                                               for k, d in zip(w.shape[2:], dil)]
    elif len(pad) == 1:
        pad = [pad[0]] * nd
    taps = 1
    for ax in range(nd):
        taps *= _valid_taps(x.shape[2 + ax], out.shape[2 + ax], w.shape[2 + ax], stride[ax],
                            pad[ax], dil[ax])
    return 2 * x.shape[0] * w.shape[0] * w.shape[1] * taps


def model_info(plan, params, state, img_size=640):
    """Layers, parameters and GFLOPs of one image at img_size (reference
    torch_utils.model_info, :204-225, which uses thop; the JAX package
    XLA's cost analysis): the fp32 inference forward of one blank image
    runs once on the params' device under `FlopCounter`."""
    import torch

    from yolo_series_tpu_torch.models.model import apply_model, tree_leaves

    leaves = tree_leaves(params)
    n_p = sum(t.numel() for t in leaves)
    x = torch.zeros((1, img_size, img_size, 3), device=leaves[0].device)
    with torch.inference_mode(), FlopCounter() as c:
        apply_model(plan, params, state, x)
    gflops = c.flops / 1e9
    print(f"model: {len(plan.layers)} layers, {n_p:,} parameters, "
          f"{gflops:.1f} GFLOPs @ {img_size}px")
    return {"layers": len(plan.layers), "parameters": n_p, "gflops": gflops}


def clean_str(s: str) -> str:
    """Sanitize a string for filenames (reference general.py clean_str)."""
    return re.sub(pattern="[|@#!¡·$€%&()=?¿^*;:,¨´><+]", repl="_", string=s)


def check_file(file: str) -> str:
    """The path if it exists, else the one file of that name under the
    working directory (reference general.py check_file)."""
    if not file or Path(file).is_file():
        return file
    files = glob.glob(f"./**/{Path(file).name}", recursive=True)
    if not files:
        raise FileNotFoundError(f"File not found: {file}")
    if len(files) > 1:
        raise FileNotFoundError(f"Multiple files match '{file}': {files}")
    return files[0]


def check_dataset(data: dict):
    """Raise when a split path of the data dict does not exist (reference
    general.py check_dataset, without its download: nothing is fetched)."""
    missing = [f"{split}: {data[split]}" for split in ("train", "val", "test")
               if data.get(split) and not Path(data[split]).exists()]
    if missing:
        raise FileNotFoundError(
            "dataset paths not found (no network egress to download): "
            + "; ".join(missing))


def segments2boxes(segments):
    """Polygon segments -> (n, 4) xywh boxes (reference general.py
    segments2boxes)."""
    boxes = []
    for s in segments:
        x, y = s.T
        boxes.append([x.min(), y.min(), x.max(), y.max()])
    b = np.array(boxes, np.float32).reshape(-1, 4)
    out = np.empty_like(b)
    out[:, 0] = (b[:, 0] + b[:, 2]) / 2
    out[:, 1] = (b[:, 1] + b[:, 3]) / 2
    out[:, 2] = b[:, 2] - b[:, 0]
    out[:, 3] = b[:, 3] - b[:, 1]
    return out


def resample_segments(segments, n: int = 1000):
    """Each polygon resampled to n points by linear interpolation along the
    closed contour (reference general.py resample_segments)."""
    out = []
    for s in segments:
        s = np.concatenate((s, s[0:1, :]), axis=0)
        x = np.linspace(0, len(s) - 1, n)
        xp = np.arange(len(s))
        out.append(np.concatenate(
            [np.interp(x, xp, s[:, i]) for i in range(2)]
        ).reshape(2, -1).T)
    return out


def increment_path(path, exist_ok=False):
    """runs/detect/exp -> exp{2,3,...}: the first of them that does not
    exist (`path` itself when it does not, or with exist_ok; reference
    general.py:891-904)."""
    path = Path(path)
    if not path.exists() or exist_ok:
        return path
    for n in range(2, 9999):
        p = Path(f"{path}{n}")
        if not p.exists():
            return p
    raise RuntimeError("too many runs")
