"""Host utilities (counterpart of `yolo_series_tpu/utils/general.py`:
seeds, image-size rounding, class and image weights, dataset checks,
polygon helpers and `increment_path`; reference utils/general.py).

`profile_fn` and `model_info` are ROADMAP queue 1, item 19.
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
