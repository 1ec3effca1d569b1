"""Dataset maintenance tools (counterpart of `yolo_series_tpu/data/tools.py`):
flatten, box extraction, auto train/val/test splits (reference
utils/datasets.py:1536-1613). Host-side file utilities, numpy and cv2.
"""

from __future__ import annotations

import random
import shutil
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

from yolo_series_tpu_torch.data.parsers import img2label_paths

IMG_FORMATS = ("bmp", "jpg", "jpeg", "png", "tif", "tiff", "dng", "webp", "mpo")


def create_folder(path: str | Path = "./new") -> Path:
    """Fresh output folder, deleting any existing one
    (reference datasets.py:1536-1540)."""
    path = Path(path)
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    return path


def flatten_recursive(path: str | Path = "../coco") -> Path:
    """Copy every file in the tree into a flat sibling dir `<path>_flat`
    (reference datasets.py:1543-1548)."""
    path = Path(path)
    new_path = create_folder(str(path) + "_flat")
    for file in sorted(path.rglob("*.*")):
        if file.is_file():
            shutil.copyfile(file, new_path / file.name)
    return new_path


def extract_boxes(path: str | Path = "../coco") -> Path:
    """Crop every labeled box into `<path>/classifier/<cls>/...jpg`,
    turning a detection dataset into a classification one
    (reference datasets.py:1551-1584). Boxes padded 1.2x + 3px.
    """
    import cv2

    path = Path(path)
    out = path / "classifier"
    if out.is_dir():
        shutil.rmtree(out)
    files = sorted(path.rglob("*.*"))
    for im_file in files:
        if im_file.suffix[1:].lower() not in IMG_FORMATS:
            continue
        im = cv2.imread(str(im_file))
        if im is None:
            continue
        im = im[..., ::-1]
        h, w = im.shape[:2]
        lb_file = Path(img2label_paths([str(im_file)])[0])
        if not lb_file.exists():
            continue
        with open(lb_file) as f:
            lb = np.array([x.split() for x in f.read().strip().splitlines()],
                          dtype=np.float32)
        for j, x in enumerate(lb):
            c = int(x[0])
            f_out = out / f"{c}" / f"{path.stem}_{im_file.stem}_{j}.jpg"
            f_out.parent.mkdir(parents=True, exist_ok=True)
            b = x[1:5] * [w, h, w, h]
            b[2:] = b[2:] * 1.2 + 3  # pad
            xyxy = np.array([b[0] - b[2] / 2, b[1] - b[3] / 2,
                             b[0] + b[2] / 2, b[1] + b[3] / 2]).astype(int)
            xyxy[[0, 2]] = np.clip(xyxy[[0, 2]], 0, w)
            xyxy[[1, 3]] = np.clip(xyxy[[1, 3]], 0, h)
            crop = im[xyxy[1]:xyxy[3], xyxy[0]:xyxy[2]]
            if crop.size == 0:
                raise ValueError(f"box failure in {f_out}")
            cv2.imwrite(str(f_out), crop[..., ::-1])
    return out


def autosplit(path: str | Path = "../coco",
              weights: Tuple[float, float, float] = (0.9, 0.1, 0.0),
              annotated_only: bool = False,
              seed: int | None = None) -> Sequence[Path]:
    """Write `autosplit_{train,val,test}.txt` image lists under `path`
    (reference datasets.py:1587-1609). `seed` pins the split for tests."""
    path = Path(path)
    files = sorted(p for p in path.rglob("*.*")
                   if p.suffix[1:].lower() in IMG_FORMATS)
    rnd = random.Random(seed)
    indices = rnd.choices([0, 1, 2], weights=weights, k=len(files))
    txt = ["autosplit_train.txt", "autosplit_val.txt", "autosplit_test.txt"]
    for t in txt:
        if (path / t).exists():
            (path / t).unlink()
    for i, img in zip(indices, files):
        if annotated_only and not Path(img2label_paths([str(img)])[0]).exists():
            continue
        with open(path / txt[i], "a") as f:
            f.write(str(img) + "\n")
    return [path / t for t in txt]
