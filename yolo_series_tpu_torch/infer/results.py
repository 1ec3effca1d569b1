"""Rich inference results (counterpart of `yolo_series_tpu/infer/results.py`;
reference common.py:935-1012 Detections): print / save / crop / render
and a pandas export per image. Pure host code."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import cv2
import numpy as np


class Detections:
    """Per-image detections [x1, y1, x2, y2, conf, cls] in original image
    coordinates, beside the images themselves."""

    def __init__(self, imgs: Sequence[np.ndarray], dets: Sequence[np.ndarray],
                 names: Sequence[str] = (), paths: Optional[Sequence[str]] = None,
                 times: Optional[dict] = None):
        self.imgs = list(imgs)
        self.dets = list(dets)
        self.names = list(names)
        self.paths = list(paths) if paths else [f"image{i}" for i in
                                                range(len(imgs))]
        self.times = times or {}
        self.n = len(self.imgs)

    def _name(self, c):
        c = int(c)
        return self.names[c] if c < len(self.names) else str(c)

    def __len__(self):
        return self.n

    def __str__(self):
        lines = []
        for p, d in zip(self.paths, self.dets):
            counts = {}
            for c in d[:, 5].astype(int):
                counts[self._name(c)] = counts.get(self._name(c), 0) + 1
            desc = ", ".join(f"{v} {k}{'s' * (v > 1)}" for k, v in counts.items())
            lines.append(f"{Path(p).name}: {len(d)} detections ({desc or 'none'})")
        if self.times:
            lines.append(" ".join(f"{k}={v:.1f}ms" for k, v in self.times.items()))
        return "\n".join(lines)

    def print(self):
        print(self)

    def pandas(self):
        """Per-image DataFrames [xmin, ymin, xmax, ymax, confidence, class,
        name] (reference common.py:999-1006)."""
        import pandas as pd

        out = []
        for d in self.dets:
            rows = [[*map(float, r[:4]), float(r[4]), int(r[5]),
                     self._name(r[5])] for r in d]
            out.append(pd.DataFrame(
                rows, columns=["xmin", "ymin", "xmax", "ymax", "confidence",
                               "class", "name"]))
        return out

    def render(self):
        """Draw the boxes onto the stored images (in place); returns them."""
        from yolo_series_tpu_torch.infer.detector import draw_detections

        for i in range(self.n):
            draw_detections(self.imgs[i], self.dets[i], self.names)
        return self.imgs

    def save(self, save_dir="runs/detect/exp"):
        save_dir = Path(save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        self.render()
        for p, im in zip(self.paths, self.imgs):
            cv2.imwrite(str(save_dir / Path(p).name), im)
        return save_dir

    def crop(self, save_dir="runs/detect/crops"):
        """Save per-detection crops grouped by class name (reference
        common.py:987-997)."""
        save_dir = Path(save_dir)
        out = []
        for p, im, d in zip(self.paths, self.imgs, self.dets):
            for j, (*xyxy, conf, cls) in enumerate(d):
                x1, y1, x2, y2 = (int(max(v, 0)) for v in xyxy)
                crop = im[y1:y2, x1:x2]
                if crop.size == 0:
                    continue
                cdir = save_dir / self._name(cls)
                cdir.mkdir(parents=True, exist_ok=True)
                fp = cdir / f"{Path(p).stem}_{j}.jpg"
                cv2.imwrite(str(fp), crop)
                out.append(fp)
        return out

    def tolist(self):
        return [Detections([self.imgs[i]], [self.dets[i]], self.names,
                           [self.paths[i]]) for i in range(self.n)]
