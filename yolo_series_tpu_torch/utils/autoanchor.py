"""Anchor fitness check + k-means/GA anchor evolution (counterpart of
`yolo_series_tpu/utils/autoanchor.py`; reference utils/autoanchor.py:23-160).

Numpy and scipy, as the JAX module. Its random draws (the per-image scale
jitter, scipy's k-means seeds, the genetic mutations) come from the `rng`
the caller passes, a numpy generator, where the JAX module draws from the
global `np.random`: with `np.random.RandomState(s)` here and
`np.random.seed(s)` there, both draw the same numbers and give the same
anchors.
"""

from __future__ import annotations

import numpy as np


def _wh_metric(k, wh, thr):
    """Best-possible-recall helpers: ratio metric per reference
    autoanchor.py:38-44."""
    r = wh[:, None] / k[None]
    x = np.minimum(r, 1.0 / r).min(2)
    best = x.max(1)
    aat = (x > 1.0 / thr).sum(1).mean()
    bpr = (best > 1.0 / thr).mean()
    return bpr, aat, best


def check_anchors(dataset_labels, shapes, anchors_px: np.ndarray,
                  strides, thr=4.0, imgsz=640, rng=None):
    """BPR check; returns (bpr, new_anchors or None). Recomputes anchors by
    evolution when BPR < 0.98 (reference autoanchor.py:23-59). rng: a
    numpy generator (a fresh unseeded one when None)."""
    rng = np.random.default_rng() if rng is None else rng
    shapes_arr = imgsz * shapes / shapes.max(1, keepdims=True)
    scale = rng.uniform(0.9, 1.1, size=(len(shapes_arr), 1))
    wh = np.concatenate([
        (lb[:, 3:5] * s) for s, lb in zip(shapes_arr * scale, dataset_labels)
        if len(lb)])
    bpr, aat, _ = _wh_metric(anchors_px.reshape(-1, 2), wh, thr)
    print(f"autoanchor: BPR={bpr:.4f}, {aat:.2f} anchors>thr")
    if bpr > 0.98:
        return bpr, None
    na = anchors_px.reshape(-1, 2).shape[0]
    new = kmean_anchors(wh, n=na, thr=thr, rng=rng)
    new_bpr, _, _ = _wh_metric(new, wh, thr)
    if new_bpr > bpr:
        print(f"autoanchor: improved BPR {bpr:.4f} -> {new_bpr:.4f}")
        return new_bpr, new
    return bpr, None


def anchor_fitness(k, wh, thr):
    _, _, best = _wh_metric(k, wh, thr)
    return (best * (best > 1.0 / thr)).mean()


def kmean_anchors(wh: np.ndarray, n=9, thr=4.0, gen=1000, verbose=False, rng=None):
    """Whitened k-means seed + genetic evolution on anchor fitness
    (reference autoanchor.py:62-160)."""
    from scipy.cluster.vq import kmeans

    rng = np.random.default_rng() if rng is None else rng
    wh = wh[(wh >= 2.0).any(1)]  # drop tiny boxes (autoanchor.py:102)
    s = wh.std(0)
    k = kmeans(wh / s, n, iter=30, seed=rng)[0] * s
    k = k[np.argsort(k.prod(1))]

    f = anchor_fitness(k, wh, thr)
    sh = k.shape
    mp, sigma = 0.9, 0.1
    for _ in range(gen):
        v = np.ones(sh)
        while (v == 1).all():
            v = ((rng.random(sh) < mp) * rng.random() * rng.standard_normal(sh) * sigma
                 + 1).clip(0.3, 3.0)
        kg = (k * v).clip(min=2.0)
        fg = anchor_fitness(kg, wh, thr)
        if fg > f:
            f, k = fg, kg.copy()
            if verbose:
                print(f"autoanchor: fitness {f:.4f}")
    return k[np.argsort(k.prod(1))]
