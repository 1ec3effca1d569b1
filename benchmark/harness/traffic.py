"""The one traffic generator: frames and training batches from a mix's
parameters (benchmark/traffic/<mix>.json) and the seed. The same seed
gives the same inputs; every seed gives the same amount of work (the same
frame sizes, the same multiset of label counts), in another order."""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

SEED_MASK = (1 << 63) - 1


def _gen(seed: int, salt: int, device="cpu") -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + salt) & SEED_MASK)
    return g


def frame_pool(seed: int, n: int, hw: Tuple[int, int], device="cuda") -> np.ndarray:
    """(n, h, w, 3) uint8 noise frames in host memory, drawn on `device`."""
    h, w = hw
    g = _gen(seed, 1, device)
    x = torch.randint(0, 256, (n, h, w, 3), generator=g, dtype=torch.uint8, device=device)
    return x.cpu().numpy()


def label_counts(total: int, mean: float, sigma: float, cap: int) -> np.ndarray:
    """`total` label counts an image, the same multiset for every seed: the
    quantiles of a log-normal with this mean and log-sd, at least 1, at
    most cap (a heavy tail, as COCO's counts)."""
    from statistics import NormalDist
    mu = math.log(mean) - sigma * sigma / 2
    q = [NormalDist(mu, sigma).inv_cdf((i + 0.5) / total) for i in range(total)]
    return np.clip(np.round(np.exp(q)), 1, cap).astype(np.int64)


def train_batches(seed: int, n: int, batch: int, img: int, nc: int, pad: int,
                  mean: float, sigma: float, device="cuda") -> List[tuple]:
    """`n` batches of (images (B, img, img, 3) uint8, labels (B, pad, 5)
    float32 [cls, x, y, w, h] normalized, mask (B, pad) bool), in host
    memory: noise frames, and the label counts of `label_counts` in a
    seeded order; classes uniform, centres in [0.1, 0.9], sides in
    [0.02, 0.4] of the image."""
    rng = np.random.default_rng([int(seed) & SEED_MASK, 3])
    counts = rng.permutation(label_counts(n * batch, mean, sigma, pad))
    frames = frame_pool(seed, n * batch, (img, img), device=device)
    out = []
    for b in range(n):
        labels = np.zeros((batch, pad, 5), np.float32)
        mask = np.zeros((batch, pad), bool)
        for i in range(batch):
            k = int(counts[b * batch + i])
            labels[i, :k] = np.concatenate([rng.integers(0, nc, (k, 1)),
                                            rng.uniform(0.1, 0.9, (k, 2)),
                                            rng.uniform(0.02, 0.4, (k, 2))], 1)
            mask[i, :k] = True
        out.append((np.ascontiguousarray(frames[b * batch:(b + 1) * batch]), labels, mask))
    return out
