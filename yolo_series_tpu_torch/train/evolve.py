"""Hyperparameter evolution, the GA loop (counterpart of
`yolo_series_tpu/train/evolve.py`; reference train.py:630-716).

Mutates the hyp meta-table's keys with per-key gains and bounds, picks the
parent from the top-5 earlier results (one weighted draw, or their
fitness-weighted combination), trains each candidate, and appends
[P, R, mAP@.5, mAP@.5:.95, hyp values...] rows to evolve.txt.

`mutate` draws from the generators it is given, a `random.Random` and a
numpy `RandomState`, where the JAX module draws from the global `random`
and `np.random`: the same calls in the same order, so generators seeded as
the JAX package's globals give the same hyp. `evolve` seeds them with
`TrainConfig.seed`. On several devices each generation's training is
`train`'s multi-process run; under an already joined group (torchrun)
every rank mutates alike and rank 0 alone writes the files.
`obs/plots.plot_evolution` draws evolve.txt's scatter panels.
"""

from __future__ import annotations

import dataclasses
import random
from pathlib import Path
from typing import Dict

import numpy as np
import torch.distributed as dist
import yaml

from yolo_series_tpu_torch.eval.metrics import fitness
from yolo_series_tpu_torch.parallel.dist import rank_of, sync_processes

# (mutation gain, min, max) per key (reference train.py:636-666)
EVOLVE_META = {
    "lr0": (1, 1e-5, 1e-1), "lrf": (1, 0.01, 1.0), "momentum": (0.3, 0.6, 0.98),
    "weight_decay": (1, 0.0, 0.001), "warmup_epochs": (1, 0.0, 5.0),
    "warmup_momentum": (1, 0.0, 0.95), "warmup_bias_lr": (1, 0.0, 0.2),
    "box": (1, 0.02, 0.2), "cls": (1, 0.2, 4.0), "cls_pw": (1, 0.5, 2.0),
    "obj": (1, 0.2, 4.0), "obj_pw": (1, 0.5, 2.0), "iou_t": (0, 0.1, 0.7),
    "anchor_t": (1, 2.0, 8.0), "fl_gamma": (0, 0.0, 2.0),
    "hsv_h": (1, 0.0, 0.1), "hsv_s": (1, 0.0, 0.9), "hsv_v": (1, 0.0, 0.9),
    "degrees": (1, 0.0, 45.0), "translate": (1, 0.0, 0.9),
    "scale": (1, 0.0, 0.9), "shear": (1, 0.0, 10.0),
    "perspective": (0, 0.0, 0.001), "flipud": (1, 0.0, 1.0),
    "fliplr": (0, 0.0, 1.0), "mosaic": (1, 0.0, 1.0), "mixup": (1, 0.0, 1.0),
    "copy_paste": (1, 0.0, 1.0), "paste_in": (1, 0.0, 1.0),
}


def mutate(hyp: Dict[str, float], evolve_txt: Path, rng: random.Random,
           np_rng: np.random.RandomState) -> Dict[str, float]:
    """One GA mutation step (reference train.py:668-693): with no
    evolve.txt yet, `hyp` clipped to the bounds."""
    hyp = dict(hyp)
    if evolve_txt.exists():
        x = np.loadtxt(evolve_txt, ndmin=2)
        n = min(5, len(x))
        x = x[np.argsort(-fitness(x))][:n]
        w = fitness(x) - fitness(x).min()
        method = rng.choice(["single", "weighted"])
        if method == "single" or len(x) == 1:
            sel = x[rng.choices(range(n), weights=w + 1e-9)[0]]
        else:
            sel = (x * (w + 1e-9).reshape(-1, 1)).sum(0) / (w.sum() + 1e-9)
        keys = list(EVOLVE_META)
        mp, s = 0.8, 0.2  # mutation probability and sigma (train.py:678)
        g = np.array([EVOLVE_META[k][0] for k in keys])
        ng = len(keys)
        v = np.ones(ng)
        while (v == 1).all():
            v = (g * (np_rng.random_sample(ng) < mp) * np_rng.randn(ng)
                 * np_rng.random_sample() * s + 1).clip(0.3, 3.0)
        for i, k in enumerate(keys):
            if k in hyp:
                hyp[k] = float(sel[i + 4] * v[i])  # the first 4 columns are metrics
    for k, (_, lo, hi) in EVOLVE_META.items():
        if k in hyp:
            hyp[k] = float(np.clip(round(hyp[k], 5), lo, hi))
    return hyp


def append_result(evolve_txt: Path, results4, hyp: Dict[str, float]):
    """One evolve.txt row: the 4 metrics, then every meta key's hyp value."""
    row = list(results4) + [hyp.get(k, 0.0) for k in EVOLVE_META]
    with open(evolve_txt, "a") as f:
        f.write(" ".join(f"{v:.5g}" for v in row) + "\n")


def evolve(tc, generations: int = 300):
    """The evolution loop around `trainer.train` (a short run a
    generation); returns (best fitness, its hyp). Writes evolve.txt and
    hyp_evolved.yaml (the best hyp so far) under `tc.save_dir`, each
    generation's run under gen{NNN}/."""
    from yolo_series_tpu_torch.train.trainer import load_hyp, train

    group = dist.group.WORLD if dist.is_initialized() else None
    main = rank_of(group) == 0
    rng, np_rng = random.Random(tc.seed), np.random.RandomState(tc.seed)
    base_hyp = load_hyp(tc.hyp)
    save_root = Path(tc.save_dir)
    save_root.mkdir(parents=True, exist_ok=True)
    evolve_txt = save_root / "evolve.txt"

    best = None
    for gen in range(generations):
        hyp = mutate(base_hyp, evolve_txt, rng, np_rng)
        tc_g = dataclasses.replace(tc, hyp=hyp, save_dir=str(save_root / f"gen{gen:03d}"),
                                   save_period=-1)
        rows = train(tc_g)["results"]
        last = rows[-1] if rows else {}
        results4 = [last.get("val/mp", 0.0), last.get("val/mr", 0.0),
                    last.get("val/map50", 0.0), last.get("val/map", 0.0)]
        fi = fitness(np.array([results4 + [0, 0, 0]]))[0]
        improved = best is None or fi > best[0]
        if improved:
            best = (fi, hyp)
        if main:
            append_result(evolve_txt, results4, hyp)
            if improved:
                with open(save_root / "hyp_evolved.yaml", "w") as f:
                    yaml.dump(hyp, f)
            print(f"evolve gen {gen}: fitness={fi:.5f} best={best[0]:.5f}")
        sync_processes("evolve.txt", group)   # every rank mutates from this row on
    return best
