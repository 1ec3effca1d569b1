#!/usr/bin/env python3
"""Training of the PyTorch port on several NVIDIA GPUs of one host, one
process a card (NCCL): the runs that `chip_smoke.py`, which needs one card,
cannot make.

 1. Step scaling: the bare bf16 train step of full-width yolov7 (training
    form, 640 px, batch 8 a card, the OTA loss, SGD past warmup; phase 7 of
    `chip_smoke.py`) on 1 card (no group: the one-card path), then 2 and N
    ranks (`make_train_step(mesh=group)`), with SyncBN and per-replica BN
    (`bn_shards`, `--no-sync-bn`); img/s from the wall time of STEPS steps
    between two barriers after 2 warm-up steps, and the scaling efficiency
    against 1 card.
 2. The train CLI, `python -m yolo_series_tpu_torch.cli.train --devices N`,
    on phase 8's set (64 + 16 noise JPEGs, its settled and livened start,
    written by `chip_smoke.smoke_set`), 2 epochs, global batch 8 a card,
    nbs 64, the default hyp, per-epoch validation on rank 0: its rows (img/s
    an epoch) and the run directory.

    python3 tools/torch_multi_gpu.py [--cards 4]
    python3 tools/torch_multi_gpu.py --device cpu --cards 4 --width 0.25 --img 128 --batch 2

The second form rehearses both on the CPU with gloo ranks at a small size.
Prints the card's name and power limit, `nvidia-smi topo -m`, and one JSON
line last; the CLI's output goes to `--log` (build/multi_gpu_train.log).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from yolo_series_tpu_torch.losses import LossHyp, make_compute_loss_ota  # noqa: E402
from yolo_series_tpu_torch.ops import _build  # noqa: E402
from yolo_series_tpu_torch.parallel.dist import (init_distributed, launch,  # noqa: E402
                                                 sync_processes)
from yolo_series_tpu_torch.train.optim import OptimConfig  # noqa: E402
from yolo_series_tpu_torch.train.step import init_train_state, make_train_step  # noqa: E402

STEPS = 10


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def step_rank(rank, world, init_method, device, width, img, batch, sync_bn):
    """One rank of the step scaling: STEPS steps on its own batch of
    `batch` images; (seconds, the last step's total loss)."""
    group = None
    if world > 1:
        group = init_distributed(rank, world, init_method, device)
    elif device == "cuda":
        torch.cuda.set_device(0)
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" \
        else torch.device("cpu")
    model = cs.train_model(dev, width)
    opt = OptimConfig()
    lr, mom = cs.lr_after_warmup(opt)
    batch_np = cs.train_batch(np.random.default_rng(7 + rank), batch, img)
    ts = init_train_state(model.params, model.state, opt, device=dev)
    step = make_train_step(model.plan, make_compute_loss_ota(model.plan.head, LossHyp()),
                           opt, mesh=group, bn_shards=1 if sync_bn else world)
    for _ in range(2):
        ts, _ = step(ts, *batch_np, lr, mom)
    _sync(dev)
    sync_processes("timed steps", group)
    t = time.perf_counter()
    for _ in range(STEPS):
        ts, metrics = step(ts, *batch_np, lr, mom)
    _sync(dev)
    sync_processes("timed steps end", group)
    return time.perf_counter() - t, float(metrics["total"])


def step_scaling(device, cards, width, img, batch):
    out = {}
    runs = [(1, True)] + [(n, sync) for n in sorted({2, cards}) for sync in (True, False)]
    for n, sync_bn in runs:
        secs, loss = launch(step_rank, n, args=(device, width, img, batch, sync_bn),
                            timeout=900, threads=None if device == "cuda" else 2)[0]
        key = f"{n}" if n == 1 else f"{n}_{'sync_bn' if sync_bn else 'no_sync_bn'}"
        out[key] = {"img_s": n * batch * STEPS / secs, "ms_step": secs * 1e3 / STEPS,
                    "loss": loss}
        out[key]["efficiency"] = out[key]["img_s"] / (n * out["1"]["img_s"])
        cs.log(f"step scaling: {key}, batch {batch} a rank: {out[key]}")
    return out


def train_cli(device, cards, width, img, batch, log):
    dev = torch.device(device)
    data, cfg, start = cs.smoke_set(dev, width, img, batch)
    project = cs.SMOKE_RUNS / "multi"
    argv = [sys.executable, "-m", "yolo_series_tpu_torch.cli.train", "--cfg", str(cfg),
            "--data", data, "--weights", str(start), "--epochs", "2",
            "--batch-size", str(batch * cards), "--nbs", "64", "--img-size", str(img),
            "--workers", str(cs.CLI_WORKERS), "--project", str(project), "--name", "exp",
            "--devices", str(cards)] + (["--device", "cpu"] if device == "cpu" else [])
    log.parent.mkdir(parents=True, exist_ok=True)
    t = time.perf_counter()
    with open(log, "w") as f:
        res = subprocess.run(argv, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT, timeout=1200)
    secs = time.perf_counter() - t
    if res.returncode:
        print(log.read_text()[-4000:])
        raise SystemExit(f"the train CLI exited with {res.returncode}")
    rows = [json.loads(line) for line in
            (project / "exp" / "results.jsonl").read_text().strip().splitlines()]
    weights = sorted(p.name for p in (project / "exp" / "weights").iterdir())
    images = cs.TRAIN_IMAGES // (batch * cards) * batch * cards   # an epoch, drop_last
    img_s = [images / r["time_s"] for r in rows]
    cs.log(f"train CLI on {cards} ranks, global batch {batch * cards}, nbs 64: {secs:.1f} s, "
           f"img/s an epoch {img_s}, weights {weights}, rows {rows}")
    return {"seconds": secs, "img_s": img_s, "rows": rows, "weights": weights}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cards", type=int, default=4)
    p.add_argument("--device", default="cuda")
    p.add_argument("--width", type=float, default=1.0)
    p.add_argument("--img", type=int, default=cs.IMG)
    p.add_argument("--batch", type=int, default=cs.BATCH)
    p.add_argument("--log", type=Path, default=ROOT / "build" / "multi_gpu_train.log")
    a = p.parse_args()
    if a.device == "cuda":
        if torch.cuda.device_count() < a.cards:
            raise SystemExit(f"{a.cards} cards asked for, {torch.cuda.device_count()} visible")
        card = cs.smi()
        topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True,
                              timeout=60).stdout
        cs.log(f"cards: {torch.cuda.device_count()} x {card}\n{topo}")
        cs.log(f"build: {_build.build():.1f} s")
    else:
        card, topo = "none (CPU rehearsal)", None
    out = {"cards": a.cards, "device": a.device, "card": card, "topo": topo,
           "step_scaling": step_scaling(a.device, a.cards, a.width, a.img, a.batch),
           "train_cli": train_cli(a.device, a.cards, a.width, a.img, a.batch, a.log)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
