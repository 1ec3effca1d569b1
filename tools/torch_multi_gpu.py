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

With `--serving`, instead: serving on a ('data', 'model') grid of the cards
from one process (`infer/serving.ShardedServingEngine` over
`parallel/mesh.make_mesh`), full-width yolov7 deploy, 640 px, bf16, livened
as `chip_smoke.make_model` livens it: data-sharded img/s at batch 8 a card
on 1, 2 and N cards (each row a CUDA-graph engine on its card; the wall
time of SERVE_ITERS `infer_async` calls between synchronises of every
card), and the tensor-parallel p50 of `infer` at batch 8 on 1 x 2 and
1 x N grids beside one card's graph engine and one card's eager engine.

    python3 tools/torch_multi_gpu.py [--cards 4] [--serving]
    python3 tools/torch_multi_gpu.py --device cpu --cards 4 --width 0.25 --img 128 --batch 2

The second form rehearses the training runs on the CPU with gloo ranks at a
small size (with `--serving`, the grids over the CPU).
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
SERVE_ITERS = 20


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


def _sync_all(devices):
    for d in {str(d) for d in devices}:
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


def serving_grids(device, cards, width, img, batch):
    """The `--serving` runs (module docstring): {"data": {n: img/s},
    "tensor": {grid: p50 ms}, "one_card": {...}}."""
    from yolo_series_tpu_torch.infer.serving import ServingEngine, ShardedServingEngine
    from yolo_series_tpu_torch.parallel.mesh import make_mesh

    devs = ([torch.device("cuda", i) for i in range(cards)] if device == "cuda"
            else [torch.device("cpu")] * cards)
    m = cs.make_model(devs[0], width, img)
    rng = np.random.default_rng(0)
    out = {"data": {}, "tensor": {}, "one_card": {}}

    def wall_img_s(eng, frames):
        for _ in range(3):
            eng.infer_async(frames)
        _sync_all(devs)
        t = time.perf_counter()
        for _ in range(SERVE_ITERS):
            eng.infer_async(frames)
        _sync_all(devs)
        return SERVE_ITERS * frames.shape[0] / (time.perf_counter() - t)

    def p50(eng, frames):
        eng.infer(frames)
        lat = []
        for _ in range(SERVE_ITERS):
            t = time.perf_counter()
            eng.infer(frames)
            lat.append((time.perf_counter() - t) * 1e3)
        return float(np.median(lat))

    for n in sorted({1, 2, cards}):
        frames = rng.integers(0, 256, (batch * n, img, img, 3), np.uint8)
        eng = ShardedServingEngine(m.plan, m.params, m.state, make_mesh(n, 1, devs),
                                   batch_size=batch * n, img_size=img, dtype=torch.bfloat16)
        out["data"][n] = {"img_s": wall_img_s(eng, frames), "p50_ms": p50(eng, frames)}
        cs.log(f"serving: data grid {n} x 1, batch {batch} a card: {out['data'][n]}")
        del eng
    frames = rng.integers(0, 256, (batch, img, img, 3), np.uint8)
    one = ServingEngine(m.plan, m.params, m.state, batch_size=batch, img_size=img,
                        dtype=torch.bfloat16, device=devs[0])
    out["one_card"]["graph"] = {"p50_ms": p50(one, frames), "img_s": wall_img_s(one, frames)}
    del one
    for n in sorted({1, 2, cards} - {1}) + [1]:
        eng = ShardedServingEngine(m.plan, m.params, m.state,
                                   make_mesh(1, n, devs if n > 1 else devs[:1] * 2),
                                   batch_size=batch, img_size=img, dtype=torch.bfloat16)
        key = f"1x{n}" if n > 1 else "1x2 on one card"
        out["tensor"][key] = {"p50_ms": p50(eng, frames), "img_s": wall_img_s(eng, frames)}
        cs.log(f"serving: tensor-parallel grid {key}, batch {batch}: {out['tensor'][key]}")
        del eng
    cs.log(f"serving: one card's graph engine at batch {batch}: {out['one_card']['graph']}")
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cards", type=int, default=4)
    p.add_argument("--device", default="cuda")
    p.add_argument("--width", type=float, default=1.0)
    p.add_argument("--img", type=int, default=cs.IMG)
    p.add_argument("--batch", type=int, default=cs.BATCH)
    p.add_argument("--log", type=Path, default=ROOT / "build" / "multi_gpu_train.log")
    p.add_argument("--serving", action="store_true",
                   help="serving on a grid of the cards instead of the training runs")
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
    out = {"cards": a.cards, "device": a.device, "card": card, "topo": topo}
    if a.serving:
        out["serving"] = serving_grids(a.device, a.cards, a.width, a.img, a.batch)
    else:
        out["step_scaling"] = step_scaling(a.device, a.cards, a.width, a.img, a.batch)
        out["train_cli"] = train_cli(a.device, a.cards, a.width, a.img, a.batch, a.log)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
