#!/usr/bin/env python3
"""Phase 15 (b1) of `chip_smoke.py` read apart: how far the folded fp32
train step (`models/faststem.make_train_fast_stem`) lies from the unfolded
one, and why. One fp32 step (OTA, SGD past warmup) of yolov7's training
form at --width, --img px, batch --batch, from the same state: the
unfolded step, the folded step, and the folded step with two-pass BN
moments in its `TrainPhasedConvA` blocks (the JAX package's one-pass
moments about the running mean replaced: the same function rounded
otherwise), all on --device; on the card also the folded step on the CPU.
For each pair: the update's relative L2 in all and over the layers that
reach the head through no max pool (`chip_smoke.update_readings`), and the
max-pool windows whose maximum is another input, with the largest gap
between the two inputs of such a window (`chip_smoke.pool_routes`). One
JSON line.

    python3 tools/torch_fold_readings.py --device cpu [--threads 4]
    python3 tools/torch_fold_readings.py            # on the card
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from yolo_series_tpu_torch.models import faststem  # noqa: E402
from yolo_series_tpu_torch.models.layers import (BN_EPS, _running, conv2d,  # noqa: E402
                                                 get_activation)


def two_pass_apply(self, params, state, x, ctx):
    """`TrainPhasedConvA.apply` in training with two-pass moments over the
    batch, the phases and the map (no process group)."""
    y = conv2d(x, faststem._phase_w4(params["w"]), None, 2, ((1, 1), (1, 1)), 1, ctx.dtype)
    bnp, bns = params["bn"], state["bn"]
    b_, _, h_, w_ = y.shape
    yf = y.float().reshape(b_, 4, self.c2, h_, w_)
    axes = (0, 1, 3, 4)
    mean = yf.mean(axes)
    var = (yf - mean[:, None, None]).square().mean(axes)
    inv = torch.rsqrt(var + BN_EPS) * bnp["scale"]
    yn = (yf - mean[:, None, None]) * inv[:, None, None] + bnp["bias"][:, None, None]
    _, fn = get_activation(self.act)
    return (fn(yn.reshape(y.shape)).to(y.dtype),
            {"bn": _running(bns, mean, var, b_ * 4 * h_ * w_)})


def step(model, plan, dev, batch_np, two_pass=False):
    """One fp32 step of `plan` on `dev`: (old params, new params, the max
    pools' inputs)."""
    opt = cs.train_optim.OptimConfig()
    lr, mom = cs.lr_after_warmup(opt)
    ts = cs.init_train_state(model.params, model.state, opt, device=dev)
    run = cs.make_train_step(plan, cs.make_compute_loss_ota(plan.head, cs.LossHyp()), opt,
                             compute_dtype=torch.float32)
    real = faststem.TrainPhasedConvA.apply
    if two_pass:
        faststem.TrainPhasedConvA.apply = two_pass_apply
    try:
        with cs.full_fp32(dev.type == "cuda"), cs.recorded_pools() as pools:
            new, _ = run(ts, *batch_np, lr, mom)
    finally:
        faststem.TrainPhasedConvA.apply = real
    return ts.params, new.params, pools


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--img", type=int, default=320)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=5, help="the batch's seed")
    ap.add_argument("--threads", type=int, default=None,
                    help="the CPU's threads (torch's own count unless given)")
    args = ap.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)
    dev = torch.device(args.device)
    model = cs.train_model(torch.device("cpu"), args.width, seed=3)
    folded = cs.make_train_fast_stem(model.plan)
    batch_np = cs.train_batch(np.random.default_rng(args.seed), args.batch, args.img)
    runs = {"unfolded": step(model, model.plan, dev, batch_np),
            "folded": step(model, folded, dev, batch_np),
            "folded_two_pass": step(model, folded, dev, batch_np, two_pass=True)}
    pairs = [("folded", "unfolded"), ("folded_two_pass", "unfolded"),
             ("folded", "folded_two_pass")]
    if dev.type == "cuda":
        runs["folded_cpu"] = step(model, folded, torch.device("cpu"), batch_np)
        pairs.append(("folded", "folded_cpu"))
    out = {"device": str(dev), "card": cs.smi() if dev.type == "cuda" else None,
           "width": args.width, "img": args.img, "batch": args.batch, "seed": args.seed,
           "cpu_threads": torch.get_num_threads()}
    for a, b in pairs:
        (old, new_a, pools_a), (_, new_b, pools_b) = runs[a], runs[b]
        r = cs.update_readings(model.plan, new_a, new_b, old)
        moved, gap = cs.pool_routes(pools_b, pools_a)
        out[f"{a}_vs_{b}"] = {"update_rel_l2": r["rel_l2"],
                              "pool_free_rel_l2": r["pool_free_rel_l2"],
                              "pool_windows_rerouted": moved, "rerouted_gap": gap}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
