#!/usr/bin/env python3
"""Phase 10 (b) of `chip_smoke.py` alone, over several batches: one fp32
step of full-width yolov7 (training form, 640 px, batch 8, the OTA loss,
SGD past warmup) on 2 gloo ranks on one card, against the one-process
step on the whole batch from the same state, and two controls in one
process, the step again and on the batch in reverse image order (the same
function summed in other fp32 orders). For each, the update's relative L2
from the one-process step's, in all, over the layers that reach the head
through no max pool and over the others, and the five layers that hold
most of it (`chip_smoke.update_readings`). One JSON line a batch.

    python3 tools/torch_rank_readings.py [--seeds 5,6,7] [--deterministic]
    python3 tools/torch_rank_readings.py --device cpu --width 0.25 --img 128

--deterministic sets cuDNN's deterministic algorithms in the ranks.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def rank_main(rank, world, init_method, dev_type, width, img, batch, seeds, deterministic):
    if dev_type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cudnn.deterministic = deterministic
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world,
                            timeout=cs.DIST_TIMEOUT)
    dev = torch.device(dev_type)
    return [cs.ranks_step(rank, world, dist.group.WORLD, dev, width, img, batch, s)
            for s in seeds]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=float, default=1.0)
    ap.add_argument("--img", type=int, default=cs.IMG)
    ap.add_argument("--batch", type=int, default=cs.BATCH)
    ap.add_argument("--seeds", default="5,6,7")
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--timeout", type=float, default=900)
    a = ap.parse_args()
    seeds = [int(s) for s in a.seeds.split(",")]
    if a.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("no CUDA device")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip(), flush=True)
    outs = cs.launch(rank_main, cs.PAR_RANKS,
                     args=(a.device, a.width, a.img, a.batch, seeds, a.deterministic),
                     timeout=a.timeout, threads=None if a.device == "cuda" else 2)
    for s, r in zip(seeds, outs[0]):
        print(json.dumps({"seed": s, "deterministic": a.deterministic, **r}), flush=True)


if __name__ == "__main__":
    main()
