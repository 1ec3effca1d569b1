#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card, at the
cell's own size, each held against the fp32 reference: for each seed and
side, one JSON line. Sides: "program" (a serving cell's answers over its
whole frame pool, the answers its window serves; a training cell's checked
steps), "control" (the lower-precision control: the program's int8 path
for serving, the reference with fp8 convs for training), "bf16ref" (a
training cell's reference with bf16 convs, a reading beside the
program's), and the faults of the tests ("alter", "half", "stale", "lr",
"momentum"). The per-item gaps of the serving cells are saved to --out
(npz) for study.

    python3 benchmark/readings.py --workload yolov7.serve-b8 --seeds 11,12,13 \\
        --sides program,control [--out readings.npz]
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import common  # noqa: E402

common.setup_env()


def readings(workload: str, seed: int, side: str):
    """One side's gaps, with the same set-up as a run."""
    import torch
    from benchmark.run import make_cell
    wl, cfg, mix = common.cell(workload)
    fault = side if side in ("alter", "half", "stale", "lr", "momentum") else None
    control = {"control": True, "bf16ref": "bf16ref"}.get(side, False)
    cell = make_cell(wl, cfg, mix, seed, common.Spans(), fault=fault, control=control)
    cell.setup()
    if mix["kind"] == "batch":
        for j in range(cell.n_batches):
            host, _ = cell._fetch(cell._dispatch(j))
            for k in range(cell.batch):
                cell.keep(j * cell.batch + k, host, k)
    torch.cuda.synchronize()
    cell.release()
    return cell.check(), cell


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sides", default="program")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    import numpy as np
    common.check_device(1)
    saved = {}
    for seed in [int(s) for s in a.seeds.split(",")]:
        for side in a.sides.split(","):
            t = time.time()
            r, _ = readings(a.workload, seed, side)
            items = r.pop("items", {})
            for k, v in items.items():
                saved[f"{side}_{seed}_{k}"] = v
            print(json.dumps({"workload": a.workload, "seed": seed, "side": side,
                              "s": round(time.time() - t, 1), **r}), flush=True)
    if a.out:
        np.savez_compressed(a.out, **saved)


if __name__ == "__main__":
    main()
