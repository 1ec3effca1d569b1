#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch/CUDA port on the card.

    python3 benchmark/run.py --workload yolov7.serve-b8 --seed 7 --seconds 10 --trace 0

The cell's configuration, traffic mix and limits are found by name
(benchmark/configs/<config>.json, benchmark/traffic/<traffic>.json,
benchmark/limits/<workload>.json), each metric's reader too
(benchmark/metrics/<metric>.py). The run sets up (weights drawn from the
seed, the program built and warmed), measures for --seconds, then frees
the program and holds what it served against the plain fp32 reference
(benchmark/reference). --trace 1 profiles a steady part of the window and
reports the per-layer metrics; --trace 0 the end-to-end ones. The last
line of standard output is one JSON object; the numbers compared, each
with its limit, are the last lines of standard error.
"""

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import common  # noqa: E402

common.setup_env()


def process_start() -> float:
    """This process's start, seconds since the epoch (from /proc; the
    module's import time where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(x.split()[1]) for x in f if x.startswith("btime"))
        t = btime + ticks / os.sysconf("SC_CLK_TCK")
        return t if 0 <= T_IMPORT - t < 60 else T_IMPORT
    except (OSError, ValueError, IndexError, StopIteration):
        return T_IMPORT


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


KINDS = {"batch": ("serve", "BatchCell"), "train": ("train", "TrainCell")}


def make_cell(wl, cfg, mix, seed, spans, fault=None, control=False):
    """The cell class of the mix's kind (benchmark/harness/<module>.py)."""
    import importlib
    module, name = KINDS[mix["kind"]]
    cls = getattr(importlib.import_module(f"benchmark.harness.{module}"), name)
    return cls(wl, cfg, mix, seed, spans, fault=fault, control=control)


def main(argv=None, fault=None, control=False):
    """One run; returns the result dict (also printed). fault / control:
    the tests' broken program and the lower-precision control."""
    t_start = process_start()
    a = parse(argv)
    wl, cfg, mix = common.cell(a.workload)
    limits = common.load_json(common.BENCH / "limits" / f"{a.workload}.json")
    import torch
    from benchmark.harness import trace

    common.check_device(wl["chips"])
    common.check_program()
    spans = common.Spans()
    cell = make_cell(wl, cfg, mix, a.seed, spans, fault=fault, control=control)
    cell.setup()
    profile = None
    if a.trace:
        trace.warm_profiler()
        profile = trace.Profile(at=0.3 * a.seconds, length=min(2.0, 0.4 * a.seconds))
    # what set-up made stays out of the window's garbage collections
    gc.collect()
    gc.freeze()
    t_window = cell.window(a.seconds, profile)
    setup_s = (time.time() - time.perf_counter() + t_window) - t_start
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    cell.release()
    readings = cell.check()
    readings.pop("items", None)
    for k, v in readings.items():
        print(f"reading {k}: {v!r}", file=sys.stderr)
    checks = {k: (readings[k], lim) for k, lim in limits.items()}
    correct = all(v <= lim for v, lim in checks.values()) and cell.record.get("failed", 0) == 0

    rec = dict(cell.record, setup_s=setup_s, spans=spans.durations, counters=cell.counters,
               config=cfg, mix=mix, trace=None)
    device = common.device_info(wl["chips"], peak)
    result = {"correct": bool(correct), "attempted": int(rec.get("attempted", 0)),
              "failed": int(rec.get("failed", 0))}
    if a.trace:
        t = trace.read(profile.prof) if profile.prof is not None else {}
        rec["trace"] = t
        print(f"trace: event categories {t.get('categories')}", file=sys.stderr)
    names = common.cell_metrics(a.workload, "per_layer" if a.trace else "end_to_end")
    metrics = {}
    for m in names:
        v = common.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result["metrics"] = metrics
    if a.trace and rec["trace"]:
        device["busy_s"] = rec["trace"]["busy_s"]
        device["window_s"] = rec["trace"]["window_s"]
        result["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                               "idle_gaps": rec["trace"]["idle_gaps"]}
    result["device"] = device
    for line in cell.notes():
        print(line, file=sys.stderr)
    bad = common.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        raise SystemExit(3)
    return common.emit(result, checks)


if __name__ == "__main__":
    main()
