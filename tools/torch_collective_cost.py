#!/usr/bin/env python3
"""Host cost of one small `torch.distributed` all-reduce on the card, the
collective SyncBN makes at every BatchNorm layer of the data-parallel
train step (two floats a channel): a one-rank NCCL group, CALLS calls of a
(2, C) fp32 all-reduce back to back, host microseconds a call (the card
idles: the calls are host-bound), for each environment given as an
argument (`NAME=VALUE[,NAME=VALUE...]`, or `default`), each in a fresh
process, since NCCL reads its environment when the group starts. Then
the host time of one call issued behind ~40 ms of queued matmuls: a call
that waits for the card there serializes the host-paced step with the
card's work.

    python3 tools/torch_collective_cost.py default TORCH_FR_BUFFER_SIZE=0

Prints the card's name and power limit and one JSON line a variant.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CALLS, CHANNELS = 2000, 256
# 4096^3 fp32 matmuls queued ahead of one call (~2 ms each on an H100)
BUSY_MATMULS = 20


def measure():
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from yolo_series_tpu_torch.parallel.dist import free_port, init_distributed

    group = init_distributed(0, 1, f"tcp://localhost:{free_port()}", "cuda")
    t = torch.ones(2, CHANNELS, device="cuda")
    out = {}
    for name, fn in (("all_reduce", lambda: dist.all_reduce(t, group=group)),
                     ("stack_all_reduce_div", lambda: _pmean_like(t, group))):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(CALLS):
            fn()
        host = time.perf_counter() - start
        torch.cuda.synchronize()
        out[name] = {"host_us_a_call": host / CALLS * 1e6,
                     "wall_us_a_call": (time.perf_counter() - start) / CALLS * 1e6}
    # behind queued work: does a call wait for the card? The host time of
    # one call issued right after BUSY_MATMULS matmuls are enqueued
    a = torch.randn(4096, 4096, device="cuda")
    for name, fn in (("none", lambda: None),
                     ("all_reduce", lambda: dist.all_reduce(t, group=group)),
                     ("stack_all_reduce_div", lambda: _pmean_like(t, group))):
        hosts = []
        for _ in range(5):
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(BUSY_MATMULS):
                a @ a
            queued = time.perf_counter()
            fn()
            hosts.append((time.perf_counter() - queued) * 1e6)
            torch.cuda.synchronize()
            busy = (time.perf_counter() - start) * 1e3
        out[f"behind_busy_{name}"] = {"host_us_a_call": sorted(hosts)[2], "busy_ms": busy}
    dist.destroy_process_group()
    return out


def _pmean_like(t, group):
    """What `models/layers._pmean` does around the all-reduce."""
    import torch
    import torch.distributed as dist

    s = torch.stack([t[0], t[1]])
    dist.all_reduce(s, group=group)
    return s / dist.get_world_size(group)


def main():
    if sys.argv[1:2] == ["--measure"]:
        print(json.dumps(measure()))
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for variant in sys.argv[1:] or ["default"]:
        env = dict(os.environ)
        if variant != "default":
            env.update(kv.split("=", 1) for kv in variant.split(","))
        res = subprocess.run([sys.executable, __file__, "--measure"], env=env,
                             capture_output=True, text=True, timeout=600)
        if res.returncode:
            raise SystemExit(f"{variant}: exit {res.returncode}\n{res.stderr[-3000:]}")
        print(json.dumps({"variant": variant, **json.loads(res.stdout.strip().splitlines()[-1])}),
              flush=True)


if __name__ == "__main__":
    main()
