#!/usr/bin/env python3
"""K2 (the fused stem) and K3 (the eight fused ELAN spans) of several
checkouts of the PyTorch port, timed on one card in one run, two ways: one
call between two CUDA events, and the replay of a CUDA graph of the call
(device time without the host's launch cost). Batch 8, 640 px, full-width
yolov7 deploy shapes, random bf16 tensors from fixed seeds.

    python3 tools/ab_torch_fused.py OLD NEW NEW OLD

Each argument is the root of a checkout. Each runs in a process of its own
that imports that checkout's `yolo_series_tpu_torch` and builds its kernels
into that checkout's build directory. Prints one JSON line a run, then the
card's name and power limit. Needs an NVIDIA Hopper GPU and nvcc.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

BATCH, IMG = 8, 640
# (H at 640 px, cin, ct, cc, cout, order) of the 8 ELAN spans, plan order
SPANS = ((160, 128, 64, 64, 256, "backbone"), (80, 256, 128, 128, 512, "backbone"),
         (40, 512, 256, 256, 1024, "backbone"), (20, 1024, 256, 256, 1024, "backbone"),
         (40, 512, 256, 128, 256, "head"), (80, 256, 128, 64, 128, "head"),
         (40, 512, 256, 128, 256, "head"), (20, 1024, 512, 256, 512, "head"))


def one_run(root: str) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    import yolo_series_tpu_torch
    from yolo_series_tpu_torch.ops import conv_silu, fused_elan, fused_stem

    dev = torch.device("cuda")

    def event_ms(fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def graph_ms(fn, reps=5, iters=10):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        return event_ms(graph.replay, iters=iters, warmup=1) / reps

    def rand(gen, shape, std):
        return (torch.randn(shape, generator=gen) * std).to(dev, torch.bfloat16)

    def conv_w(gen, kh, kw, cin, cout):
        return rand(gen, (kh, kw, cin, cout), 1.0 / math.sqrt(kh * kw * cin))

    def timed(fn):
        real, n = conv_silu.launch, [0]

        def counted(*args, **kwargs):   # the conv launches of one call
            n[0] += 1
            real(*args, **kwargs)

        conv_silu.launch = counted
        fn()
        conv_silu.launch = real
        torch.cuda.synchronize()
        return {"ms": event_ms(fn), "graph_ms": graph_ms(fn), "conv_launches": n[0]}

    gen = torch.Generator().manual_seed(2)
    p = {"wk2": conv_w(gen, 2, 2, 128, 64), "b1": rand(gen, (64,), 0.1),
         "ws2": conv_w(gen, 3, 3, 64, 64), "b2": rand(gen, (64,), 0.1),
         "ws3": conv_w(gen, 3, 3, 64, 128), "b3": rand(gen, (128,), 0.1)}
    x = rand(gen, (BATCH, IMG // 2 + 2 * fused_stem._PAD, IMG // 2, 128), 1.0)
    out = {"root": root, "package": yolo_series_tpu_torch.__file__,
           "K2": timed(lambda: fused_stem.fused_stem(x, p))}
    del x

    gen = torch.Generator().manual_seed(3)
    k3 = {"ms": 0.0, "graph_ms": 0.0, "conv_launches": 0}
    for h, cin, ct, cc, cout, order in SPANS:
        _, cat = fused_elan.concat_slots(order, ct, cc)
        p = {"w4": conv_w(gen, 1, 1, cin, ct), "b4": rand(gen, (ct,), 0.1),
             "w5": conv_w(gen, 1, 1, cin, ct), "b5": rand(gen, (ct,), 0.1),
             "wc0": conv_w(gen, 3, 3, ct, cc), "bc0": rand(gen, (cc,), 0.1),
             "wc": torch.stack([conv_w(gen, 3, 3, cc, cc) for _ in range(3)]),
             "bc": rand(gen, (3, cc), 0.1),
             "w11": conv_w(gen, 1, 1, cat, cout), "b11": rand(gen, (cout,), 0.1)}
        if hasattr(fused_elan, "merge_x45"):   # checkouts that launch x4, x5 as one
            p = fused_elan.merge_x45(p)
        x = rand(gen, (BATCH, h, h, cin), 1.0)
        span = timed(lambda: fused_elan.fused_elan(x, p, order))
        for key in k3:
            k3[key] += span[key]
    out["K3"] = k3
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--run":
        print(json.dumps(one_run(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv:
        res = subprocess.run([sys.executable, __file__, "--run", root],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
