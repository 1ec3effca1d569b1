#!/usr/bin/env python3
"""The kernels of several checkouts of the PyTorch port, timed on one card
in one run: K1 (the NMS keep-mask, batch 8, K = 1024), K1L (the large-K
keep-mask, batch 8, K = 4096 and 8192, with its mask and scan kernels'
device times from the profiler), K2 (the fused stem),
K3 (the eight fused ELAN spans), K4 (the int8 matmul with dequant at the 41
quantized 1x1 convs of one forward) and K4b (its bench template at the
bench's three shapes, beside `torch._int_mm`). K1, K1L, K2 and K3 two ways: one
call between two CUDA events, and the replay of a CUDA graph of the call
(device time without the host's launch cost); K4 and K4b by graph replay.
Batch 8, 640 px, full-width yolov7 deploy shapes, random tensors from fixed
seeds, the same for every checkout.

    python3 tools/ab_torch_fused.py OLD NEW NEW OLD
    python3 tools/ab_torch_fused.py --k4-tiles
    python3 tools/ab_torch_fused.py --k1l-variants

Each argument is the root of a checkout. Each runs in a process of its own
that imports that checkout's `yolo_series_tpu_torch` and builds its kernels
into that checkout's build directory. Prints one JSON line a run (K4 with
each conv's ms and, where the checkout reports it, its tile), then the
card's name and power limit. `--k4-tiles` times this checkout's K4 at each
of the 41 shapes on every tile the kernel takes, one JSON line a shape.
`--k1l-variants` times K1L of this checkout beside copies of it whose
`csrc/nms_keep.cu` is changed in one place each (K1L_VARIANTS: the scan's
block resolve by `__ffsll` steps, always or where at most 16 boxes are
left, the mask kernel without its overlap pre-filter), on the chains and on the
model's eval candidates (chip_smoke.eval_candidates, random weights) at
K = 4096 and 8192, B = 8, in the order A B C D D C B A; one JSON line a
run. The copies go under build/k1l_variants/.
Needs an NVIDIA Hopper GPU and nvcc.
"""

from __future__ import annotations

import json
import math
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
INPUTS = ROOT / "build" / "ab_torch_inputs.npz"

BATCH, IMG = 8, 640
K1L_SIZES = (4096, 8192)
# K1L's block resolve with a `__ffsll` loop (a shared-memory load a kept
# box) wherever at most {n} boxes are left, before its 64 unrolled steps
_RESOLVE = "__device__ __forceinline__ uint64_t resolve(uint64_t removed, const uint64_t* diag) {\n"
_FFS = """  if (__popcll(~removed) <= {n}) {{
    uint64_t live = ~removed;
    while (live) {{
      const int t = __ffsll(static_cast<long long>(live)) - 1;
      removed |= diag[t];
      live = ~removed & (~1ull << t);
    }}
    return removed;
  }}
"""
# this checkout's csrc/nms_keep.cu with one change each: (old, new) text
K1L_VARIANTS = {
    "this": (),
    "ffs_resolve": ((_RESOLVE, _RESOLVE + _FFS.format(n=64)),),
    "hybrid_resolve": ((_RESOLVE, _RESOLVE + _FFS.format(n=16)),),
    "no_prefilter": (("  if (th.thr >= 0.0f) {\n    uint32_t half[2]",
                      "  if (false) {\n    uint32_t half[2]"),),
}
# K4b's bench shapes (tools/bench_int8_pallas.py), as chip_smoke.K4B_SHAPES
K4B_SHAPES = ((12800, 1024, 512), (3200, 2048, 1024), (8192, 1024, 1024))
# (H at 640 px, cin, ct, cc, cout, order) of the 8 ELAN spans, plan order
SPANS = ((160, 128, 64, 64, 256, "backbone"), (80, 256, 128, 128, 512, "backbone"),
         (40, 512, 256, 256, 1024, "backbone"), (20, 1024, 256, 256, 1024, "backbone"),
         (40, 512, 256, 128, 256, "head"), (80, 256, 128, 64, 128, "head"),
         (40, 512, 256, 128, 256, "head"), (20, 1024, 512, 256, 512, "head"))


def make_inputs() -> None:
    """K1's and K1L's boxes and valid rows and K4's shapes, made by this
    checkout's `chip_smoke.py` (as its K1, K1L and K4 checks make them) for
    every run."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from yolo_series_tpu_torch.models import graph

    rng = np.random.default_rng(0)
    k = 1024
    boxes = chip_smoke.chain_boxes(rng, BATCH, k)
    n_valid = rng.integers(k // 2, k + 1, BATCH)
    n_valid[0] = k
    plan = graph.compile_graph(chip_smoke._cfg(1.0))
    large = {}
    for kl in K1L_SIZES:
        large[f"k1l_boxes_{kl}"] = chip_smoke.chain_boxes(rng, BATCH, kl)
        n = rng.integers(kl // 2, kl + 1, BATCH)
        n[0] = kl
        large[f"k1l_valid_{kl}"] = np.arange(kl)[None] < n[:, None]
    INPUTS.parent.mkdir(parents=True, exist_ok=True)
    np.savez(INPUTS, k1_boxes=boxes, k1_valid=np.arange(k)[None] < n_valid[:, None],
             k4_shapes=np.array(chip_smoke.k4_shapes(plan, BATCH, IMG)), **large)


def make_eval_candidates() -> dict:
    """K1L's inputs on eval's path: the fp32 forward of the full-width
    model (chip_smoke.make_model, random weights made to detect) on B
    random 640 px images, then eval's multi-label candidates cut to K =
    4096 and 8192 (chip_smoke.eval_candidates, IoU 0.65), as numpy."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import torch

    m = chip_smoke.make_model(torch.device("cuda"))
    images = np.random.default_rng(7).integers(0, 256, (BATCH, IMG, IMG, 3), np.uint8)
    out = {}
    for kl in K1L_SIZES:
        boxes, valid = chip_smoke.eval_candidates(m, images, max_nms=kl)
        out[f"eval_boxes_{kl}"] = boxes.cpu().numpy()
        out[f"eval_valid_{kl}"] = valid.cpu().numpy()
    del m
    torch.cuda.empty_cache()
    return out


def event_ms(fn, iters=20, warmup=3):
    import torch

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
    import torch

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


def kernel_split(fn, n=3):
    """Device ms of one fn() call in K1L's mask and scan kernels (by name,
    torch.profiler over n calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {"mask_ms": 0.0, "scan_ms": 0.0}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
        for key, name in (("mask_ms", "nms_mask_kernel"), ("scan_ms", "nms_scan_kernel")):
            if name in e.key:
                out[key] += us / 1e3 / n
    return out


def k4_operands(m, k, n, dev):
    import torch

    gen = torch.Generator().manual_seed(m * 7 + k * 3 + n)
    xq = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8).to(dev)
    wq = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8).to(dev).t()
    scale = (torch.rand(n, generator=gen) * 1e-2 + 1e-4).to(dev)
    bias = torch.randn(n, generator=gen).to(dev)
    return xq, wq, scale, bias


def k1_k4(inputs, dev) -> dict:
    """K1 and K1L (one call and graph replay; K1L checked against the plain
    keep-mask first), K4 per conv and summed, K4b per shape beside
    torch._int_mm."""
    import torch

    from yolo_series_tpu_torch.ops import int8_mm, nms_keep

    boxes = torch.from_numpy(inputs["k1_boxes"]).to(dev)
    valid = torch.from_numpy(inputs["k1_valid"]).to(dev)
    k1 = lambda: nms_keep.nms_keep_mask(boxes, valid, 0.45)  # noqa: E731
    out = {"K1": {"ms": event_ms(k1), "graph_ms": graph_ms(k1)}}
    for kl in K1L_SIZES:
        lb = torch.from_numpy(inputs[f"k1l_boxes_{kl}"]).to(dev)
        lv = torch.from_numpy(inputs[f"k1l_valid_{kl}"]).to(dev)
        k1l = lambda: nms_keep.nms_keep_mask_large(lb, lv, 0.45)  # noqa: E731
        got = k1l()
        torch.cuda.synchronize()
        if not torch.equal(got, nms_keep.nms_keep_mask_plain(lb, lv, 0.45)):
            raise AssertionError(f"K1L K={kl}: differs from the plain keep-mask")
        out[f"K1L_{kl}"] = {"ms": event_ms(k1l, iters=10), "graph_ms": graph_ms(k1l, reps=3),
                            **kernel_split(k1l)}
        del lb, lv, got
    convs = []
    for m, k, n in inputs["k4_shapes"].tolist():
        xq, wq, scale, bias = k4_operands(m, k, n, dev)
        ms = graph_ms(lambda: int8_mm.int8_matmul_dequant(xq, wq, scale, bias))
        convs.append({"mkn": [m, k, n], "ms": ms,
                      "tile": getattr(int8_mm.int8_matmul_dequant, "tile", None)})
        del xq, wq
    out["K4"] = {"ms": sum(c["ms"] for c in convs), "convs": convs}
    k4b = []
    for m, k, n in K4B_SHAPES:
        x, w, _, _ = k4_operands(m, k, n, dev)
        k4b.append({"mkn": [m, k, n],
                    "ms": graph_ms(lambda: int8_mm.matmul(x, w, torch.int32)),
                    "int_mm_ms": graph_ms(lambda: torch._int_mm(x, w))})
    out["K4b"] = k4b
    return out


def k1l_run(root: str) -> dict:
    """K1L of the checkout at `root` on the chains and the eval candidates:
    checked against the plain keep-mask, then one call, graph replay and
    the mask / scan split."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from yolo_series_tpu_torch.ops import nms_keep

    dev = torch.device("cuda")
    inputs = np.load(INPUTS)
    out = {"root": root}
    for src, thr in (("k1l", 0.45), ("eval", 0.65)):
        for kl in K1L_SIZES:
            lb = torch.from_numpy(inputs[f"{src}_boxes_{kl}"]).to(dev)
            lv = torch.from_numpy(inputs[f"{src}_valid_{kl}"]).to(dev)
            call = lambda: nms_keep.nms_keep_mask_large(lb, lv, thr)  # noqa: E731
            got = call()
            torch.cuda.synchronize()
            if not torch.equal(got, nms_keep.nms_keep_mask_plain(lb, lv, thr)):
                raise AssertionError(f"{root} {src} K={kl}: differs from the plain keep-mask")
            name = ("chains" if src == "k1l" else "eval") + f"_{kl}"
            out[name] = {"ms": event_ms(call, iters=10), "graph_ms": graph_ms(call, reps=3),
                         **kernel_split(call)}
    return out


def k1l_variants() -> list:
    """Copies of this checkout's package under build/k1l_variants/<name>/,
    each with its K1L_VARIANTS change made to csrc/nms_keep.cu (each text
    must occur once). Returns their roots in the order of K1L_VARIANTS."""
    roots = []
    for name, edits in K1L_VARIANTS.items():
        root = ROOT / "build" / "k1l_variants" / name
        pkg = root / "yolo_series_tpu_torch"
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(ROOT / "yolo_series_tpu_torch", pkg,
                        ignore=shutil.ignore_patterns("__pycache__"))
        src = pkg / "csrc" / "nms_keep.cu"
        text = src.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"variant {name}: {old!r} occurs {text.count(old)} times")
            text = text.replace(old, new)
        src.write_text(text)
        roots.append(str(root))
    return roots


def k4_tiles() -> None:
    """This checkout's K4 at each of the 41 shapes on every tile."""
    import torch

    from yolo_series_tpu_torch.ops import int8_mm

    dev = torch.device("cuda")
    for m, k, n in np.load(INPUTS)["k4_shapes"].tolist():
        xq, wq, scale, bias = k4_operands(m, k, n, dev)
        ms = {f"{bm}x{bn}": graph_ms(lambda: int8_mm.int8_matmul_dequant(
            xq, wq, scale, bias, tile=(bm, bn))) for bm, bn in int8_mm.TILES}
        print(json.dumps({"mkn": [m, k, n], "picked": int8_mm.pick_tile(m, k, n),
                          "ms": ms}), flush=True)


def one_run(root: str) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    import yolo_series_tpu_torch
    from yolo_series_tpu_torch.ops import conv_silu, fused_elan, fused_stem

    dev = torch.device("cuda")

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
    del x, p
    out.update(k1_k4(np.load(INPUTS), dev))
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] in ("--run", "--run-k1l"):
        run = one_run if argv[0] == "--run" else k1l_run
        print(json.dumps(run(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    make_inputs()
    mode = "--run"
    if argv == ["--k4-tiles"]:
        sys.path.insert(0, str(ROOT))
        k4_tiles()
        argv = []
    elif argv == ["--k1l-variants"]:
        with np.load(INPUTS) as saved:
            arrays = dict(saved)
        np.savez(INPUTS, **arrays, **make_eval_candidates())
        roots = k1l_variants()
        argv, mode = roots + roots[::-1], "--run-k1l"
    for root in argv:
        res = subprocess.run([sys.executable, __file__, mode, root],
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
