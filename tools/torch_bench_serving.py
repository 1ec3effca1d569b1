#!/usr/bin/env python3
"""Concurrent-client serving benchmark of the port (counterpart of
tools/bench_serving.py) — the Triton load-test protocol.

The reference publishes its serving numbers under 16-client load
(deploy/triton-inference-server/README.md:115-122):

    dynamic batching ON :  590.1 infer/s @ 27.08 ms avg latency
    dynamic batching OFF:  335.6 infer/s @ 47.60 ms avg latency
    (RTX 3090, TRT-FP16 end2end engine, bs1 requests)

This drives the same shape of load against the port's `infer/serving`:
N client threads each submit their own 640 x 640 uint8 frame in a closed
loop and wait for its detections.

  * batching ON : `DynamicBatcher` (micro-batches up to the engine batch,
    pipelined completion: several executions in flight, as Triton's)
  * batching OFF: a batch-1 engine behind a mutex (one request at a time,
    the Triton `dynamic_batching` stanza removed)

Every answer is checked against a direct single-image call of the same
engine on the client's frame (num_dets equal, boxes within 1e-3 px): each
client gets its own frame's detections. Prints one JSON line with infer/s
and p50 / p99 client latency per mode. `--prestaged` feeds one batch
staged on the card instead of the clients' pixels: it measures queue,
batching, compute and fetch without the host-to-card copy (its answers
are then not the clients' frames' and are not checked).

    python3 tools/torch_bench_serving.py [--clients 16] [--seconds 20] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CFG = ROOT / "yolo_series_tpu_torch/models/cfg/deploy/yolov7.yaml"
BOX_ATOL = 1e-3   # px: the same engine on the same frame, another batch row


def build(batch_size, img=640, device=None, cfg=CFG, seed=0):
    """yolov7 deploy with seeded random weights, fused, as a packed-output
    bf16 engine, warmed up."""
    from yolo_series_tpu_torch.infer.serving import ServingEngine
    from yolo_series_tpu_torch.models.model import Model
    from yolo_series_tpu_torch.models.reparam import fuse_model

    m = Model.from_yaml(str(cfg), seed=seed, device=device)
    params, state = fuse_model(m.plan, m.params, m.state)
    eng = ServingEngine(m.plan, params, state, batch_size=batch_size, img_size=img,
                        conf_thres=0.25, iou_thres=0.45, max_det=100, max_nms=256,
                        pack_output=True, device=device)
    eng.warmup(2)
    return eng


def same_detections(got, want) -> bool:
    """One image's answer against the direct call's first row."""
    n = int(np.asarray(got["num_dets"]).reshape(-1)[0])
    if n != int(want["num_dets"][0, 0]):
        return False
    return bool(np.allclose(got["det_boxes"][:n], want["det_boxes"][0, :n], rtol=0,
                            atol=BOX_ATOL))


def run_clients(n_clients, seconds, submit_and_wait, frames, expected=None):
    """Closed-loop clients, client i sending frames[i]; returns (infer/s,
    p50_ms, p99_ms, requests, wrong answers). With `expected` (one direct
    call's output a frame) every answer is checked against its frame's."""
    lat = [[] for _ in range(n_clients)]
    wrong = [0] * n_clients
    stop = time.perf_counter() + seconds
    barrier = threading.Barrier(n_clients + 1)

    def client(ci):
        barrier.wait()
        while time.perf_counter() < stop:
            t0 = time.perf_counter()
            res = submit_and_wait(frames[ci])
            lat[ci].append(time.perf_counter() - t0)
            if expected is not None and (res is None
                                         or not same_detections(res, expected[ci])):
                wrong[ci] += 1

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
    for t in threads:
        t.start()
    barrier.wait()
    t_start = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start
    all_lat = np.array([v for c in lat for v in c]) * 1e3
    return (len(all_lat) / wall, float(np.percentile(all_lat, 50)),
            float(np.percentile(all_lat, 99)), len(all_lat), sum(wrong))


def bench(engine, engine1, clients=16, seconds=20.0, max_delay_ms=5.0, prestaged=False,
          seed=0):
    """Both modes on the given engines (batch B and batch 1) -> the JSON
    dict. Raises if a client got another frame's detections."""
    from yolo_series_tpu_torch.infer.serving import DynamicBatcher

    img = engine.img_size
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 255, (img, img, 3), np.uint8) for _ in range(clients)]
    stage_fn = staged1 = expected = expected1 = None
    if prestaged:
        import torch

        staged = torch.from_numpy(np.random.default_rng(seed + 1).integers(
            0, 255, engine.in_shape, np.uint8)).to(engine.device)
        staged1 = staged[:1].contiguous()
        stage_fn = lambda frames: staged  # noqa: E731
    else:
        expected = [engine.infer(f[None]) for f in frames]
        expected1 = [engine1.infer(f[None]) for f in frames]

    # -- dynamic batching ON -------------------------------------------------
    batcher = DynamicBatcher(engine, max_delay_ms=max_delay_ms, stage_fn=stage_fn)
    try:
        on = run_clients(clients, seconds, lambda f: DynamicBatcher.wait(batcher.submit(f)),
                         frames, expected)
    finally:
        batcher.close()

    # -- dynamic batching OFF (serialized bs1 requests) ----------------------
    lock = threading.Lock()

    def without_batching(frame):
        with lock:
            if staged1 is not None:
                out, _ = engine1.infer_async(staged1)
                return engine1.to_host(out)
            return {k: v[0] for k, v in engine1.infer(frame[None]).items()}

    off = run_clients(clients, seconds, without_batching, frames, expected1)
    if on[4] or off[4]:
        raise AssertionError(f"clients got another frame's detections: {on[4]} answers "
                             f"with batching, {off[4]} without")

    def mode(r):
        return {"infer_per_sec": r[0], "p50_ms": r[1], "p99_ms": r[2], "requests": r[3],
                "checked": not prestaged}

    return {"clients": clients, "engine_batch": engine.batch_size, "img_size": img,
            "device": str(engine.device), "prestaged_input": bool(prestaged),
            "dynamic_batching_on": mode(on), "dynamic_batching_off": mode(off),
            "baseline_rtx3090_trt": {"on": 590.1, "off": 335.6}}


def main(argv=None):
    ap = argparse.ArgumentParser("yolo-series-tpu-torch serving load bench")
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    ap.add_argument("--prestaged", action="store_true",
                    help="submit one batch staged on the card instead of the "
                         "clients' pixels: the serving stack without the upload")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the CPU; the card when not given")
    args = ap.parse_args(argv)
    engine = build(args.batch_size, args.img_size, args.device)
    engine1 = build(1, args.img_size, args.device)
    out = bench(engine, engine1, args.clients, args.seconds, args.max_delay_ms,
                args.prestaged)
    if engine.device.type == "cuda":
        import torch
        out["card"] = torch.cuda.get_device_name(engine.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
