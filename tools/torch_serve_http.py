#!/usr/bin/env python3
"""HTTP detection server around the port's `ServingEngine` (counterpart of
tools/serve_http.py): the Triton-server role with the same response
contract, num_dets / det_boxes / det_scores / det_classes.

POST /v1/detect with a JPEG/PNG body (or JSON {"image": b64}) returns
JSON detections in original-image coordinates. Requests are letterboxed
on the host and submitted through a `DynamicBatcher`: its one dispatch
thread alone runs the engine's CUDA graph, whatever the number of handler
threads. The engine runs on the card unless `--device cpu` is given.

Usage: python tools/torch_serve_http.py --weights best.ckpt [--port 8000] [--int8]
       python tools/torch_serve_http.py --weights best.ckpt --dummy   # smoke test
       python tools/client.py image --input img.jpg   # a client
"""

from __future__ import annotations

import argparse
import base64
import json
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def build_engine(opt):
    """(plan, engine, batcher) from the checkpoint: fused, full int8 with
    `--int8` (dynamic scales, as the JAX tool), and with `--low-latency` a
    batch-1 engine for lone requests."""
    from yolo_series_tpu_torch.infer.serving import DynamicBatcher, ServingEngine
    from yolo_series_tpu_torch.models.reparam import fuse_model
    from yolo_series_tpu_torch.train.checkpoints import load_checkpoint_any

    plan, params, state = load_checkpoint_any(opt.weights, opt.cfg)
    params, state = fuse_model(plan, params, state)
    if opt.int8:
        from yolo_series_tpu_torch.infer.quant import quantize_model
        params, state = quantize_model(plan, params, state)
    kw = dict(img_size=opt.img_size, conf_thres=opt.conf_thres, iou_thres=opt.iou_thres,
              max_det=opt.max_det, device=opt.device)
    engine = ServingEngine(plan, params, state, batch_size=opt.batch_size, **kw)
    engine.warmup()
    eng1 = None
    if opt.low_latency:
        # a batch-1 engine: lone requests dispatch at once instead of
        # waiting --max-delay-ms for co-batching (Triton preferred-batch-size
        # behavior at low load)
        eng1 = ServingEngine(plan, params, state, batch_size=1, **kw)
        eng1.warmup(1)
    return plan, engine, DynamicBatcher(engine, max_delay_ms=opt.max_delay_ms,
                                        bs1_engine=eng1)


def detect(batcher, img0: np.ndarray, img_size: int, names) -> dict:
    """One BGR image through the batcher -> the JSON payload: boxes scaled
    back to img0's pixels."""
    from yolo_series_tpu_torch.data.augment import letterbox
    from yolo_series_tpu_torch.eval.evaluator import scale_coords_np

    img, ratio, dwdh = letterbox(img0, img_size, auto=False)
    slot = batcher.submit(np.ascontiguousarray(img[:, :, ::-1]))
    res = batcher.wait(slot, timeout=60.0)
    if res is None:
        raise TimeoutError("the batcher returned no result")
    n = int(res["num_dets"][0])
    boxes = scale_coords_np((img_size, img_size), res["det_boxes"][:n].copy(),
                            img0.shape[:2], ((ratio[1], ratio[0]), dwdh))
    return {
        "num_dets": n,
        "det_boxes": boxes.tolist(),
        "det_scores": res["det_scores"][:n].tolist(),
        "det_classes": res["det_classes"][:n].tolist(),
        "names": [names[int(c)] if int(c) < len(names) else str(int(c))
                  for c in res["det_classes"][:n]],
    }


def make_server(batcher, img_size: int, names, host="0.0.0.0", port=8000):
    """A ThreadingHTTPServer answering POST /v1/detect (not started)."""

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            if self.path != "/v1/detect":
                self.send_error(404)
                return
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            if self.headers.get("Content-Type", "").startswith("application/json"):
                body = base64.b64decode(json.loads(body)["image"])
            img0 = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
            if img0 is None:
                self.send_error(400, "undecodable image")
                return
            data = json.dumps(detect(batcher, img0, img_size, names)).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            pass

    return ThreadingHTTPServer((host, port), Handler)


def make_parser():
    ap = argparse.ArgumentParser("yolo-series-tpu-torch HTTP server")
    ap.add_argument("--weights", required=True)
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--conf-thres", type=float, default=0.25)
    ap.add_argument("--iou-thres", type=float, default=0.45)
    ap.add_argument("--max-det", type=int, default=100)
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    ap.add_argument("--low-latency", action="store_true",
                    help="also build a batch-1 engine; queue-empty requests "
                         "skip the co-batching wait")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--dummy", action="store_true",
                    help="send one ones-buffer through the engine and exit "
                         "(the Triton client's dummy mode)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the CPU; the card when not given")
    return ap


def main(argv=None):
    opt = make_parser().parse_args(argv)
    plan, engine, batcher = build_engine(opt)
    if opt.dummy:
        x = np.ones((opt.batch_size, opt.img_size, opt.img_size, 3), np.uint8)
        out = engine.infer(x)
        print(json.dumps({k: np.asarray(v).shape for k, v in out.items()}, default=str))
        print("dummy inference OK")
        batcher.close()
        return
    server = make_server(batcher, opt.img_size, plan.names, port=opt.port)
    print(f"serving on :{opt.port} (batch {opt.batch_size}, "
          f"dynamic batching {opt.max_delay_ms}ms, {engine.device})")
    try:
        server.serve_forever()
    finally:
        batcher.close()


if __name__ == "__main__":
    main()
