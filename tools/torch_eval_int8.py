#!/usr/bin/env python3
"""int8 end-to-end accuracy of the port: int8 against fp mAP on one val
set (counterpart of tools/eval_int8.py).

A checkpoint is evaluated twice by the port's `evaluate`, with the same
protocol (conf 0.001, IoU 0.65, rect batches):

  fp   : the fused deploy params, fp32 (the mAP ceiling)
  int8 : calibrated on the first --calib-imgs train images, letterboxed as
         serving letterboxes them (per-output-channel int8 weights,
         per-tensor static activation scales, `infer/quant`); on the card
         the K4-eligible 1x1 convs run the int8 kernel (K4) and the eval
         NMS the large-K keep-mask (K1L)

The JAX tool's third row, its int8 convs on the XLA path beside the Pallas
kernel, has no counterpart: on the card the eligible convs always take
K4. Prints ONE JSON line with both rows and the int8-minus-fp deltas.
Runs on the card unless `--device cpu` is given.

    python3 tools/torch_eval_int8.py --ckpt last.ckpt --data <root with
        train/images and val/images> [--img-size 320] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CLASS_NAMES = ["redrect", "greenellipse", "bluetriangle"]


def metrics(plan, params, state, val_images, img_size, batch_size, device=None,
            names=CLASS_NAMES):
    """mp, mr, map50 and map of the port's fp32 `evaluate` on the val images."""
    from yolo_series_tpu_torch.data.datasets import DetectionDataset, create_loader
    from yolo_series_tpu_torch.eval.evaluator import evaluate

    ds = DetectionDataset(val_images, img_size=img_size, batch_size=batch_size,
                          augment=False, rect=True, stride=32, pad=0.5)
    loader = create_loader(ds, batch_size=batch_size, shuffle=False, max_labels=64,
                           drop_last=False)
    r = evaluate(plan, params, state, loader, names=names, device=device)
    return {k: float(r[k]) for k in ("mp", "mr", "map50", "map")}


def calibration_frames(train_images, img_size, n):
    """The first n train images (sorted), letterboxed to img_size without
    the stride rounding, as (1, S, S, 3) fp32 RGB in [0, 1]."""
    import cv2

    from yolo_series_tpu_torch.data.augment import letterbox

    cal = []
    for p in sorted(Path(train_images).glob("*.jpg"))[:n]:
        im = cv2.imread(str(p))[:, :, ::-1]
        im = letterbox(im, (img_size, img_size), auto=False)[0]
        cal.append(im[None].astype(np.float32) / 255.0)
    return cal


def evaluate_int8(plan, params, state, data, img_size=320, batch_size=8, calib_imgs=8,
                  device=None, names=CLASS_NAMES):
    """Fuse, evaluate fp32, calibrate, quantize, evaluate int8 -> the
    result dict (the JSON line's)."""
    from yolo_series_tpu_torch.infer.quant import calibrate, quantize_model
    from yolo_series_tpu_torch.models.reparam import fuse_model

    data = Path(data)
    val_images = str(data / "val" / "images")
    params, state = fuse_model(plan, params, state)
    out = {"fp": metrics(plan, params, state, val_images, img_size, batch_size, device,
                         names)}
    scales = calibrate(plan, params, state,
                       calibration_frames(data / "train" / "images", img_size, calib_imgs))
    qparams, qstate = quantize_model(plan, params, state, scales)
    print(f"calibrated {len(scales)} scales", flush=True)
    out["int8"] = metrics(plan, qparams, qstate, val_images, img_size, batch_size, device,
                          names)
    out["delta_map50_int8_vs_fp"] = out["int8"]["map50"] - out["fp"]["map50"]
    out["delta_map_int8_vs_fp"] = out["int8"]["map"] - out["fp"]["map"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser("yolo-series-tpu-torch int8 eval")
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--data", required=True,
                    help="dataset root (train/images + val/images, labels beside)")
    ap.add_argument("--img-size", type=int, default=320)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--calib-imgs", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the CPU; the card when not given")
    args = ap.parse_args(argv)

    from yolo_series_tpu_torch.train.checkpoints import load_checkpoint_any

    plan, params, state = load_checkpoint_any(args.ckpt)
    out = {"ckpt": args.ckpt, **evaluate_int8(plan, params, state, args.data, args.img_size,
                                              args.batch_size, args.calib_imgs, args.device)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
