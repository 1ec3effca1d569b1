"""Export CLI, the deploy pipeline (counterpart of
`yolo_series_tpu/cli/export.py`; the reference's export_onnx.py).

    python -m yolo_series_tpu_torch.cli.export --weights last.ckpt \
        [--int8 --calib-images imgs/] [--pt2 engine.pt2] [--bench] \
        [--batch-size 8 --img-size 640] [--device cpu]

The steps, in order: load the checkpoint (`load_checkpoint_any`: a native
.ckpt, or a reference .pt with --cfg), re-parameterize (`fuse_model`:
Conv+BN, RepConv, implicit folded), with --int8 calibrate on up to 16
images of --calib-images (`LoadImages`, letterboxed) and quantize
(`infer/quant.quantize_model`), then write the deploy checkpoint
`<weights>.deploy.ckpt` (`.int8.ckpt`), or --output, in the JAX format
(`yolo-series-tpu-ckpt-v1`, fp32 params, the cfg carried from the source
checkpoint), which either package's Detector reads.

--pt2 PATH writes a `torch.export` program (`torch.export.save`) of the
JAX package's exported function: uint8 (B, S, S, 3) in, `/ 255` in bf16,
the bf16 forward of the fused (int8) model, `pred` (B, A, no) out
(`program`). It is the plan as fused, without the serving engine's
rewrites; under --int8 the K4-eligible 1x1 convs stay calls of the
registered K4 operator (`ops/int8_mm`), so import
`yolo_series_tpu_torch.ops.int8_mm` before `torch.export.load` of such a
program. The program is traced on --device and runs there. The JAX CLI's
--stablehlo is not carried: StableHLO is XLA's input, which no part of the
port consumes.

--bench runs the port's `ServingEngine` (a CUDA graph of the end-to-end
forward + NMS on the card) at --batch-size and prints img/s and ms a batch.
Runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch
import yaml


class Program(torch.nn.Module):
    """The exported function, uint8 (B, S, S, 3) RGB -> `pred`: the fused
    (int8) model's bf16 forward on x / 255 in bf16, its weights as buffers
    (fp32 leaves in bf16, int8 leaves' scales in fp32, `serving.place`)."""

    def __init__(self, plan, params, state, device):
        from yolo_series_tpu_torch.infer.serving import place

        super().__init__()
        self.plan = plan
        leaves, self._spec = torch.utils._pytree.tree_flatten(
            place(params, state, device, torch.bfloat16))
        self._n = len(leaves)
        for i, t in enumerate(leaves):
            self.register_buffer(f"w{i}", t)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from yolo_series_tpu_torch.models.model import apply_model

        params, state = torch.utils._pytree.tree_unflatten(
            [getattr(self, f"w{i}") for i in range(self._n)], self._spec)
        out, _ = apply_model(self.plan, params, state, x.to(torch.bfloat16) / 255.0,
                             dtype=torch.bfloat16)
        return out["pred"]


def calibration_batches(path: str, img_size: int, limit: int = 16):
    """Up to `limit` letterboxed images of `path` as (1, S, S, 3) fp32 in
    [0, 1], as the JAX CLI feeds `calibrate`."""
    from yolo_series_tpu_torch.infer.sources import LoadImages

    imgs = []
    for _, img, *_ in LoadImages(path, img_size=img_size):
        imgs.append(img.astype(np.float32)[None] / 255.0)
        if len(imgs) >= limit:
            break
    return imgs


def make_parser():
    p = argparse.ArgumentParser("yolo-series-tpu-torch export")
    p.add_argument("--weights", type=str, required=True)
    p.add_argument("--cfg", type=str, default=None)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--int8", action="store_true")
    p.add_argument("--calib-images", type=str, default=None,
                   help="dir of images for INT8 calibration")
    p.add_argument("--conf-thres", type=float, default=0.25)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--max-det", type=int, default=100)
    p.add_argument("--pt2", type=str, default=None,
                   help="write the torch.export program of the bf16 forward here")
    p.add_argument("--bench", action="store_true",
                   help="measure serving throughput/latency after export")
    p.add_argument("--device", default=None,
                   help="'cpu' for the CPU; the card when not given")
    return p


def main(argv=None):
    """Parse `argv` (sys.argv when None) and export. Returns {"deploy": the
    checkpoint's path, "pt2": the program's path or None, "bench": {img_s,
    ms_batch} or None}."""
    from yolo_series_tpu_torch.device import device as _device
    from yolo_series_tpu_torch.models.convert import to_jax_tree
    from yolo_series_tpu_torch.models.reparam import fuse_model
    from yolo_series_tpu_torch.train.checkpoints import (FORMAT, _dump, load_checkpoint,
                                                         load_checkpoint_any)

    opt = make_parser().parse_args(argv)
    dev = _device(opt.device)
    plan, params, state = load_checkpoint_any(opt.weights, opt.cfg)
    params, state = fuse_model(plan, params, state)
    print("fused model (Conv+BN, RepConv, implicit folded)")

    if opt.int8:
        from yolo_series_tpu_torch.infer.quant import calibrate, quantize_model
        act_scales = None
        if opt.calib_images:
            act_scales = calibrate(plan, params, state,
                                   calibration_batches(opt.calib_images, opt.img_size))
            print(f"calibrated {len(act_scales)} activation scales")
        params, state = quantize_model(plan, params, state, act_scales)
        print("quantized conv weights to int8")

    out_path = opt.output or (Path(opt.weights).with_suffix("").as_posix()
                              + (".int8" if opt.int8 else ".deploy") + ".ckpt")
    if opt.cfg:
        with open(opt.cfg) as f:
            cfg_dict = yaml.safe_load(f)
    elif opt.weights.endswith(".pt"):
        cfg_dict = None
    else:   # carry the cfg from the source checkpoint
        cfg_dict = load_checkpoint(opt.weights)["cfg"]
    _dump({"format": FORMAT, "epoch": -1, "best_fitness": 0, "results": None,
           "hyp": None, "cfg": cfg_dict, "step": 0,
           "params": to_jax_tree(params), "state": to_jax_tree(state),
           "ema_params": None, "ema_state": None, "opt_state": None}, out_path)
    print(f"deploy checkpoint -> {out_path}")

    result = {"deploy": out_path, "pt2": None, "bench": None}
    if opt.pt2:
        prog = Program(plan, params, state, dev)
        x = torch.zeros((opt.batch_size, opt.img_size, opt.img_size, 3),
                        dtype=torch.uint8, device=dev)
        with torch.no_grad():
            exported = torch.export.export(prog, (x,))
        torch.export.save(exported, opt.pt2)
        print(f"torch.export program -> {opt.pt2}")
        result["pt2"] = opt.pt2
    if opt.bench:
        from yolo_series_tpu_torch.infer.serving import ServingEngine

        engine = ServingEngine(plan, params, state, batch_size=opt.batch_size,
                               img_size=opt.img_size, conf_thres=opt.conf_thres,
                               iou_thres=opt.iou_thres, max_det=opt.max_det, device=dev)
        engine.warmup()
        x = np.random.default_rng(0).integers(
            0, 255, (opt.batch_size, opt.img_size, opt.img_size, 3), np.uint8)
        n = 20
        t0 = time.perf_counter()
        for _ in range(n):
            engine.infer(x)
        dt = (time.perf_counter() - t0) / n
        print(f"serving: {opt.batch_size / dt:.1f} img/s, "
              f"{dt * 1e3:.2f} ms/batch-{opt.batch_size}")
        result["bench"] = {"img_s": opt.batch_size / dt, "ms_batch": dt * 1e3}
    return result


if __name__ == "__main__":
    main()
