#!/usr/bin/env python3
"""Operations and parameters of the port's cfgs: the convolutions',
matmuls' and max pools' operations of one image's inference forward at the
given side (`utils/general.FlopCounter.dense`, the count `model_info` and
`profile_layers` make: two a multiply-add over the taps inside the input,
window - 1 compares a pooled output), pointwise work not. The forward runs
on the meta device: shapes only, no arithmetic, no card. One line a cfg.

    python3 tools/torch_zoo_flops.py [deploy/yolov7:640 baseline/yolor-p6:1280 ...]

Without arguments it counts yolov7, yolov7-w6 and the cfgs of the rest of
the zoo at their published sizes.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from yolo_series_tpu_torch.models.graph import compile_graph  # noqa: E402
from yolo_series_tpu_torch.models.model import (apply_model, init_model,  # noqa: E402
                                                tree_leaves, tree_map)
from yolo_series_tpu_torch.utils.general import FlopCounter  # noqa: E402

DEFAULT = ("deploy/yolov7:640", "deploy/yolov7-w6:1280", "deploy/yolov7-tiny:640",
           "baseline/yolov3:640", "baseline/yolov3-spp:640", "baseline/yolov4-csp:640",
           "baseline/yolor-csp:640", "baseline/yolor-csp-x:640", "baseline/r50-csp:640",
           "baseline/x50-csp:640", "baseline/yolor-p6:1280", "baseline/yolor-w6:1280",
           "baseline/yolor-e6:1280", "baseline/yolor-d6:1280")


def count(cfg: str, img: int):
    """(operations, parameters) of `cfg` on one img x img image."""
    plan = compile_graph(str(ROOT / "yolo_series_tpu_torch/models/cfg" / f"{cfg}.yaml"))
    params, state = init_model(plan, torch.Generator().manual_seed(0))
    n = sum(t.numel() for t in tree_leaves(params))
    meta = lambda t: t.to("meta")   # noqa: E731
    with torch.inference_mode(), FlopCounter() as c:
        apply_model(plan, tree_map(meta, params), tree_map(meta, state),
                    torch.zeros((1, img, img, 3), device="meta"))
    return c.dense, n


def main(argv):
    for arg in argv or DEFAULT:
        cfg, img = arg.rsplit(":", 1)
        flops, n = count(cfg, int(img))
        print(f"{cfg} at {img} px: {flops / 1e9:.1f} GFLOPs an image, {n / 1e6:.1f} M params")


if __name__ == "__main__":
    main(sys.argv[1:])
