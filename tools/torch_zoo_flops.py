#!/usr/bin/env python3
"""Operations and parameters of the port's cfgs, counted from the compiled
plans (no forward, no card): 2 x MACs of every conv at the given image
side (a grouped conv counts c_in / g inputs an output), the head's 1x1s
included, pools and elementwise work not. One line a cfg.

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

from yolo_series_tpu_torch.models import layers as L  # noqa: E402
from yolo_series_tpu_torch.models.graph import compile_graph  # noqa: E402
from yolo_series_tpu_torch.models.model import init_model, tree_leaves  # noqa: E402

DEFAULT = ("deploy/yolov7:640", "deploy/yolov7-w6:1280", "deploy/yolov7-tiny:640",
           "baseline/yolov3:640", "baseline/yolov3-spp:640", "baseline/yolov4-csp:640",
           "baseline/yolor-csp:640", "baseline/yolor-csp-x:640", "baseline/r50-csp:640",
           "baseline/x50-csp:640", "baseline/yolor-p6:1280", "baseline/yolor-w6:1280",
           "baseline/yolor-e6:1280", "baseline/yolor-d6:1280")


def _side(s):
    return s if isinstance(s, int) else s[0]


def block_flops(block, h: int) -> int:
    """Operations of one block on an h x h input."""
    if isinstance(block, (L.ConvBnAct, L.PlainConv)):
        k, ho = _side(block.k), h // _side(block.s)
        return 2 * (block.c1 // block.g) * block.c2 * k * k * ho * ho
    if isinstance(block, L.RepConv):
        return 2 * (block.c1 // block.g) * block.c2 * 9 * (h // block.s) ** 2
    if isinstance(block, L.Composite):
        # each child at the block's input side, but those fed a downsampled map
        down = ({"cv2": 2, "cv3": 2, "cv4": 4} if isinstance(block, L.Stem)
                else {"cv3": block.k} if isinstance(block, L.DownC) else {})
        return sum(block_flops(c, h // down.get(name, 1)) for name, c in
                   block.children().items())
    return 0


def count(cfg: str, img: int):
    plan = compile_graph(str(ROOT / "yolo_series_tpu_torch/models/cfg" / f"{cfg}.yaml"))
    total = 0
    for spec in plan.layers:
        if spec.is_head:
            total += sum(2 * c * spec.block.no * spec.block.na * (img // int(st)) ** 2
                         for c, st in zip(spec.block.ch, spec.block.strides))
            continue
        # the layer's input side: its output stride undone by its own factor
        h = int(img * spec.block.stride_factor ** spec.n_seq / spec.stride)
        total += block_flops(spec.block, h) * spec.n_seq
    params, _ = init_model(plan, torch.Generator().manual_seed(0))
    return total, sum(t.numel() for t in tree_leaves(params))


def main(argv):
    for arg in argv or DEFAULT:
        cfg, img = arg.rsplit(":", 1)
        flops, n = count(cfg, int(img))
        print(f"{cfg} at {img} px: {flops / 1e9:.1f} GFLOPs an image, {n / 1e6:.1f} M params")


if __name__ == "__main__":
    main(sys.argv[1:])
