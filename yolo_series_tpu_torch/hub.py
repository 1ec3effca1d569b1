"""Programmatic model entry points, the torch.hub surface (counterpart of
`yolo_series_tpu/hub.py`; reference hubconf.py:22-83): `create`, `custom`
and the named constructors, each returning an inference-ready
`infer/detector.Detector`.

    from yolo_series_tpu_torch import hub
    det = hub.yolov7_tiny(img_size=640)            # the card
    det = hub.custom("best.ckpt", device="cpu")    # the CPU, on purpose
    rows = det(bgr_image)                          # (n, 6) per image

The Detector's arguments (`device`, `dtype`, `augment`, `conf_thres`, ...)
pass through `**kw`; as every entry point of the port, it runs on the card
unless `device="cpu"` is given, and raises when no card is visible.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

_CFG_ROOT = Path(__file__).parent / "models" / "cfg"


def create(name: str = "yolov7", nc: int = 80, img_size: int = 640,
           pretrained_ckpt: Optional[str] = None, **kw):
    """A named model (the port's cfg copy: deploy form first, else the
    training form), fused, in a Detector; from `pretrained_ckpt` when one is
    given, else random weights from the port's seeded init (torch.Generator
    seed 0). Those cannot equal the JAX package's `PRNGKey(0)` draw: the two
    generators differ, so the two hubs' random models differ too."""
    import torch

    from yolo_series_tpu_torch.infer.detector import Detector
    from yolo_series_tpu_torch.models.graph import compile_graph
    from yolo_series_tpu_torch.models.model import init_model
    from yolo_series_tpu_torch.models.reparam import fuse_model

    if pretrained_ckpt:
        return custom(pretrained_ckpt, img_size=img_size, **kw)
    cfg = _CFG_ROOT / "deploy" / f"{name}.yaml"
    if not cfg.exists():
        cfg = _CFG_ROOT / "training" / f"{name}.yaml"
    plan = compile_graph(str(cfg), nc=nc)
    params, state = init_model(plan, torch.Generator().manual_seed(0))
    params, state = fuse_model(plan, params, state)
    return Detector(plan, params, state, img_size=img_size, **kw)


def custom(ckpt_path: str, cfg: Optional[str] = None, img_size: int = 640, **kw):
    """Any checkpoint: a native .ckpt, or a reference .pt with `cfg`
    (`Detector.from_checkpoint`)."""
    from yolo_series_tpu_torch.infer.detector import Detector

    return Detector.from_checkpoint(ckpt_path, cfg=cfg, img_size=img_size, **kw)


def yolov7(**kw):
    return create("yolov7", **kw)


def yolov7_tiny(**kw):
    return create("yolov7-tiny", **kw)
