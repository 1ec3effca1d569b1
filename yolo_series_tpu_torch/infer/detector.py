"""Detection pipeline: load -> (fuse) -> forward -> NMS (counterpart of
`yolo_series_tpu/infer/detector.py`: `Detector`, `draw_detections`).

The detect.py equivalent (reference detect.py:26-296) and the
autoshape-style wrapper (common.py:865-932): images of any size are
letterboxed on the host (auto=False), turned to RGB, stacked, normalized
and run through the decoded forward, then `ops/nms.batched_nms`
(best class per anchor, up to `max_nms` = 4096 candidates: on the card the
large-K keep-mask kernel), and the boxes scale back to each image's
pixels. Like the JAX Detector it applies the fast-stem transform; on the
card in bf16 it also applies the serving engine's fused stem and fused
ELAN spans, so that detect runs the stem and span kernels as serving does
(both are exact re-arrangements of the same convs). An ensemble of
`extra_models` concatenates their predictions before NMS
(`models/tta.apply_ensemble`).

TTA (`augment=True`, `models/tta.apply_model_tta`): three passes at 1,
0.83 and 0.67 of the size, the second flipped. As in the JAX Detector, it
takes precedence over `extra_models`, which are then ignored, and on the
CPU or in fp32 it skips the fast stem. On the card in bf16 it keeps the
serving rewrites, so the stem and span kernels run at all three scales.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from yolo_series_tpu_torch.data.augment import letterbox
from yolo_series_tpu_torch.device import device as _device
from yolo_series_tpu_torch.device import full_fp32
from yolo_series_tpu_torch.eval.evaluator import scale_coords_np
from yolo_series_tpu_torch.infer.serving import place, serving_transforms
from yolo_series_tpu_torch.models.faststem import make_fast_stem
from yolo_series_tpu_torch.models.model import apply_model
from yolo_series_tpu_torch.models.reparam import fuse_model
from yolo_series_tpu_torch.models.tta import apply_ensemble, apply_model_tta
from yolo_series_tpu_torch.ops.nms import batched_nms, nms_output_to_dets


class Detector:
    """One model (or an ensemble) at a fixed square input size on one
    device (the card unless "cpu" is asked for)."""

    def __init__(self, plan, params, state, img_size=640,
                 conf_thres=0.25, iou_thres=0.45, max_det=300,
                 classes: Optional[Sequence[int]] = None,
                 agnostic=False, dtype=torch.bfloat16, augment=False,
                 extra_models=(), fast_stem=True, max_nms=4096, device=None):
        self.device = _device(device)
        # TTA ignores the ensemble, as the JAX Detector does
        extra = () if augment else tuple(extra_models)
        if fast_stem and not extra:
            if self.device.type == "cuda" and dtype == torch.bfloat16:
                plan, params, state = serving_transforms(plan, params, state)
            elif not augment:
                plan, params, state = make_fast_stem(plan, params, state, max_pairs=2)
        self.plan = plan
        self.params, self.state = place(params, state, self.device, dtype)
        self.extra = [(ep_plan, *place(ep, es, self.device, dtype))
                      for ep_plan, ep, es in extra]
        self.augment = augment
        self.img_size = img_size
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.max_det = max_det
        self.max_nms = max_nms
        self.classes = tuple(classes) if classes is not None else None
        self.agnostic = agnostic
        self.dtype = dtype

    @classmethod
    def from_checkpoint(cls, weights, cfg: Optional[str] = None,
                        fuse: bool = True, **kw):
        """Load checkpoint(s), the attempt_load equivalent
        (experimental.py:247): native .ckpt files, or reference .pt files
        with `cfg`; a list of paths builds an ensemble (experimental.py:69)."""
        from yolo_series_tpu_torch.train.checkpoints import load_checkpoint_any

        paths = [weights] if isinstance(weights, str) else list(weights)
        loaded = []
        for w in paths:
            plan, params, state = load_checkpoint_any(w, cfg)
            if fuse:
                params, state = fuse_model(plan, params, state)
            loaded.append((plan, params, state))
        plan, params, state = loaded[0]
        return cls(plan, params, state, extra_models=loaded[1:], **kw)

    @torch.inference_mode()
    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) fp32 in [0, 1] -> (B, A, no) decoded predictions:
        the TTA passes', or the model's and the ensemble's other models',
        concatenated. In fp32 without TF32 (`device.full_fp32`), whatever
        the global flags."""
        with full_fp32(self.dtype == torch.float32):
            if self.augment:
                return apply_model_tta(self.plan, self.params, self.state, x,
                                       dtype=self.dtype)
            if self.extra:
                return apply_ensemble([(self.plan, self.params, self.state), *self.extra],
                                      x, dtype=self.dtype)
            return apply_model(self.plan, self.params, self.state, x,
                               dtype=self.dtype)[0]["pred"]

    def __call__(self, images) -> List[np.ndarray]:
        """images: one BGR ndarray or a list of them (any sizes). Returns
        per-image (n, 6) [x1, y1, x2, y2, conf, cls] in original image
        coordinates."""
        single = isinstance(images, np.ndarray) and images.ndim == 3
        if single:
            images = [images]
        metas = []
        batch = []
        for im0 in images:
            img, ratio, dwdh = letterbox(im0, self.img_size, auto=False)
            batch.append(img[:, :, ::-1])  # BGR->RGB
            metas.append((im0.shape[:2], ((ratio[1], ratio[0]), dwdh)))
        x = torch.from_numpy(np.ascontiguousarray(np.stack(batch))).to(self.device)
        pred = self._forward(x.float() / 255.0)
        with torch.inference_mode():
            out = batched_nms(pred, conf_thres=self.conf_thres,
                              iou_thres=self.iou_thres, multi_label=False,
                              agnostic=self.agnostic, max_det=self.max_det,
                              max_nms=self.max_nms, classes=self.classes)
        dets = nms_output_to_dets(out)
        h_in = w_in = self.img_size
        results = []
        for det, (shape0, ratio_pad) in zip(dets, metas):
            det = det.copy()
            det[:, :4] = scale_coords_np((h_in, w_in), det[:, :4], shape0, ratio_pad)
            results.append(det)
        return results[0] if single else results

    def predict(self, images, paths=None):
        """Run detection and wrap it in a `Detections` object (the
        autoshape + Detections surface, reference common.py:865-1012)."""
        from yolo_series_tpu_torch.infer.results import Detections

        single = isinstance(images, np.ndarray) and images.ndim == 3
        imgs = [images] if single else list(images)
        dets = self(imgs if len(imgs) > 1 else imgs[0])
        if isinstance(dets, np.ndarray):
            dets = [dets]
        return Detections(imgs, dets, names=self.plan.names, paths=paths)


def draw_detections(im0, det, names=(), line_thickness=3):
    """Render detections onto a BGR image (reference detect.py:179-192)."""
    from yolo_series_tpu_torch.obs.plots import color_list, plot_one_box

    colors = color_list()
    for *xyxy, conf, cls in det:
        c = int(cls)
        label = f"{names[c] if c < len(names) else c} {conf:.2f}"
        plot_one_box(xyxy, im0, label=label, color=colors[c % len(colors)],
                     line_thickness=line_thickness)
    return im0
