"""Evaluation harness, the test.py equivalent (counterpart of
`yolo_series_tpu/eval/evaluator.py`: `evaluate`, `scale_coords_np`,
`coco80_to_coco91`; reference test.py:21-288).

Protocol parity: conf 0.001 / iou 0.65 multi-label NMS over up to 8192
candidates an image (`ops/nms.batched_nms`: on the card the large-K
keep-mask kernel), greedy per-class matching against 10 IoU thresholds
0.5:0.95, `ap_per_class`, optional COCO-json and txt dumps, and speed
accounting with a synchronise on the card. The forward and NMS run on the
device; matching and AP on the host, in numpy. The loader is any iterable
of the JAX loader's batch dicts (`images` (B, H, W, 3) uint8 letterboxed,
`labels` (B, M, 5) normalized cls-xywh, `label_mask` (B, M), `shapes`,
`paths`), such as `data/datasets.create_loader` yields. TF32 is left as
the caller set it.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from yolo_series_tpu_torch.device import device as _device
from yolo_series_tpu_torch.device import full_fp32
from yolo_series_tpu_torch.eval.metrics import (ConfusionMatrix, ap_per_class,
                                                fitness, match_predictions)
from yolo_series_tpu_torch.models.model import apply_model, tree_map
from yolo_series_tpu_torch.models.tta import apply_model_tta
from yolo_series_tpu_torch.ops.nms import batched_nms, nms_output_to_dets


def scale_coords_np(img1_shape, coords, img0_shape, ratio_pad=None):
    """Host scale_coords (reference general.py:545-563): boxes of the
    letterboxed img1_shape back to img0_shape, clipped."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad = ((img1_shape[1] - img0_shape[1] * gain) / 2,
               (img1_shape[0] - img0_shape[0] * gain) / 2)
    else:
        gain = ratio_pad[0][0]
        pad = ratio_pad[1]
    coords = coords.copy()
    coords[:, [0, 2]] -= pad[0]
    coords[:, [1, 3]] -= pad[1]
    coords[:, :4] /= gain
    coords[:, [0, 2]] = coords[:, [0, 2]].clip(0, img0_shape[1])
    coords[:, [1, 3]] = coords[:, [1, 3]].clip(0, img0_shape[0])
    return coords


def coco80_to_coco91() -> List[int]:
    """80-class contiguous ids -> COCO paper 91-class category ids
    (reference general.py coco80_to_coco91_class, used by test.py:262)."""
    return [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19,
            20, 21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38,
            39, 40, 41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55,
            56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74, 75,
            76, 77, 78, 79, 80, 81, 82, 84, 85, 86, 87, 88, 89, 90]


def _xywh2xyxy_np(x: np.ndarray) -> np.ndarray:
    wh = x[..., 2:4] * np.float32(0.5)
    return np.concatenate([x[..., 0:2] - wh, x[..., 0:2] + wh], axis=-1)


def _save_txt(save_txt_dir, path, predn, native_shape, save_conf):
    """Auto-label txt (reference test.py:147-153): one `cls x y w h [conf]`
    row per detection, xywh normalized to the native image; no file for
    zero detections."""
    h0n, w0n = native_shape
    txt = []
    for row in predn:
        x1, y1, x2, y2 = row[:4]
        xywh = ((x1 + x2) / 2 / w0n, (y1 + y2) / 2 / h0n,
                (x2 - x1) / w0n, (y2 - y1) / h0n)
        vals = (int(row[5]),) + xywh + ((float(row[4]),) if save_conf else ())
        txt.append(" ".join(f"{v:g}" for v in vals))
    if txt:
        with open(Path(save_txt_dir) / (Path(path).stem + ".txt"), "a") as f:
            f.write("\n".join(txt) + "\n")


def evaluate(plan, params, state, loader, *,
             conf_thres: float = 0.001, iou_thres: float = 0.65,
             max_det: int = 300, max_nms: int = 8192,
             compute_dtype=torch.float32, names=(),
             confusion: bool = False, save_json: Optional[str] = None,
             coco_ids: Optional[List[int]] = None,
             v5_metric: bool = False, verbose: bool = False,
             augment: bool = False, save_txt_dir: Optional[str] = None,
             save_conf: bool = False, save_hybrid: bool = False,
             plots_dir: Optional[str] = None, device=None):
    """Run mAP evaluation over a loader of letterboxed batches.

    save_txt_dir writes per-image auto-label txts (normalized xywh in
    native image space, reference test.py:147-153); save_hybrid feeds the
    ground-truth boxes into NMS as conf-1.0 candidates for hybrid
    auto-labelling (test.py:124, general.py:656-662). augment: the
    multi-scale and flip TTA (`models/tta.apply_model_tta`; each rect
    batch's height and width scale apart). device: the card
    unless "cpu" is asked for. An fp32 compute_dtype runs the forward in
    full fp32 (`device.full_fp32`: no TF32), whatever the global flags.

    Returns a dict with mp, mr, map50, map, per-class ap, speed, fitness.
    """
    if plots_dir is not None:
        raise NotImplementedError("the batch mosaics are not ported yet (ROADMAP "
                                  "queue 1, item 19, the plots module)")
    dev = _device(device)
    params = tree_map(lambda t: t.to(dev), params)
    state = tree_map(lambda t: t.to(dev), state)
    iouv = np.linspace(0.5, 0.95, 10)

    stats = []
    cm = ConfusionMatrix(plan.nc) if confusion else None
    jdict = []
    t_inf = t_nms = 0.0
    seen = 0

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for batch in loader:
        imgs = batch["images"]
        t0 = time.perf_counter()
        with torch.inference_mode():
            # uint8 ships to the device and normalizes there, in fp32;
            # apply_model casts to compute_dtype
            x = torch.from_numpy(np.ascontiguousarray(imgs)).to(dev)
            with full_fp32(compute_dtype == torch.float32):
                if augment:   # multi-scale and flip TTA (reference test.py --augment)
                    pred = apply_model_tta(plan, params, state, x.float() / 255.0,
                                           dtype=compute_dtype)
                else:
                    pred = apply_model(plan, params, state, x.float() / 255.0,
                                       dtype=compute_dtype)[0]["pred"]
            sync()
            t1 = time.perf_counter()
            if save_hybrid:
                # ground truth joins the NMS candidates as obj-1.0 one-hot
                # rows (reference test.py:124 + general.py:656-662); padded
                # label slots carry obj 0 and fall below conf_thres
                hl, hm = batch["labels"], batch["label_mask"]
                hb, hmax = hl.shape[:2]
                h_b, w_b = imgs.shape[1:3]
                extra = np.zeros((hb, hmax, pred.shape[2]), np.float32)
                extra[..., :4] = hl[..., 1:5] * np.array([w_b, h_b, w_b, h_b], np.float32)
                extra[..., 4] = hm.astype(np.float32)
                np.put_along_axis(extra[..., 5:], hl[..., 0].astype(np.int64)[..., None],
                                  1.0, axis=-1)
                pred = torch.cat([pred, torch.from_numpy(extra).to(dev, pred.dtype)], 1)
            nms = batched_nms(pred, conf_thres=conf_thres, iou_thres=iou_thres,
                              multi_label=True, max_det=max_det, max_nms=max_nms)
            dets = nms_output_to_dets(nms)   # to the host: waits for the card
        t2 = time.perf_counter()
        t_inf += t1 - t0
        t_nms += t2 - t1

        h_in, w_in = imgs.shape[1:3]
        labels = batch["labels"]
        mask = batch["label_mask"]
        for si in range(len(dets)):
            seen += 1
            shapes = batch["shapes"][si]
            lb = labels[si][mask[si]]
            nl = len(lb)
            tcls = lb[:, 0].tolist() if nl else []
            predn = dets[si].copy()
            if shapes is not None:
                (h0, w0), ratio_pad = shapes
                predn[:, :4] = scale_coords_np((h_in, w_in), predn[:, :4],
                                               (h0, w0), ratio_pad)
                native_shape = (h0, w0)
            else:
                native_shape = (h_in, w_in)

            if save_txt_dir is not None:
                _save_txt(save_txt_dir, batch["paths"][si], predn, native_shape,
                          save_conf)

            if save_json is not None:
                image_id = Path(batch["paths"][si]).stem
                box = predn[:, :4].copy()
                box[:, 2:] -= box[:, :2]  # xyxy -> xywh corner
                for row, b in zip(predn, box):
                    jdict.append({
                        "image_id": int(image_id) if image_id.isnumeric() else image_id,
                        "category_id": (coco_ids[int(row[5])] if coco_ids
                                        else int(row[5])),
                        "bbox": [round(float(v), 3) for v in b],
                        "score": round(float(row[4]), 5)})

            if nl:
                tbox = _xywh2xyxy_np(lb[:, 1:5] * np.array([w_in, h_in, w_in, h_in],
                                                           np.float32))
                if shapes is not None:
                    tbox = scale_coords_np((h_in, w_in), tbox, native_shape, shapes[1])
                labelsn = np.concatenate([lb[:, 0:1], tbox], 1)
                correct = match_predictions(predn, labelsn, iouv)
                if cm is not None:
                    cm.process_batch(predn, labelsn)
            else:
                correct = np.zeros((len(predn), len(iouv)), bool)
            stats.append((correct, predn[:, 4], predn[:, 5], np.array(tcls)))

    if stats:
        tp = np.concatenate([s[0] for s in stats])
        conf = np.concatenate([s[1] for s in stats])
        pred_cls = np.concatenate([s[2] for s in stats])
        target_cls = np.concatenate([s[3] for s in stats])
    else:
        tp = np.zeros((0, 10), bool)
        conf = pred_cls = target_cls = np.zeros((0,))

    if len(tp) and tp.any():
        p, r, ap, f1, ap_class = ap_per_class(tp, conf, pred_cls, target_cls,
                                              v5_metric=v5_metric, names=names)
        ap50, ap_mean = ap[:, 0], ap.mean(1)
        mp, mr, map50, map_ = p.mean(), r.mean(), ap50.mean(), ap_mean.mean()
    else:
        p = r = ap50 = ap_mean = np.zeros(1)
        ap_class = np.zeros(0, np.int32)
        mp = mr = map50 = map_ = 0.0

    if save_json is not None and jdict:
        with open(save_json, "w") as f:
            json.dump(jdict, f)

    results = {
        "mp": float(mp), "mr": float(mr), "map50": float(map50),
        "map": float(map_), "seen": seen,
        "ap_class": ap_class, "ap50": ap50, "ap": ap_mean,
        "speed_ms": {"inference": 1e3 * t_inf / max(seen, 1),
                     "nms": 1e3 * t_nms / max(seen, 1)},
        "fitness": float(fitness(np.array([[mp, mr, map50, map_]]))[0]),
    }
    if verbose and len(ap_class):
        for i, c in enumerate(ap_class):
            name = names[c] if c < len(names) else str(c)
            print(f"{name:>20s} {ap50[i]:.3f} {ap_mean[i]:.3f}")
    if cm is not None:
        results["confusion"] = cm
    return results
