"""Detection CLI, the detect.py equivalent (counterpart of
`yolo_series_tpu/cli/detect.py`; reference detect.py:26-296).

    python -m yolo_series_tpu_torch.cli.detect --weights best.ckpt \
        --source /path/to/imgs --img-size 640 --conf-thres 0.25 [--device cpu]

Image files / dirs / globs, videos, webcam ('0') and stream lists; saves
annotated media and optional txt labels, with the reference's output
conventions. Runs on the card unless `--device cpu` is given (the CPU runs
the kernels' plain versions). The weights are native checkpoints
written by either package's trainer (.ckpt); `--update` strips them in
place after the run (`train/checkpoints.strip_checkpoint`).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import cv2
import numpy as np

from yolo_series_tpu_torch.train.checkpoints import strip_checkpoint
from yolo_series_tpu_torch.utils.general import increment_path


def detect(opt):
    from yolo_series_tpu_torch.infer.detector import Detector, draw_detections
    from yolo_series_tpu_torch.infer.sources import LoadImages, LoadStreams, LoadWebcam

    save_dir = increment_path(Path(opt.project) / opt.name, opt.exist_ok)
    (save_dir / "labels" if opt.save_txt else save_dir).mkdir(parents=True,
                                                              exist_ok=True)
    weights = opt.weights[0] if len(opt.weights) == 1 else opt.weights
    det = Detector.from_checkpoint(
        weights, cfg=opt.cfg, img_size=opt.img_size,
        conf_thres=opt.conf_thres, iou_thres=opt.iou_thres,
        classes=opt.classes, agnostic=opt.agnostic_nms, fuse=not opt.no_fuse,
        augment=opt.augment, device=opt.device)
    names = det.plan.names

    webcam = opt.source.isnumeric() or opt.source.endswith(".txt") or \
        opt.source.lower().startswith(("rtsp://", "rtmp://", "http://", "https://"))
    if webcam and opt.source.isnumeric():
        dataset = LoadWebcam(opt.source, img_size=opt.img_size)
    elif webcam:
        dataset = LoadStreams(opt.source, img_size=opt.img_size)
    else:
        dataset = LoadImages(opt.source, img_size=opt.img_size)

    vid_writer, vid_path = None, None
    t_total = 0.0
    n_frames = 0
    view_img = opt.view_img
    if view_img and sys.platform.startswith("linux") \
            and not (os.environ.get("DISPLAY")
                     or os.environ.get("WAYLAND_DISPLAY")):
        # cv2's Qt build aborts inside imshow without a display server, so
        # probe the environment instead of a live window (reference
        # check_imshow, utils/general.py:103-110)
        print("WARNING: --view-img requires a display; "
              "continuing without live view")
        view_img = False
    for path, img, im0s, cap, ratio, dwdh in dataset:
        im0_list = im0s if isinstance(im0s, list) else [im0s]
        t0 = time.perf_counter()
        results = det(im0_list if len(im0_list) > 1 else im0_list[0])
        t_total += time.perf_counter() - t0
        n_frames += len(im0_list)
        if isinstance(results, np.ndarray):
            results = [results]
        for i, (im0, d) in enumerate(zip(im0_list, results)):
            p = Path(path[i] if isinstance(path, list) else path)
            msg = f"{p.name}: {len(d)} detections"
            # videos and streams get one txt per frame (reference
            # detect.py:165)
            stem = p.stem if dataset.mode == "image" else \
                f"{p.stem}_{getattr(dataset, 'frame', n_frames)}"
            if opt.save_txt:
                h0, w0 = im0.shape[:2]
                lines = []
                for *xyxy, conf, cls in d:
                    cx = (xyxy[0] + xyxy[2]) / 2 / w0
                    cy = (xyxy[1] + xyxy[3]) / 2 / h0
                    bw = (xyxy[2] - xyxy[0]) / w0
                    bh = (xyxy[3] - xyxy[1]) / h0
                    row = [int(cls), cx, cy, bw, bh] + (
                        [conf] if opt.save_conf else [])
                    lines.append(" ".join(f"{v:g}" for v in row))
                (save_dir / "labels" / f"{stem}.txt").write_text(
                    "\n".join(lines))
            if view_img or not opt.nosave:
                draw_detections(im0, d, names)
            if view_img:
                try:
                    cv2.imshow(str(p), im0)
                    cv2.waitKey(1)
                except cv2.error:
                    print("WARNING: --view-img requires a display; "
                          "continuing without live view")
                    view_img = False
            if not opt.nosave:
                if dataset.mode == "image":
                    cv2.imwrite(str(save_dir / p.name), im0)
                else:
                    save_path = str(save_dir / (p.stem + ".mp4"))
                    if vid_path != save_path:
                        vid_path = save_path
                        if vid_writer is not None:
                            vid_writer.release()
                        fps = cap.get(cv2.CAP_PROP_FPS) if cap else 30
                        h, w = im0.shape[:2]
                        vid_writer = cv2.VideoWriter(
                            save_path, cv2.VideoWriter_fourcc(*"mp4v"),
                            fps or 30, (w, h))
                    vid_writer.write(im0)
            print(msg)
    if vid_writer is not None:
        vid_writer.release()
    if hasattr(dataset, "close"):
        dataset.close()
    if n_frames:
        print(f"done: {n_frames} frames, {1e3 * t_total / n_frames:.1f} ms/frame"
              f" -> results saved to {save_dir}")
    return save_dir


def make_parser():
    p = argparse.ArgumentParser("yolo-series-tpu-torch detect")
    p.add_argument("--weights", nargs="+", type=str, required=True,
                   help="native .ckpt checkpoint(s); several build an ensemble")
    p.add_argument("--cfg", type=str, default=None)
    p.add_argument("--source", type=str, default="inference/images")
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--conf-thres", type=float, default=0.25)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--classes", nargs="+", type=int, default=None)
    p.add_argument("--agnostic-nms", action="store_true")
    p.add_argument("--augment", action="store_true", help="TTA inference")
    p.add_argument("--save-txt", action="store_true")
    p.add_argument("--save-conf", action="store_true")
    p.add_argument("--nosave", action="store_true")
    p.add_argument("--view-img", action="store_true",
                   help="display results live (warns and continues if no "
                        "display is available)")
    p.add_argument("--no-fuse", action="store_true")
    p.add_argument("--project", default="runs/detect")
    p.add_argument("--name", default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--update", action="store_true",
                   help="strip optimizer/EMA state from --weights in place "
                        "after running (reference detect.py:174-177)")
    p.add_argument("--device", default=None,
                   help="'cpu' for the CPU; the card when not given")
    return p


def main(argv=None):
    opt = make_parser().parse_args(argv)
    save_dir = detect(opt)
    if opt.update:
        for w in opt.weights:
            if w.endswith(".ckpt"):
                strip_checkpoint(w)
                print(f"stripped {w}")
            else:
                print(f"WARNING: --update skipped {w}: only native .ckpt files "
                      "can be stripped in place")
    return save_dir


if __name__ == "__main__":
    main()
