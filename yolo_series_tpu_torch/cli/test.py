"""Evaluation CLI, the test.py equivalent (counterpart of
`yolo_series_tpu/cli/test.py`; reference test.py:291-354).

    python -m yolo_series_tpu_torch.cli.test --weights best.ckpt --data coco.yaml \
        --img-size 640 --batch-size 16 --conf-thres 0.001 --iou-thres 0.65 [--device cpu]

The JAX CLI's flags and output line, plus `--device` (the card unless
`cpu` is asked for; raises when no card is visible). `--weights` takes a
native .ckpt, or a reference .pt with `--cfg`. The forward is fp32
(without TF32, `evaluate`'s pin), or bf16 with `--half`. `--task speed`
runs the timing protocol; `--augment` the multi-scale and flip TTA
(`models/tta.py`). Not ported yet, and refused: `--plots` and `--task
study`, whose output is a plot (ROADMAP queue 1 item 19).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch
import yaml


def run_eval(opt, img_size=None):
    from yolo_series_tpu_torch.data.datasets import DetectionDataset, create_loader
    from yolo_series_tpu_torch.eval.evaluator import coco80_to_coco91, evaluate
    from yolo_series_tpu_torch.models.reparam import fuse_model
    from yolo_series_tpu_torch.train.checkpoints import load_checkpoint_any
    from yolo_series_tpu_torch.utils.general import increment_path

    img_size = img_size or opt.img_size
    with open(opt.data) as f:
        data = yaml.safe_load(f)
    names = data.get("names", ())

    plan, params, state = load_checkpoint_any(opt.weights, opt.cfg)
    if not opt.no_fuse:
        params, state = fuse_model(plan, params, state)

    ds = DetectionDataset(
        data["val"], img_size=img_size, batch_size=opt.batch_size,
        augment=False, rect=not opt.no_rect, stride=int(max(plan.strides)),
        pad=0.5, single_cls=opt.single_cls,
        kind="human" if data.get("dataset") == "human" else "coco",
        odgt_paths=[p for p in [data.get("crowd_human_valid_label_file")] if p],
        xml_dir=data.get("safety_helmet_dataset_label_dir"),
        cut_max_len=int(data.get("cut_max_len", -1)))
    loader = create_loader(ds, batch_size=opt.batch_size, shuffle=False,
                           max_labels=opt.max_labels, drop_last=False,
                           workers=opt.workers)

    save_dir = increment_path(Path(opt.project) / opt.name, opt.exist_ok)
    save_txt = opt.save_txt or opt.save_hybrid  # reference test.py:330
    if save_txt or opt.save_json:
        (save_dir / "labels" if save_txt else save_dir).mkdir(parents=True, exist_ok=True)

    res = evaluate(
        plan, params, state, loader, conf_thres=opt.conf_thres,
        iou_thres=opt.iou_thres, names=names, verbose=opt.verbose,
        compute_dtype=torch.bfloat16 if opt.half else torch.float32,
        save_json=str(save_dir / "predictions.json") if opt.save_json else None,
        coco_ids=(coco80_to_coco91()
                  if opt.save_json and "coco" in str(opt.data) else None),
        v5_metric=opt.v5_metric,
        save_txt_dir=str(save_dir / "labels") if save_txt else None,
        save_conf=opt.save_conf, save_hybrid=opt.save_hybrid, augment=opt.augment,
        device=opt.device)
    print(f"images={res['seen']} P={res['mp']:.4f} R={res['mr']:.4f} "
          f"mAP@.5={res['map50']:.4f} mAP@.5:.95={res['map']:.4f} "
          f"({res['speed_ms']['inference']:.1f}ms inf "
          f"{res['speed_ms']['nms']:.1f}ms nms /img)")
    return res


def make_parser():
    p = argparse.ArgumentParser("yolo-series-tpu-torch test")
    p.add_argument("--weights", type=str, required=True)
    p.add_argument("--cfg", type=str, default=None)
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--conf-thres", type=float, default=0.001)
    p.add_argument("--iou-thres", type=float, default=0.65)
    p.add_argument("--max-labels", type=int, default=256)
    p.add_argument("--workers", type=int, default=1,
                   help="loader decode threads (reference --workers)")
    p.add_argument("--task", default="val", choices=["val", "test", "speed", "study"])
    p.add_argument("--half", action="store_true", help="bf16 forward")
    p.add_argument("--augment", action="store_true", help="TTA eval")
    p.add_argument("--no-rect", action="store_true")
    p.add_argument("--no-fuse", action="store_true")
    p.add_argument("--single-cls", action="store_true",
                   help="treat as a single-class dataset")
    p.add_argument("--save-json", action="store_true")
    p.add_argument("--save-txt", action="store_true",
                   help="save auto-label txts (cls x y w h per det)")
    p.add_argument("--save-hybrid", action="store_true",
                   help="feed GT into NMS as conf-1.0 candidates and save "
                        "hybrid auto-label txts (implies --save-txt)")
    p.add_argument("--save-conf", action="store_true",
                   help="append confidences to --save-txt rows")
    p.add_argument("--v5-metric", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--plots", action="store_true", help="not ported yet: raises")
    p.add_argument("--project", default="runs/test")
    p.add_argument("--name", default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--device", default=None,
                   help="'cpu' for the CPU; the card when not given")
    return p


def main(argv=None):
    """Parse `argv` (sys.argv when None), run, and return evaluate's dict."""
    opt = make_parser().parse_args(argv)
    if opt.plots or opt.task == "study":
        raise NotImplementedError("the eval plots (and --task study's plot) are not "
                                  "ported yet (ROADMAP queue 1, item 19)")
    if opt.save_hybrid:
        # reference test.py:304: the GT rows injected at conf 1.0 match
        # themselves, so P/R/mAP measure the hybrid labels, not the model
        print("WARNING: --save-hybrid will return high mAP from hybrid "
              "labels, not from predictions alone")
    if opt.task == "speed":
        opt.conf_thres, opt.iou_thres, opt.save_json = 0.25, 0.45, False
    return run_eval(opt)


if __name__ == "__main__":
    main()
