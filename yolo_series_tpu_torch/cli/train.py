"""Training CLI, the train.py equivalent (counterpart of
`yolo_series_tpu/cli/train.py`).

    python -m yolo_series_tpu_torch.cli.train --cfg <model.yaml> --data <data.yaml> \
        --hyp <hyp.yaml> --epochs 300 --batch-size 16 --img-size 640 [--device cpu]

The JAX CLI's flags, plus `--device` (the card unless `cpu` is asked for;
raises when no card is visible). `--resume` with no value continues the
newest run under `--project` (`get_latest_run`), in its own directory with
its recorded options (`--devices` and `--no-sync-bn` given again override
them: a run may resume on another number of devices).

Several devices, one process each (`train/trainer.py`):

    python -m yolo_series_tpu_torch.cli.train ... --devices 4 [--no-sync-bn]
    torchrun --nproc_per_node 4 -m yolo_series_tpu_torch.cli.train ...

`--devices N` spawns N workers (rank r on card r; raises when fewer than N
cards are visible; `--device cpu --devices 2` runs two gloo ranks on the
CPU); under torchrun (RANK, WORLD_SIZE, LOCAL_RANK set) this process is one
rank of the group. `--batch-size` is the global batch. `--no-sync-bn`:
per-replica BatchNorm. `--evolve [--evolve-gens G]`: hyperparameter
evolution (`train/evolve.py`). `--device-aug`: the warp, HSV, flips and
mixup run on the device (`data/device_aug.py`). `--bbox_interval N`: the
val mosaics every N epochs, logged as media.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import torch.distributed as dist
import yaml

from yolo_series_tpu_torch.parallel.dist import (broadcast_object, env_rank,
                                                 init_distributed)
from yolo_series_tpu_torch.utils.general import increment_path


def make_parser():
    p = argparse.ArgumentParser("yolo-series-tpu-torch train")
    p.add_argument("--cfg", type=str, default=None,
                   help="model yaml (optional with --resume)")
    p.add_argument("--data", type=str, default=None,
                   help="dataset yaml (optional with --resume)")
    p.add_argument("--hyp", type=str, default=None, help="hyperparameter yaml")
    p.add_argument("--weights", type=str, default="", help="initial weights")
    p.add_argument("--resume", nargs="?", const="auto", default="",
                   help="resume from checkpoint (or newest run)")
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--nbs", type=int, default=64,
                   help="nominal batch: grad-accumulate batch->nbs "
                   "(reference train.py:110-112)")
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--rect", action="store_true")
    p.add_argument("--multi-scale", action="store_true",
                   help="vary img-size +/-50%% (bucketed)")
    p.add_argument("--freeze", type=int, default=0, help="freeze first N layers")
    p.add_argument("--device-aug", action="store_true",
                   help="warp/HSV/flip/mixup on the device")
    p.add_argument("--cache-images", action="store_true",
                   help="RAM-cache decoded images (reference --cache)")
    p.add_argument("--workers", type=int, default=1,
                   help="loader decode threads (reference --workers)")
    p.add_argument("--fast-decode", action="store_true",
                   help="reduced-scale JPEG decode for >=2x-downscaled "
                        "images (documented pixel deviation; big-image "
                        "datasets)")
    p.add_argument("--image-weights", action="store_true")
    p.add_argument("--single-cls", action="store_true",
                   help="train as a single-class dataset")
    p.add_argument("--nosave", action="store_true",
                   help="only save the final checkpoint")
    p.add_argument("--noautoanchor", action="store_true",
                   help="skip the autoanchor BPR check/recompute")
    p.add_argument("--v5-metric", action="store_true",
                   help="yolov5 AP convention in per-epoch/final evals")
    p.add_argument("--quad", action="store_true",
                   help="quad collate: 4 samples -> one 2x image "
                        "(reference collate_fn4)")
    p.add_argument("--adam", action="store_true")
    p.add_argument("--linear-lr", action="store_true")
    p.add_argument("--label-smoothing", type=float, default=0.0)
    p.add_argument("--max-labels", type=int, default=256)
    p.add_argument("--noval", "--notest", action="store_true", dest="noval",
                   help="skip per-epoch eval (reference --notest)")
    p.add_argument("--save-period", "--save_period", type=int, default=25,
                   dest="save_period")
    p.add_argument("--devices", type=int, default=None,
                   help="data-parallel device count: one process a device")
    p.add_argument("--no-sync-bn", action="store_true",
                   help="per-replica BatchNorm on several devices")
    p.add_argument("--project", default="runs/train")
    p.add_argument("--name", default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-warmup-accumulate", action="store_true",
                   help="disable the warmup accumulate ramp (train.py:352)")
    p.add_argument("--evolve", action="store_true",
                   help="hyperparameter evolution (--evolve-gens generations)")
    p.add_argument("--evolve-gens", type=int, default=300)
    p.add_argument("--entity", default=None, help="W&B entity")
    p.add_argument("--upload_dataset", "--upload-dataset",
                   action="store_true", dest="upload_dataset",
                   help="snapshot the dataset into the versioned artifact "
                        "store and train from the snapshot")
    p.add_argument("--bbox_interval", "--bbox-interval", type=int,
                   default=-1, dest="bbox_interval",
                   help="epochs between val bbox media panels")
    p.add_argument("--artifact_alias", "--artifact-alias",
                   default="latest", dest="artifact_alias",
                   help="dataset-artifact alias for artifact:// --data refs")
    p.add_argument("--device", default=None,
                   help="'cpu' for the CPU; the card when not given")
    return p


def main(argv=None):
    """Parse `argv` (sys.argv when None), train (or evolve), and return
    `train`'s dict (`evolve`'s (fitness, hyp) with --evolve)."""
    opt = make_parser().parse_args(argv)
    from yolo_series_tpu_torch.train.checkpoints import get_latest_run
    from yolo_series_tpu_torch.train.trainer import TrainConfig, train

    launched = env_rank()
    if launched is not None and not dist.is_initialized():
        # started by torchrun: this process is one rank of the group
        rank, world, local = launched
        init_distributed(rank, world, "env://", opt.device or "cuda", local_rank=local)
    resume = opt.resume
    if resume == "auto":
        resume = get_latest_run(opt.project)
        if not resume:
            raise FileNotFoundError(f"no last.ckpt found under {opt.project}")

    opt_yaml = (Path(resume).resolve().parent.parent / "opt.yaml"
                if resume and not resume.startswith("artifact://")
                and Path(resume).exists() else None)
    if opt_yaml is not None and opt_yaml.exists():
        # resume continues in the original run dir with its recorded
        # options (reference train.py:203-228)
        with open(opt_yaml) as f:
            saved = yaml.safe_load(f) or {}
        fields = {f.name for f in dataclasses.fields(TrainConfig)}
        kw = {k: v for k, v in saved.items() if k in fields}
        kw["resume"] = resume
        kw["save_dir"] = str(opt_yaml.parent)
        if opt.device is not None:
            kw["device"] = opt.device
        if opt.devices is not None:
            kw["n_data_devices"] = opt.devices
        if opt.no_sync_bn:
            kw["sync_bn"] = False
        tc = TrainConfig(**kw)
    else:
        if not (opt.cfg and opt.data):
            raise SystemExit("--cfg and --data are required (no --resume)")
        # rank 0's choice on every rank of a torchrun group
        save_dir = broadcast_object(
            increment_path(Path(opt.project) / opt.name, opt.exist_ok),
            0, dist.group.WORLD if dist.is_initialized() else None)
        tc = TrainConfig(
            cfg=opt.cfg, data=opt.data, hyp=opt.hyp, epochs=opt.epochs,
            batch_size=opt.batch_size, img_size=opt.img_size,
            nominal_batch_size=opt.nbs,
            weights=opt.weights, resume=resume, save_dir=str(save_dir),
            adam=opt.adam, linear_lr=opt.linear_lr, rect=opt.rect,
            label_smoothing=opt.label_smoothing, max_labels=opt.max_labels,
            noval=opt.noval, save_period=opt.save_period, seed=opt.seed,
            n_data_devices=opt.devices, multi_scale=opt.multi_scale,
            freeze=opt.freeze, image_weights=opt.image_weights,
            device_aug=opt.device_aug, cache_images=opt.cache_images,
            fast_decode=opt.fast_decode, quad=opt.quad, workers=opt.workers,
            warmup_accumulate=not opt.no_warmup_accumulate,
            single_cls=opt.single_cls, nosave=opt.nosave,
            autoanchor=not opt.noautoanchor, v5_metric=opt.v5_metric,
            sync_bn=not opt.no_sync_bn, entity=opt.entity,
            upload_dataset=opt.upload_dataset,
            bbox_interval=opt.bbox_interval,
            artifact_alias=opt.artifact_alias, device=opt.device)
    if opt.evolve:
        from yolo_series_tpu_torch.train.evolve import evolve
        return evolve(tc, generations=opt.evolve_gens)
    return train(tc)


if __name__ == "__main__":
    main()
