"""Training driver, the train.py loop (counterpart of
`yolo_series_tpu/train/trainer.py`; reference train.py:41-535).

Builds the datasets and loader, checks the anchors, scales the loss hyp,
ramps warmup, runs `train/step.make_train_step` over the loader's batches
with gradient accumulation to the nominal batch, evaluates the EMA weights
every epoch, writes last / best / periodic checkpoints in the JAX format,
and at the end evaluates best (else last) once more and strips both.

On the device (`TrainConfig.device`: the card unless "cpu"; raises when
no card is visible):
  * the loader's pooled image buffers are copied into pinned staging
    buffers of the trainer's own (`BatchUpload`) before the asynchronous
    upload, so a buffer the loader hands out again is never one the card
    is still reading;
  * the step's metrics come to the host as one transfer a step.

Randomness: the training dataset owns a `random.Random` and a numpy
`RandomState` seeded with `TrainConfig.seed`; autoanchor draws from that
`RandomState` before the first batch, as the JAX trainer draws from the
global `np.random` (see `data/datasets.py`).

Several devices (`n_data_devices` N > 1): one process a device, the
counterpart of the JAX trainer's one-process mesh. `train` spawns N workers
(`parallel/dist.launch`), each of which joins the group (NCCL on the card,
card = rank; gloo on the CPU) and runs `train` again; a process started by
torchrun, or any caller that has joined a group already, runs as its rank.
  * `batch_size` is the global batch (as in the JAX trainer) and must
    divide by N. Every rank draws the same epoch order and loads only its
    slice of each global batch (`create_loader(shard=...)`,
    DistributedSampler's semantics), so N ranks decode N times as fast.
    Decoding the whole global batch on every rank and slicing it would
    cap N cards at one card's loader rate, which already paces one card.
  * Each rank's dataset generators are seeded by (seed, rank)
    (`parallel/dist.rank_seed`; rank 0's by seed alone): with augmentation
    off the global batch is the one-process batch bit for bit; with it on,
    its indices are.
  * The step is the global batch's (`train/step.py`: SyncBN unless
    `sync_bn=False`, which is per-replica BN over N groups; gradients
    all-reduced); the state starts as rank 0's, broadcast, and resume
    loads on every rank. The multi-scale size comes from one seeded
    generator on every rank, so all ranks take the same size.
  * Rank 0 alone builds the label cache first (the others wait, then read
    it), runs autoanchor (the anchors broadcast), writes the logs, hyp,
    opt and artifacts, validates each epoch (the epoch's row broadcast to
    every rank) and writes the checkpoints, in the JAX format as always.

The device-augment tail (`device_aug`): the loader ships uint8 mosaic
tiles and the augmentation parameters (`data/datasets.py`), and the
trainer makes the images on the device before the step
(`data/device_aug.make_device_augment`, built once: separable where the
hyp has no rotation, shear or perspective), accumulated micro-batches
stacked as the JAX trainer stacks them.

Not ported yet, and refused with NotImplementedError: `bbox_interval > 0`
(ROADMAP queue 1 item 19), `split_concat`
and `fast_stem` (item 20; the JAX trainer's `fast_stem=True` default is an
exact reshuffle of the step's plan, `models/faststem.make_train_fast_stem`,
so here it defaults to False and the step runs the plan as compiled). An
IAuxDetect model (the P6 training cfgs) trains with the aux OTA loss
(`losses/aux_ota.py`) and an IBin model with the bin-OTA loss
(`losses/bin_ota.py`, whatever `loss_ota` says), as the JAX trainer
dispatches them. The image size is rounded up to a multiple
of the largest stride (64 for P6; reference train.py:249-250). The
train-batch mosaics and `plot_results` wait for item 19: the trainer says
so once and writes none.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import yaml

from yolo_series_tpu_torch.data.datasets import DetectionDataset, create_loader
from yolo_series_tpu_torch.data.device_aug import MOSAIC_KEYS, make_device_augment
from yolo_series_tpu_torch.device import device as _device
from yolo_series_tpu_torch.eval.evaluator import evaluate
from yolo_series_tpu_torch.losses import (LossHyp, make_compute_loss,
                                          make_compute_loss_aux_ota,
                                          make_compute_loss_bin_ota, make_compute_loss_ota)
from yolo_series_tpu_torch.models.graph import compile_graph
from yolo_series_tpu_torch.models.heads import IAuxDetect, IBin
from yolo_series_tpu_torch.models.model import init_model, tree_leaves
from yolo_series_tpu_torch.obs.artifacts import ARTIFACT_PREFIX
from yolo_series_tpu_torch.parallel.dist import (broadcast_object, broadcast_tensors,
                                                 init_distributed, launch, rank_of,
                                                 rank_seed, sync_processes, world_size)
from yolo_series_tpu_torch.train.checkpoints import (
    load_checkpoint, load_checkpoint_any, restore_train_state, save_checkpoint,
    strip_checkpoint,
)
from yolo_series_tpu_torch.train.optim import OptimConfig
from yolo_series_tpu_torch.train.schedules import warmup_accumulate, warmup_factors
from yolo_series_tpu_torch.train.step import init_train_state, make_train_step
from yolo_series_tpu_torch.utils.general import check_img_size

DEFAULT_TRAIN_HYP = {
    "lr0": 0.01, "lrf": 0.1, "momentum": 0.937, "weight_decay": 0.0005,
    "warmup_epochs": 3.0, "warmup_momentum": 0.8, "warmup_bias_lr": 0.1,
    "box": 0.05, "cls": 0.3, "cls_pw": 1.0, "obj": 0.7, "obj_pw": 1.0,
    "iou_t": 0.2, "anchor_t": 4.0, "fl_gamma": 0.0,
    "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4, "degrees": 0.0,
    "translate": 0.2, "scale": 0.9, "shear": 0.0, "perspective": 0.0,
    "flipud": 0.0, "fliplr": 0.5, "mosaic": 1.0, "mixup": 0.15,
    "copy_paste": 0.0, "paste_in": 0.15, "loss_ota": 1,
}


@dataclasses.dataclass
class TrainConfig:
    cfg: Any                      # model yaml path or dict
    data: Optional[str] = None    # dataset yaml (train/val paths, nc, names)
    hyp: Optional[Any] = None     # hyp yaml path or dict
    epochs: int = 300
    batch_size: int = 16
    img_size: int = 640
    nominal_batch_size: int = 64  # grad-accumulation target (train.py:111)
    weights: str = ""             # initial weights ('' = scratch)
    resume: str = ""              # checkpoint to resume from
    save_dir: str = "runs/train/exp"
    adam: bool = False
    linear_lr: bool = False
    max_labels: int = 256
    eval_every: int = 1
    save_period: int = 25
    seed: int = 0
    n_data_devices: Optional[int] = None   # > 1: one process a device
    rect: bool = False
    compute_dtype: Any = torch.bfloat16
    label_smoothing: float = 0.0
    noval: bool = False
    autoanchor: bool = True       # BPR check + kmeans/GA recompute (train.py:278)
    warmup_min_steps: int = 1000  # reference nw floor (train.py:300)
    multi_scale: bool = False     # 5 gs-rounded size buckets over the
    # reference's uniform [0.5, 1.5] x imgsz draw (train.py:360-365)
    multi_scale_full_range: bool = False  # every gs multiple in the range
    multi_scale_every: int = 1    # redraw cadence in optimizer steps
    freeze: int = 0               # freeze first N layers (train.py:102)
    image_weights: bool = False   # class-weighted epoch resampling
    device_aug: bool = False      # warp/HSV/flip/mixup on the device
    cache_images: bool = False    # RAM-cache decoded images (train --cache)
    fast_decode: bool = False     # reduced-scale JPEG decode (a documented
    # pixel deviation; see data/datasets.py)
    workers: int = 1              # loader decode threads
    fast_stem: bool = False       # item 20, refused (see the module docstring)
    split_concat: bool = False    # item 20, refused
    quad: bool = False            # quad collate + loss x 4 (train.py:377)
    warmup_accumulate: bool = True  # ramp accumulate 1 -> nbs/bs in warmup
    single_cls: bool = False      # treat data as one class (train.py:78-79)
    v5_metric: bool = False       # yolov5 AP convention in the evals
    nosave: bool = False          # only save the final checkpoint (train.py:464)
    sync_bn: bool = True          # False: per-replica BN on several devices
    entity: Optional[str] = None  # W&B entity
    upload_dataset: bool = False  # snapshot the dataset into the artifact
    # store and train from the snapshot (wandb_utils.py:193-218)
    bbox_interval: int = -1       # > 0: item 19, refused
    artifact_alias: str = "latest"  # alias of an artifact:// data ref
    device: Optional[str] = None  # the card unless "cpu"


def _scaled_loss_hyp(hyp: dict, nl: int, nc: int, img_size: int,
                     label_smoothing: float = 0.0) -> LossHyp:
    """Reference hyp rescaling by layers/classes/image size
    (train.py:288-291)."""
    return LossHyp(
        box=hyp["box"] * 3.0 / nl,
        cls=hyp["cls"] * nc / 80.0 * 3.0 / nl,
        obj=hyp["obj"] * (img_size / 640.0) ** 2 * 3.0 / nl,
        cls_pw=hyp["cls_pw"], obj_pw=hyp["obj_pw"],
        anchor_t=hyp["anchor_t"], fl_gamma=hyp["fl_gamma"],
        label_smoothing=label_smoothing, gr=1.0)


def load_hyp(hyp) -> dict:
    if hyp is None:
        return dict(DEFAULT_TRAIN_HYP)
    if isinstance(hyp, dict):
        return dict(DEFAULT_TRAIN_HYP, **hyp)
    with open(hyp) as f:
        return dict(DEFAULT_TRAIN_HYP, **yaml.safe_load(f))


def _refuse_unported(tc: TrainConfig):
    if tc.bbox_interval > 0:
        raise NotImplementedError("--bbox_interval's val media panels need the plots "
                                  "module: ROADMAP queue 1, item 19")
    if tc.fast_stem or tc.split_concat:
        raise NotImplementedError("the train step's layout passes (fast_stem, "
                                  "split_concat) are not ported yet: ROADMAP queue 1, "
                                  "item 20")


def _merge(dst, src):
    """src's leaf where its shape equals dst's, else dst's (the reference's
    intersect_dicts); ValueError when the trees differ in structure."""
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(dst) != set(src):
            raise ValueError("weight tree mismatch")
        return {k: _merge(dst[k], src[k]) for k in dst}
    if isinstance(dst, (list, tuple)):
        if not isinstance(src, (list, tuple)) or len(dst) != len(src):
            raise ValueError("weight tree mismatch")
        return [_merge(d, s) for d, s in zip(dst, src)]
    return src if src.shape == dst.shape else dst


class BatchUpload:
    """Host arrays -> one tensor on the device, through a pinned staging
    buffer per (shape, dtype) that this object owns.

    The arrays (several are stacked along a new first axis) are copied
    into the staging buffer on the host, so they are free to be reused as
    soon as the call returns; the copy to the card is asynchronous, and
    the next call that needs the same buffer waits for it first (a CUDA
    event). On the CPU the arrays are stacked, or the one array is wrapped
    as it is (the CPU step reads it before returning).
    """

    def __init__(self, dev: torch.device):
        self.dev = dev
        self._staging: Dict[Any, Any] = {}

    def __call__(self, arrays) -> torch.Tensor:
        if self.dev.type != "cuda":
            return torch.from_numpy(np.stack(arrays) if len(arrays) > 1 else arrays[0])
        shape = ((len(arrays),) if len(arrays) > 1 else ()) + arrays[0].shape
        key = (shape, arrays[0].dtype.str)
        buf, done = self._staging.get(key, (None, None))
        if buf is None:
            dtype = torch.from_numpy(np.empty(0, arrays[0].dtype)).dtype
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
        else:
            done.synchronize()   # the last upload out of this buffer has finished
        host = buf.numpy()
        if len(arrays) > 1:
            for a, arr in enumerate(arrays):
                host[a] = arr
        else:
            host[...] = arrays[0]
        out = buf.to(self.dev, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self._staging[key] = (buf, done)
        return out


def _dataset(tc, data_cfg, split, hyp=None, **kw):
    is_human = data_cfg.get("dataset") == "human"
    label_key = ("crowd_human_train_label_file" if split == "train"
                 else "crowd_human_valid_label_file")
    return DetectionDataset(
        data_cfg[split], img_size=tc.img_size, batch_size=tc.batch_size, hyp=hyp,
        kind="human" if is_human else "coco",
        odgt_paths=[p for p in [data_cfg.get(label_key)] if p],
        xml_dir=data_cfg.get("safety_helmet_dataset_label_dir"),
        cut_max_len=int(data_cfg.get("cut_max_len", -1)),
        single_cls=tc.single_cls, **kw)


def _rank_main(rank: int, world: int, init_method: str, tc: TrainConfig) -> Dict:
    """One spawned rank of `train`: join the group and train; returns what
    crosses back to the parent (host data)."""
    init_distributed(rank, world, init_method, tc.device or "cuda")
    out = train(tc)
    return {k: out[k] for k in ("best_fitness", "results", "final_results", "save_dir")}


# a test seam, None in use (a training run takes as long as it takes): a
# spawned run is failed, and its workers killed, when it outlasts this, so
# that a hung rank fails a test instead of hanging it
SPAWN_TIMEOUT_S = None


def _spawn(tc: TrainConfig, n: int) -> Dict:
    """`train` on n devices, one spawned process each (rank r on card r);
    rank 0's result, without the train state and plan, which stay in the
    workers (read them from the checkpoints)."""
    dev = torch.device(tc.device or "cuda")
    if dev.type == "cuda":
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if visible < n:
            raise RuntimeError(f"training on {n} devices needs {n} CUDA devices; "
                               f"{visible} {'is' if visible == 1 else 'are'} visible "
                               "(pass device='cpu' to run the ranks on the CPU)")
    if tc.batch_size % n:
        raise ValueError(f"the global batch {tc.batch_size} does not divide over {n} devices")
    # the CPU's threads shared among the ranks
    threads = max(torch.get_num_threads() // n, 1) if dev.type == "cpu" else None
    out = launch(_rank_main, n, args=(tc,), timeout=SPAWN_TIMEOUT_S, threads=threads)[0]
    return {**out, "train_state": None, "plan": None}


def train(tc: TrainConfig, train_ds: Optional[DetectionDataset] = None,
          val_ds: Optional[DetectionDataset] = None,
          callbacks: Optional[Dict[str, Any]] = None) -> Dict:
    """Run training; returns {best_fitness, results, final_results,
    save_dir, train_state, plan}. callbacks["on_epoch_end"](epoch, row,
    train_state) runs after each epoch's checkpoints, on every rank.

    With `n_data_devices` N > 1 and no process group joined yet, spawns N
    ranks (module docstring) and returns rank 0's result with train_state
    and plan None. In a process that has joined a group (a spawned rank,
    torchrun), runs as its rank of the group."""
    _refuse_unported(tc)
    n_dev = tc.n_data_devices or 1
    if not dist.is_initialized():
        if n_dev > 1:
            if train_ds is not None or val_ds is not None or callbacks:
                raise ValueError("datasets and callbacks cannot cross to spawned ranks: "
                                 "join a process group and call train on each rank")
            return _spawn(tc, n_dev)
        group = None
    else:
        group = dist.group.WORLD
        if tc.n_data_devices is not None and n_dev != world_size(group):
            raise ValueError(f"n_data_devices {n_dev}, but the process group has "
                             f"{world_size(group)} ranks")
    rank, world = rank_of(group), world_size(group)
    main = rank == 0
    if tc.batch_size % world:
        raise ValueError(f"the global batch {tc.batch_size} does not divide over {world} ranks")
    dev = _device(tc.device)
    if dev.type == "cuda":   # this rank's own card
        dev = torch.device("cuda", torch.cuda.current_device())
    say = print if main else (lambda *a, **k: None)
    hyp = load_hyp(tc.hyp)
    save_dir = Path(tc.save_dir)
    logger = None
    if main:
        (save_dir / "weights").mkdir(parents=True, exist_ok=True)
        with open(save_dir / "hyp.yaml", "w") as f:
            yaml.dump(hyp, f)
        with open(save_dir / "opt.yaml", "w") as f:  # resume re-reads this
            yaml.dump({k: v for k, v in dataclasses.asdict(tc).items()
                       if isinstance(v, (int, float, str, bool, type(None)))}, f)
        from yolo_series_tpu_torch.obs.loggers import ExperimentLogger
        logger = ExperimentLogger(save_dir, entity=tc.entity)
    say("train: the train-batch mosaics and the results plots are not ported yet "
        "(ROADMAP queue 1, item 19): none is written")

    # dataset artifacts (reference wandb_utils.py:159-218): --upload_dataset
    # snapshots the dataset into the project-level store and trains from the
    # snapshot's data.yaml; an artifact:// ref resolves an existing snapshot
    # (rank 0 alone; the path it trains from is broadcast)
    data_path = tc.data
    if main and data_path and (tc.upload_dataset
                               or str(data_path).startswith(ARTIFACT_PREFIX)):
        from yolo_series_tpu_torch.obs.artifacts import (
            ArtifactStore, download_dataset_artifact, log_dataset_artifact)
        store = ArtifactStore(Path(tc.save_dir).parent / "artifacts")
        if not str(data_path).startswith(ARTIFACT_PREFIX):
            vdir = log_dataset_artifact(store, data_path)
            data_path = str(vdir / "data.yaml")
            print(f"dataset artifact: {vdir} (training from the snapshot)")
        else:
            ref = str(data_path)
            if ":" not in ref[len(ARTIFACT_PREFIX):]:
                ref = f"{ref}:{tc.artifact_alias}"
            data_path = str(download_dataset_artifact(store, ref))
            print(f"dataset artifact resolved: {ref} -> {data_path}")
    data_path = broadcast_object(data_path, 0, group)

    data_cfg: dict = {}
    if data_path:
        with open(data_path) as f:
            data_cfg = yaml.safe_load(f)
    nc = 1 if tc.single_cls else int(data_cfg.get("nc", 80))
    names = data_cfg.get("names", [str(i) for i in range(nc)])
    if tc.single_cls and len(names) != 1:  # reference train.py:79
        names = ["item"]

    plan = compile_graph(tc.cfg, nc=nc)
    tc = dataclasses.replace(tc, img_size=check_img_size(tc.img_size, int(max(plan.strides))))
    params, state = init_model(plan, torch.Generator().manual_seed(tc.seed))
    if tc.weights:
        _, params_l, state_l = load_checkpoint_any(tc.weights, tc.cfg)
        try:   # partial load: the leaves whose shapes match
            params, state = _merge(params, params_l), _merge(state, state_l)
        except ValueError:
            say("WARNING: weight tree mismatch; training from scratch")

    head = plan.head
    # dataset + autoanchor before the loss and step are built, so new
    # anchors reach the step (the reference checks before training, :278)
    if train_ds is None:
        if not main:   # rank 0 writes the label cache; the others then read it
            sync_processes("label cache", group)
        train_ds = _dataset(tc, data_cfg, "train", hyp=hyp, augment=True, rect=tc.rect,
                            stride=int(max(head.strides)), cache_images=tc.cache_images,
                            fast_decode=tc.fast_decode, device_tail=tc.device_aug,
                            seed=rank_seed(tc.seed, rank))
        if main:
            sync_processes("label cache", group)
    anchors_override = None
    if tc.autoanchor and not tc.resume:
        if main:
            try:
                from yolo_series_tpu_torch.utils.autoanchor import check_anchors
                apx = head.anchors_grid()
                _, new_anchors = check_anchors(
                    train_ds.labels, train_ds.shapes, apx, head.strides,
                    thr=hyp["anchor_t"], imgsz=tc.img_size, rng=train_ds.np_rng)
                if new_anchors is not None:
                    nl_, na_ = apx.shape[0], apx.shape[1]
                    anchors_override = new_anchors.reshape(nl_, na_ * 2).round(2).tolist()
            except Exception as e:  # noqa: BLE001 — the JAX trainer's boundary: train on
                print(f"autoanchor skipped: {e!r}")
        anchors_override = broadcast_object(anchors_override, 0, group)
        if anchors_override is not None:
            plan = compile_graph(tc.cfg, nc=nc, anchors=anchors_override)
            head = plan.head
            say("autoanchor: anchors updated")

    nl = len(head.strides)
    # quad: images arrive at 2x side, but the reference scales the hyp by
    # the base imgsz regardless (train.py:288-291)
    loss_hyp = _scaled_loss_hyp(hyp, nl, nc, tc.img_size, tc.label_smoothing)
    if isinstance(head, IAuxDetect):
        loss_fn = make_compute_loss_aux_ota(head, loss_hyp)
    elif isinstance(head, IBin):
        # the reference ships ComputeLossBinOTA (loss.py:848-1172) but never
        # dispatches to it from train.py; an IBin cfg trains with it here,
        # as in the JAX trainer
        if not hyp.get("loss_ota", 1):
            say("IBin head: loss_ota=0 ignored — ComputeLossBinOTA is the only "
                "bin-capable loss (the non-OTA ComputeLoss would misread IBin's "
                "binned w/h channel layout)")
        loss_fn = make_compute_loss_bin_ota(head, loss_hyp)
    else:
        loss_fn = (make_compute_loss_ota if hyp.get("loss_ota", 1)
                   else make_compute_loss)(head, loss_hyp)

    # accumulate micro-batches to the nominal batch; weight decay scaled by
    # the effective batch (train.py:110-112, the final accumulate)
    accumulate = max(round(tc.nominal_batch_size / tc.batch_size), 1)
    opt_cfg = OptimConfig(kind="adam" if tc.adam else "sgd", lr0=hyp["lr0"],
                          momentum=hyp["momentum"],
                          weight_decay=hyp["weight_decay"] * tc.batch_size
                          * accumulate / tc.nominal_batch_size)

    ts = init_train_state(params, state, opt_cfg, device=dev)
    start_epoch = 0
    best_fitness = 0.0
    if tc.resume:
        resume_path = tc.resume
        if resume_path.startswith(ARTIFACT_PREFIX):
            from yolo_series_tpu_torch.obs.artifacts import (ArtifactStore,
                                                             download_model_artifact)
            store = ArtifactStore(Path(tc.save_dir) / "artifacts")
            resume_path, _ = download_model_artifact(store, resume_path)
            resume_path = str(resume_path)
        blob = load_checkpoint(resume_path)
        ts = restore_train_state(blob, opt_cfg, device=dev)
        start_epoch = blob["epoch"] + 1
        best_fitness = blob.get("best_fitness", 0.0)
        say(f"resumed from {resume_path} at epoch {start_epoch}")
    broadcast_tensors(tree_leaves(ts), 0, group)   # every rank starts from rank 0's state

    gs = int(max(head.strides))
    if tc.multi_scale:
        # size buckets over the reference's +-50% range (train.py:360-365),
        # one step per size, drawn after warmup only (as the JAX trainer)
        if tc.multi_scale_full_range:
            lo = int(round(tc.img_size * 0.5 / gs))
            hi = int(round(tc.img_size * 1.5 / gs))
            sizes = [s * gs for s in range(lo, hi + 1)]
        else:
            sizes = sorted({int(round(tc.img_size * s / gs)) * gs
                            for s in (0.5, 0.75, 1.0, 1.25, 1.5)})
        size_rng = np.random.default_rng(tc.seed + 777)
        ms_cur = {"size": None, "step": -1}
    step_cache: Dict[Any, Any] = {}

    def get_step(accum: int, size: Optional[int] = None):
        if (accum, size) not in step_cache:
            step_cache[(accum, size)] = make_train_step(
                plan, loss_fn, opt_cfg, mesh=group, accumulate=accum,
                compute_dtype=tc.compute_dtype, freeze=tc.freeze,
                resize_to=size, loss_scale=4.0 if tc.quad else 1.0,
                bn_shards=world if not tc.sync_bn else 1)
        return step_cache[(accum, size)]

    loader = create_loader(train_ds, batch_size=tc.batch_size,
                           max_labels=tc.max_labels, seed=tc.seed,
                           image_weights=tc.image_weights,
                           hold=accumulate, quad=tc.quad, workers=tc.workers,
                           shard=(rank, world))
    nb = len(loader)
    warmup_steps = max(round(hyp["warmup_epochs"] * nb), tc.warmup_min_steps)

    if not main:   # rank 0 alone validates
        val_ds = None
    elif val_ds is None and not tc.noval and data_cfg.get("val"):
        # the reference always builds a test loader from data['val']
        # (train.py:430-437: rect, pad 0.5)
        try:
            val_ds = _dataset(tc, data_cfg, "val", augment=False, rect=True, pad=0.5,
                              stride=gs)
        except Exception as e:
            # fail loudly: a bad val path would otherwise switch off the
            # per-epoch eval and best-checkpoint selection for the whole run
            raise RuntimeError(
                f"failed to build the val dataset from data['val']="
                f"{data_cfg.get('val')!r} (fix the path or pass --noval): {e}") from e

    def val_loader():
        return create_loader(val_ds, batch_size=tc.batch_size, shuffle=False,
                             max_labels=tc.max_labels, drop_last=False)

    results_rows = []
    if isinstance(tc.cfg, str):
        with open(tc.cfg) as f:
            cfg_dict = yaml.safe_load(f)
    else:
        cfg_dict = dict(tc.cfg)
    # the checkpoint rebuilds the plan as trained (nc, names from the data)
    cfg_dict = {**cfg_dict, "nc": nc, "names": list(names)}
    if anchors_override is not None:
        cfg_dict["anchors"] = anchors_override
    upload = BatchUpload(dev)
    dev_aug = None   # the device tail's program
    if tc.device_aug:
        # the default hyps have no rotation, shear or perspective: the warp
        # is then a scale and translate (two matmuls an image)
        sep = all(hyp.get(k, 0) == 0 for k in ("degrees", "shear", "perspective"))
        dev_aug = make_device_augment(tc.img_size, 2 * tc.img_size, separable=sep,
                                      mosaic=True)

    def device_images(micro):
        """The device tail: each micro-batch's tiles and parameters
        uploaded, its images made on the device, stacked over the
        micro-batches as the JAX trainer stacks them."""
        parts = [upload([b[k] for b in micro]) for k in MOSAIC_KEYS]
        if len(micro) == 1:
            return dev_aug(*parts)
        return torch.stack([dev_aug(*(t[a] for t in parts)) for a in range(len(micro))])

    step = ts.step
    ni = start_epoch * nb  # integrated-batch counter (reference `ni`, train.py:345)
    micro = []  # pending micro-batches, kept across epochs (train.py:384)
    for epoch in range(start_epoch, tc.epochs):
        t0 = time.time()
        wait = 0.0
        mloss = None
        batches = iter(loader)
        while True:
            t_wait = time.perf_counter()
            batch = next(batches, None)
            wait += time.perf_counter() - t_wait
            if batch is None:
                break
            micro.append(batch)
            ni += 1
            # warmup accumulate ramp (train.py:352-353)
            accum_now = (warmup_accumulate(ni - 1, warmup_steps, accumulate)
                         if tc.warmup_accumulate else accumulate)
            if len(micro) < accum_now:
                continue
            acc = len(micro)
            lr_groups, mom = warmup_factors(
                np.float32(ni - 1), warmup_steps, np.float32(epoch), tc.epochs,
                hyp["lr0"], hyp["lrf"], hyp["warmup_bias_lr"],
                hyp["warmup_momentum"], hyp["momentum"], cosine=not tc.linear_lr)
            # multi-scale after warmup only: during the ramp the (acc, size)
            # pairs would multiply the steps built (as the JAX trainer)
            ramping = tc.warmup_accumulate and acc < accumulate
            ms_size = None
            if tc.multi_scale and not ramping:
                ms_cur["step"] += 1
                if ms_cur["size"] is None or ms_cur["step"] % tc.multi_scale_every == 0:
                    ms_cur["size"] = sizes[size_rng.integers(len(sizes))]
                ms_size = ms_cur["size"]
            fn = get_step(acc, ms_size)
            if dev_aug is not None:
                ims = device_images(micro)
            else:
                ims = upload([b["images"] for b in micro])
            lbs = upload([b["labels"] for b in micro])
            mks = upload([b["label_mask"] for b in micro])
            micro = []
            ts, metrics = fn(ts, ims, lbs, mks, lr_groups, mom)
            step += 1
            keys = sorted(metrics)
            # one transfer a step for every metric
            m = dict(zip(keys, torch.stack([metrics[k].float() for k in keys]).tolist()))
            mloss = m if mloss is None else {
                k: (mloss[k] * 0.9 + 0.1 * v) for k, v in m.items()}
        row = {"epoch": epoch, **{f"train/{k}": v for k, v in (mloss or {}).items()},
               "time_s": time.time() - t0, "wait_s": wait}

        fi = 0.0
        if val_ds is not None and not tc.noval and \
                (epoch % tc.eval_every == 0 or epoch == tc.epochs - 1):
            res = evaluate(plan, ts.ema_params, ts.ema_state, val_loader(),
                           names=names, v5_metric=tc.v5_metric, device=dev)
            row.update({f"val/{k}": res[k] for k in ("mp", "mr", "map50", "map")})
            fi = res["fitness"]
        row, fi = broadcast_object((row, fi), 0, group)   # rank 0's row on every rank
        best_fitness = max(best_fitness, fi)
        results_rows.append(row)

        ckpt_kw = dict(cfg=cfg_dict, epoch=epoch, best_fitness=best_fitness,
                       results=results_rows, hyp=hyp)
        weights = save_dir / "weights"
        # --nosave: only the final epoch writes a checkpoint (train.py:464)
        do_save = main and ((not tc.nosave) or epoch == tc.epochs - 1)
        if do_save:
            save_checkpoint(weights / "last.ckpt", ts, **ckpt_kw)
        if do_save and fi > 0 and fi >= best_fitness:
            save_checkpoint(weights / "best.ckpt", ts, **ckpt_kw)
            if epoch >= 200:  # late-best snapshots (train.py:478-479)
                save_checkpoint(weights / f"best_{epoch:03d}.ckpt", ts, **ckpt_kw)
        # epoch-stamped cadence (train.py:480-485): epoch 0, every
        # save_period-th, and the final 5 epochs
        if do_save and (epoch == 0
                        or (tc.save_period > 0 and (epoch + 1) % tc.save_period == 0)
                        or epoch >= tc.epochs - 5):
            save_checkpoint(weights / f"epoch_{epoch:03d}.ckpt", ts, **ckpt_kw)
        say(f"epoch {epoch}: " + " ".join(f"{k}={v:.4f}" if isinstance(v, float)
                                          else f"{k}={v}" for k, v in row.items()))
        if logger is not None:
            logger.log_scalars({k: v for k, v in row.items()
                                if isinstance(v, (int, float))}, step)
        if callbacks and "on_epoch_end" in callbacks:
            callbacks["on_epoch_end"](epoch, row, ts)

    # train-end (reference train.py:494-531): evaluate best if it exists,
    # else last, then strip both to deploy form (strip_optimizer)
    final_results = None
    best_path = save_dir / "weights" / "best.ckpt"
    last_path = save_dir / "weights" / "last.ckpt"
    final_path = best_path if best_path.exists() else last_path
    if main and val_ds is not None and not tc.noval and final_path.exists():
        _, params_f, state_f = load_checkpoint_any(str(final_path))
        final_results = evaluate(plan, params_f, state_f, val_loader(), names=names,
                                 verbose=True, v5_metric=tc.v5_metric, device=dev)
        print(f"final {final_path.name}: "
              + " ".join(f"{k}={final_results[k]:.4f}" for k in ("mp", "mr", "map50", "map")))
    if main:
        for p in (last_path, best_path):
            if p.exists():
                strip_checkpoint(p)
        logger.finish()
        (save_dir / "DONE").write_text("ok")  # resume scanner marker
    sync_processes("train end", group)
    return {"best_fitness": best_fitness, "results": results_rows,
            "final_results": final_results, "save_dir": str(save_dir),
            "train_state": ts, "plan": plan}
