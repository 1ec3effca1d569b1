#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`yolo_series_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA Hopper GPU,
the CUDA toolkit and PyTorch built for CUDA:

    python3 chip_smoke.py

It imports torch, numpy and the port only. Phases, each of which exits
non-zero on failure before the last line is printed:

 1. torch / CUDA versions and the card (`nvidia-smi` name and power limit).
 2. Build every kernel of the serving path (`nvcc`, sm_90a), timed, and
    print `ptxas -v`'s registers, shared memory and spills of each kernel
    from its build log.
 3. Each kernel against its plain PyTorch version on the card, at the
    shapes the main paths give it (batch 8, 640 px): K1 the NMS
    keep-mask (must be equal), K1L the large-K keep-mask at K = 1025, 4096
    and 8192 on deep suppression chains and on the real eval candidates
    of the model (conf 0.001, multi-label; must be equal; one call's peak
    allocation must be the packed workspace and the keep mask), K2 the fused
    stem tail and K3 the eight
    fused ELAN spans (within a stated tolerance; beside the fused bound,
    the staged floor: the sum of each launch's own bound), each with its
    51 conv + SiLU launches, recorded as the stem and spans make them,
    alone (ms, TFLOP/s, GB/s, share of its bound, cuDNN on the same
    slices), K4 the int8 matmul with
    dequant at the 41 quantized 1x1 convs of one forward (must be equal),
    and K4b, its bench template, at the shapes of
    `tools/bench_int8_pallas.py` (int8 equal, bf16 within a stated bound).
    Each with its time, the plain version's time, its bound and a library
    yardstick (`library_ms`: cuDNN, or `torch._int_mm`). K1, K1L, K2, K3
    and their cuDNN chains are timed one call between two events (also by
    CUDA-graph replay, beside); K4, K4b and the single conv launches,
    whose calls are short enough for the host's launch cost to show, by
    replaying a CUDA graph (device time). K4 and K4b print the tile each
    shape took.
 4. `ServingEngine` end to end on full-width yolov7 deploy, 640 px, batch
    8, bf16, random weights from a seeded torch.Generator: a few batches
    through `infer` and a few requests through `DynamicBatcher` (with its
    batch-1 low-latency engine). Each engine captures a CUDA graph of
    `end2end` at its first use and replays it after: the kernels' launch
    counters grow at the eager warm-up call and at the capture only (so 2
    forwards' worth an engine: conv_silu 3 launches per stem, 6 per span),
    and every forward is a replay. The graph's output must be bit-equal to
    the same engine's eager `end2end` on the same frames, and agree with
    references built here on the same card (the untransformed deploy plan
    through cuDNN, with the plain keep-mask, in fp32 and in bf16) as the
    tolerances below say. Then img/s from the replay's device time, p50
    latency, the host's time per `infer_async` (graph) and per eager
    `end2end` enqueue, and a profile of the device time. Last, an engine
    with `ingest_hw=(720, 1280)`: its device letterbox within 1 of the host
    letterbox on every pixel, and its detections bit-equal to the plain
    engine's on the same letterboxed pixels, scaled back to the frame.
 4b. The mixed int8 engine on the same weights: calibrated on two noise
    batches, the K4-eligible 1x1 convs quantized, then the same engines
    and main path, captured the same way (launches K1 = K2 = 2 E, K3 = 0,
    K4 = 41 x 2 E for E engines); the graph bit-equal to its eager
    `end2end`, head inputs and detections bit-equal to the same engine with
    the plain K4, and the head inputs within a sanity limit of the fp32
    reference. Then img/s, p50 and a profile. Last, one forward of full
    int8 (every conv but the head's, dynamic scales) at batch 2: K4 = 41 x
    2, K2 = 0, bit-equal with the plain K4.
 5. Detect: full-width yolov7 in training form (IDetect), random weights
    made to detect (`liven`), fused by `reparam.fuse_model`, through
    `infer/detector.Detector` in bf16 on four BGR images of different
    sizes: K1L (4096 candidates), K2 and K3 (8 spans) launch; the
    detections are bit-equal to the same Detector's with the plain
    keep-mask, and agree with an fp32 cuDNN Detector as phase 4's do.
 6. Eval: `eval/evaluator.evaluate` in fp32 over 16 synthetic images in two
    rect batch shapes with labels from the model's own detections: K1L
    (8192 candidates) launches, and map50 / map / mp / mr equal those of
    the same run with the plain keep-mask and those of a run with the
    global TF32 flags on (torch's default; `evaluate` pins full fp32);
    per-image inference and NMS ms, one batch's fp32 forward with TF32 on
    and off, and its NMS split into the stable sort, K1L and the packing.
 7. Train: full-width yolov7 in training form (IDetect), the port's seeded
    init, 640 px, batch 8, bf16, the OTA loss with `LossHyp()`, SGD with
    `OptimConfig()`, noise frames with 4-20 seeded boxes an image padded to
    256 label rows. (a) The OTA loss and assignment on the card against the
    CPU on the same fp32 raw maps; (b) one fp32 step (TF32 off) on the card
    against the CPU at width 0.25, 320 px, batch 2; (c) the bf16 step
    against the fp32 step from the same state; (d) 20 bf16 steps on one
    batch past warmup (the loss falls, all finite, BN stats and EMA move),
    a step with the warmup's step-0 factors and one with accumulate=2;
    (e) ms a step (CUDA events), img/s, host time a step, peak allocation,
    and a one-step profile split into cuDNN convolutions, BN and
    elementwise, the OTA loss and the optimizer with the EMA. The step runs
    none of the port's kernels (the counters stay 0).
 8. Train and test through the CLIs: a synthetic set of 64 train and 16
    val JPEGs (phase 5's four shapes, blocky noise with 1-8 filled
    rectangles an image over the 80 classes) written under build/, then
    `cli/train.py` on full-width yolov7 training form from a start whose
    BN state is set on a training batch and whose head passes candidates
    (the val labels also hold its own 30 most confident detections an
    image, so mAP is above 0), 640 px, batch 8 accumulated to 16, bf16,
    2 epochs, the default hyp (mosaic, mixup, paste-in), autoanchor and
    per-epoch validation: every loss item finite, last.ckpt and best.ckpt
    stripped and read back, validation launched K1L only. Then `cli/test.py` on last.ckpt (fused, fp32): its
    mAP equal with K1L and with the plain keep-mask. Timed: img/s and ms a
    step an epoch, the share of the trainer's time spent waiting for a
    batch, the loader alone with 1 and 4 threads, a checkpoint's bytes and
    write time, validation and the test CLI's ms an image, peak allocation.
 9. The P6 family, yolov7-w6 at full width and 1280 px (the ReOrg stem, a
    4-level head): (a) the deploy form's bf16 `ServingEngine` and
    `DynamicBatcher` at batch 8 as phase 4 drives yolov7's (graphs
    bit-equal to eager, K1 once and K3 once a span, 11 spans, no fused
    stem; detections against the cuDNN references; img/s, p50 at batch 1
    and 8, busy share); (b) K3 at each of the 11 w6 spans against its
    plain version, with its bound and the cuDNN chain; (c) the Detector
    (K1L) and fp32 `evaluate` (K1L, mAP equal with the plain keep-mask and
    with TF32 on) on the training form (IAuxDetect, fused); (d) the aux
    train step (aux OTA loss card against CPU, 8 bf16 steps on one batch,
    ms a step, host ms, peak bytes); (e) the training form written as a
    reference `.pt` (fp16), `cli/train.py --weights` it for one epoch on
    phase 8's set (64 + 16 images, drawn at 1280 px) with the P6 hyp, and
    `cli/test.py` on its last.ckpt, mAP equal with K1L and the plain
    keep-mask.
10. Training on several ranks, on the one card (NCCL takes one rank a
    card, so two ranks on it run gloo): (a) phase 7's bf16 step through a
    one-rank NCCL group against the step without a group, bit-equal under
    cuDNN's deterministic algorithms, and ms a step of both; (b) one fp32
    step on 2 gloo ranks, 4 of the same 8 images each, against the
    one-process fp32 step on all 8 (update, items and BN state within the
    limits below); (c) the trainer on 2 gloo ranks, one epoch of phase 8's
    set from its start: finite losses, rank 0 alone validates (K1L, each
    evaluation equal with the plain keep-mask's) and writes last.ckpt,
    which reads back; img/s, which is not a multi-GPU rate.
11. The rest of the zoo (`zoo`): (a) yolov7-tiny deploy (LeakyReLU) at
    640 px through the bf16 graph engines and `DynamicBatcher` at batch 8
    and 1 as phase 4 drives yolov7's (no fused stem or span: K1 once a
    forward, no `conv_silu_kernel` in a replay's trace; head inputs and
    detections against the cuDNN references; img/s, busy share, host ms,
    p50 at batch 8 and 1); (b) yolov7-tiny-silu the same; (c) tiny's
    training form (IDetect): the Detector (K1L at 4096), fp32 `evaluate`
    (K1L at 8192), a fp32 step card against CPU and bf16 steps with
    hyp.scratch.tiny's loss weights (ms, host ms, peak, busy share), the
    train (1 epoch) and test CLIs on a set drawn as phase 8's (K1L, mAP
    and detections equal with the plain keep-mask, last/best stripped);
    (d) the 11 baselines (yolov3, yolov3-spp, yolov4-csp, yolor-csp,
    yolor-csp-x, r50-csp, x50-csp at 640 px; yolor-p6/w6/d6/e6 at 1280)
    fused and served by the graph engine at batch 8 (K1; each replay
    bit-equal to eager; img/s, busy share; one of each block group held
    against the fp32 reference); (e) `nms_padded` against its plain
    version at 400 rows (K1) and 4096 (K1L).
12. The entry points (`entry_points`), phase 5's and 8's models at full
    width, 640 px: (a) the bf16 Detector with augment=True (TTA) on phase
    5's model and images, which keeps the serving rewrites: K2 and K3 at
    each of the 640, 544 and 448 px passes (conv_silu launches counted by
    scale, each held against the plain conv on its own slices as it runs;
    K2 and K3 whole against their plain versions at the 544 and 448 px
    passes' shapes), K1L once (4096 candidates); bit-equal with the plain
    keep-mask,
    agreement with the fp32 cuDNN TTA Detector as phase 5's; ms a call
    beside the Detector without TTA; (b) `evaluate(augment=True)` in fp32
    on phase 6's batches: K1L at 8192 once a batch, mAP equal with the plain
    keep-mask and with TF32 on; (e) `cli/export.py` on phase 8's start,
    plain and --int8 calibrated on phase 8's val JPEGs, each with --pt2
    and --bench: the program loaded in a fresh process (K4 41 times a
    forward under int8, none without) and its `pred` bit-equal with the
    eager forward of the exported checkpoint under deterministic cuDNN;
    the K4 op's added host ms per eager int8 forward; (c) `cli/test.py
    --augment` on the exported deploy checkpoint (K1L, mAP equal with the
    plain keep-mask); (d) `hub.yolov7()` and `hub.yolov7_tiny()` on the
    card; (f) the device-augment tail: `make_device_augment` on the card
    against the CPU (within two levels), the loader's img/s with the device
    and the host tail at 1 and 4 threads, and `cli/train.py --device-aug`
    for one epoch on phase 8's set (finite losses, img/s, the share spent
    waiting for a batch) beside phase 8's host-tail epochs.
13. The tail of the zoo (`tail`): (a) a cfg built here from the
    long-tail cfg of tests/test_graph.py with a row of every block the
    JAX package's layers.py adds (Focus, nn.Conv2d, DWConv, GhostConv,
    Ghost, GhostCSPA/B/C, SPPF, Contract, Expand, Chuncat, Foldcut,
    nn.BatchNorm2d), yolov7's channels (64-1024) at 640 px, the Swin and
    Transformer blocks on the stride-32 map (20 x 20: the Swin window pads
    it to 24 and shifts), an IDetect on three levels; RepConv_OREPA's
    deploy against its train form, the fused model's fp32 forward on the
    card against the CPU's, Classify alone on the card against the CPU,
    then served at batch 8 as phase 4 serves yolov7 (K1; each replay
    bit-equal to eager; bf16 against the fp32 reference; img/s, busy
    share, host ms); (b) the pose model (the port's yolov7-w6 cfg with an
    IKeypoint head, upstream's yolov7-w6-pose structure) at 960 px, batch
    8, bf16, fused, with the serving rewrites (K3 on its ELAN spans, each
    conv_silu launch held against the plain conv on its own slices, and K3
    whole against its plain version at the 11 spans' 960 px shapes), then
    `batched_nms_kpt` (K1): bit-equal, keypoints included, with the plain
    keep-mask, detections against the fp32 forward as phase 4's, the
    keypoints of the candidate anchors against the fp32 forward's within
    FEAT_RATIO of cuDNN bf16's distance, ms of the forward and of the
    NMS; (c) yolov7's training cfg with an IBin head:
    three bf16 steps with the bin-OTA loss at 640 px, batch 8 (ms and host
    ms a step), a fp32 step at width 0.25 card against CPU, one Detector
    pass (K1L at 4096 candidates, bit-equal with the plain keep-mask), the
    ranking losses and their gradients and SigmoidBin's bf16 decode on
    the card against the CPU.
14. int8 across the zoo and the tools (`int8_and_tools`): (a) yolov7-w6
    deploy at 1280 px mixed, yolov7-tiny deploy full and mixed, x50-csp
    and yolov3 full, and the tail zoo mixed, each calibrated on noise,
    quantized and served by the graph engine at batch 8 (K1, K4; K2 / K3
    where their rewrites still match): each replay bit-equal to eager,
    head inputs and detections bit-equal with the plain K4, head inputs
    within INT8_FEAT_MAX of the bf16 engine's; img/s, busy share, host ms,
    K4 launches, peak allocation; (b) `profile_layers` of phase 4's model
    at batch 8, its rows' sum against the eager forward, `chip_rate` of the
    bf16 engine against phase 4's replay, `model_info` card against CPU;
    (c) tools/torch_serve_http.py in this process on 127.0.0.1, bf16 and
    `--int8`, five JPEGs through tools/client.py, each answer bit-equal to
    the engine's `infer`; (d) tools/torch_bench_serving.py, 16 clients for
    5 s a mode with batching on and off (infer/s, p50, p99; each client
    its own frame's detections); (e) tools/torch_eval_int8.py on phase 8's
    set (fp32 and int8 mAP; K4, K1L; int8 equal with the plain keep-mask).
15. Several cards and the layout passes (`mesh_and_layout`): (a) the
    sharded engine (`infer/serving.ShardedServingEngine`) on full-width
    yolov7 deploy, 640 px, bf16, batch 8, over one card twice: a 2 x 1
    data grid (each row a batch-4 graph engine: K2, K3, K1 a replay, each
    in a fresh process's trace; each half bit-equal with a batch-4 engine's, with the
    row's eager forward, whose conv_silu launches are each held against
    the plain conv, and with the plain keep-mask's) and a 1 x 2 tensor-parallel
    grid (cut convs through cuDNN, K1; head inputs within cuDNN bf16's own
    distance from fp32 of the unsharded bf16 forward, detections by the
    phase-4 rule), img/s and p50; (b) phase 7's step with
    `make_train_fast_stem` (an fp32 step card against CPU by phase 7's
    rule unless the max pools route near-ties otherwise, and the folded
    layers alone under one cotangent against the CPU and the unfolded
    layers; the bf16 step's ms with and without the fold), the
    `split_concat` engine against the plain engine on yolov7-tiny (on
    yolov7 K3 leaves it nothing), `make_lane_align` and `TrainReorgConv`
    on yolov7-w6 training in fp32 against the plain plan; (c) `remat_prefix=4` on phase
    7's step, bit-equal with cuDNN deterministic, peak and ms with and
    without; (d) the native loader (built from the port's loader.cc) on
    phase 8's JPEGs, bit-equal with the Python letterbox, img/s at 1 and 4
    threads; (e) the fp32 eval pred of the training form, card against
    CPU.
16. One JSON line of per-kernel numbers (launch counts with phases 9's to
    15's), the card's name and power limit, and the last line
    `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import json
import math
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import yolo_series_tpu_torch  # noqa: E402

# the port of this checkout, never a copy installed elsewhere: run alone,
# without the package beside it, the script fails here
if Path(yolo_series_tpu_torch.__file__).resolve().parent != ROOT / "yolo_series_tpu_torch":
    raise ImportError(f"yolo_series_tpu_torch is not the one beside {__file__}")

from yolo_series_tpu_torch.cli import export as cli_export
from yolo_series_tpu_torch.cli import test as cli_test
from yolo_series_tpu_torch.cli import train as cli_train
from yolo_series_tpu_torch.data.augment import letterbox
from yolo_series_tpu_torch.data.datasets import DetectionDataset, create_loader
from yolo_series_tpu_torch.data.device_aug import MOSAIC_KEYS, make_device_augment
from yolo_series_tpu_torch.device import full_fp32
from yolo_series_tpu_torch.eval import evaluator
from yolo_series_tpu_torch.eval.evaluator import evaluate, scale_coords_np
from yolo_series_tpu_torch.infer import quant
from yolo_series_tpu_torch.infer.detector import Detector
from yolo_series_tpu_torch.data import native as native_loader
from yolo_series_tpu_torch.infer.serving import (DynamicBatcher, ServingEngine,
                                                 ShardedServingEngine, place,
                                                 serving_transforms)
from yolo_series_tpu_torch.models import extra as X
from yolo_series_tpu_torch.models import heads as H
from yolo_series_tpu_torch.models import layers as L
from yolo_series_tpu_torch.models.model import (Model, _run_layer, apply_model, tree_leaves,
                                                tree_map)
from yolo_series_tpu_torch.models.faststem import (TrainPhasedConvA, TrainPhasedConvB,
                                                   make_train_fast_stem)
from yolo_series_tpu_torch.models.fastconcat import SplitConcatConv
from yolo_series_tpu_torch.models.lanealign import LaneAlignedConv, make_lane_align
from yolo_series_tpu_torch.models.reparam import fuse_model
from yolo_series_tpu_torch.parallel.mesh import ShardedWeight, make_mesh
from yolo_series_tpu_torch.models.torch_export import export_state_dict
from yolo_series_tpu_torch.ops import (_build, conv_silu, fused_elan, fused_stem,
                                       int8_mm, nms_keep)
from yolo_series_tpu_torch.ops.boxes import box_iou
from yolo_series_tpu_torch.parallel.dist import (TIMEOUT as DIST_TIMEOUT, free_port,
                                                 host_local_slice, init_distributed, launch,
                                                 sync_processes)
from yolo_series_tpu_torch.ops.nms import (batched_nms, batched_nms_kpt, fused_head_nms,
                                           nms_padded)
from yolo_series_tpu_torch.losses import (LossHyp, SigmoidBin, alrp_loss, ap_loss,
                                          make_compute_loss_aux_ota,
                                          make_compute_loss_bin_ota, make_compute_loss_ota,
                                          rank_sort_loss)
from yolo_series_tpu_torch.losses.ota import ota_assign_batch
from yolo_series_tpu_torch.train import optim as train_optim
from yolo_series_tpu_torch.train import trainer
from yolo_series_tpu_torch.train.checkpoints import (load_checkpoint, load_checkpoint_any,
                                                     save_checkpoint)
from yolo_series_tpu_torch.train.ema import ema_update
from yolo_series_tpu_torch.train.schedules import warmup_factors
from yolo_series_tpu_torch.train.step import init_train_state, make_train_step

CFG = ROOT / "yolo_series_tpu_torch/models/cfg/deploy/yolov7.yaml"
TRAIN_CFG = ROOT / "yolo_series_tpu_torch/models/cfg/training/yolov7.yaml"

BATCH, IMG = 8, 640
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12    # int8 tensor-core operations
PEAK_FP32 = 67e12      # CUDA cores, outside the tensor cores
PEAK_BYTES = 3.35e12

# (H at 640 px, cin, ct, cc, cout, order) of the 8 ELAN spans of
# full-width yolov7 deploy, in plan order (layers 4..101)
SPANS = ((160, 128, 64, 64, 256, "backbone"), (80, 256, 128, 128, 512, "backbone"),
         (40, 512, 256, 256, 1024, "backbone"), (20, 1024, 256, 256, 1024, "backbone"),
         (40, 512, 256, 128, 256, "head"), (80, 256, 128, 64, 128, "head"),
         (40, 512, 256, 128, 256, "head"), (20, 1024, 512, 256, 512, "head"))

# Tolerance of K2/K3 against their plain versions: both compute fp32 sums
# of the same bf16 products and round each stage to bf16; the sums run in
# another order, so a stage output may land on the neighbouring bf16 value
# (2^-8 relative) and that carries through the chained stages. Max abs
# error <= 2e-2 x max(|plain|, 1).
CONV_REL_TOL = 2e-2
# The engine against references on the same card: the untransformed
# deploy plan through cuDNN with the plain keep-mask, in fp32 (TF32 off)
# and in bf16. The kernels round to bf16 at other points than cuDNN's bf16
# convs, and the rounding of ~200 bf16 stages adds up (~1.5-2% RMS at the
# head inputs on the CPU at width 0.5). So the kernels' path is held against
# how far cuDNN's bf16 path lies from fp32: its head inputs must lie
# within FEAT_RATIO x that relative RMS distance (a wrong channel slice or
# tap gives ~100%). Detections are random boxes packed densely in score,
# where a 1% score change reorders greedy NMS and flips the argmax of
# near-equal class logits: a detection matches one of the same class with
# IoU >= MATCH_IOU and score within MATCH_SCORE, and the kernels' mean
# matched fraction against fp32 must be within MATCH_MARGIN of cuDNN
# bf16's. The NMS tail is held exactly: on the engine's own head inputs,
# the kernel's keep-mask must give the same detections as the plain one.
FEAT_RATIO = 1.5
MATCH_IOU, MATCH_SCORE, MATCH_MARGIN = 0.5, 0.1, 0.05
# the ingest engine's boxes scaled back to the frame on the card against the
# host's `scale_coords_np` on the same boxes: the same fp32 operations, so
# they differ by rounding at most (px)
RESCALE_TOL = 1e-3
# The mixed int8 engine against the same fp32 reference: a sanity limit,
# not a quality claim. Per-tensor int8 inputs calibrated at the 99.99th
# percentile (~4 sigma / 127 a step) add ~1% RMS noise at each of the 41
# quantized convs, and the random network carries it to the head inputs:
# 4.9% relative RMS at width 0.5, 128 px on the CPU (7.6% with every conv
# but the head's quantized, dynamic scales). A wrong scale, channel or
# transpose gives ~100%.
INT8_FEAT_MAX = 0.25
# K4b's bf16 form against fp32 sums of the same products: two fp32 sums of
# K terms in different orders, each add rounded (or truncated, in the
# tensor cores) by at most 2^-23 relative, differ by at most
# K * 2^-22 * sum_k |x_mk w_kn|.
BF16_MM_TOL = 2.0 ** -22
# bench shapes of tools/bench_int8_pallas.py: its two 1x1-conv probes
# (SHAPES_1X1) and its square compute probe
K4B_SHAPES = ((12800, 1024, 512), (3200, 2048, 1024), (8192, 1024, 1024))
# K1L's inputs: deep chains at these K, and the eval path's candidates
# (max_nms of `evaluate`)
K1L_SIZES = (1025, 4096, 8192)
EVAL_NMS = 8192
# Phase 7 (train). Labels padded to MAX_LABELS rows an image (the trainer's
# max_labels), LABELS_AN_IMAGE boxes drawn a image.
MAX_LABELS, LABELS_AN_IMAGE = 256, (4, 20)
# (a) OTA on the card against the CPU on the same fp32 raw maps and labels:
# the same operations, but the card's and the CPU's log, sqrt, sigmoid and
# exp differ by ulps and the sums run in other orders, which can flip a
# near-tie of two costs: at least OTA_COLUMN_SHARE of the candidate columns
# must have the same (fg, matched_gt), and the loss items lie within
# OTA_ITEM_RTOL relative of each other.
OTA_ITEM_RTOL, OTA_COLUMN_SHARE = 1e-5, 0.999
# (b) One fp32 step on the card (TF32 off, `device.full_fp32`) against the
# same step on the CPU, width 0.25, 320 px, batch 2: the relative L2
# distance of the two parameter updates, and of the new BN stats and EMA
# trees (relative L2 over each tree: leaf by leaf they are led by the
# leaves that start at 0, the running means and BN biases, whose values
# are this step's batch means and updates alone, at 1.6e-5 and 3.4e-4
# relative a leaf on the card).
STEP_UPDATE_L2, STEP_STATE_REL = 1e-3, 1e-5
# (c) The bf16 step against the fp32 step from the same state on the same
# batch. The limits are what the JAX package's own bf16 step meets against
# its fp32 step, from the same random init (tests/torch_port_train_noise.py
# on the CPU, width 0.25 at 128 px and width 1.0 at 256 px, batch 2, OTA,
# SGD): loss items within 9.24% of each other, and the whole update's
# cosine similarity only 0.18-0.37. At a random init the loss pushes every
# objectness logit down alike, which each BN's backward removes as a
# per-channel constant: what reaches the early convs is the small
# difference of nearly equal bf16-rounded terms, so their weight grads are
# mostly rounding noise. So items within BF16_ITEM_RTOL, and the whole
# update's cosine at least BF16_UPDATE_COS (a gradient of the wrong sign,
# or a layer without one, gives 0 or less). Phase (b) holds the step's
# arithmetic on the card tightly, in fp32.
BF16_ITEM_RTOL, BF16_UPDATE_COS = 0.15, 0.1
# (d) steps on one fixed batch
TRAIN_STEPS = 20
# Phase 8 (train and test through the CLIs): a synthetic set written under
# build/ from SMOKE_SEED, at the four image shapes of phase 5, with
# BOXES_AN_IMAGE filled rectangles an image over the 80 COCO classes;
# CLI_EPOCHS epochs at batch BATCH accumulated to CLI_NBS, CLI_WORKERS
# loader threads.
SMOKE_DATA, SMOKE_RUNS = ROOT / "build" / "smoke_data", ROOT / "build" / "smoke_runs"
DATA_SHAPES = ((480, 640), (720, 1280), (640, 640), (375, 500))
TRAIN_IMAGES, VAL_IMAGES, BOXES_AN_IMAGE, SMOKE_SEED = 64, 16, (1, 8), 21
CLI_EPOCHS, CLI_NBS, CLI_WORKERS = 2, 16, 4
# Phase 9 (the P6 family): yolov7-w6 at full width, P6_IMG px. Serving at
# batch BATCH; P6_STEPS aux steps on one batch (BATCH, or the largest that
# the card holds: P6_BATCHES in turn); the .pt bridge through the train
# and test CLIs on phase 8's set (drawn again at P6_IMG), one epoch, with
# the P6 hyp.
P6_DEPLOY_CFG = ROOT / "yolo_series_tpu_torch/models/cfg/deploy/yolov7-w6.yaml"
P6_TRAIN_CFG = ROOT / "yolo_series_tpu_torch/models/cfg/training/yolov7-w6.yaml"
P6_HYP = ROOT / "data/hyp.scratch.p6.yaml"
P6_IMG, P6_SPANS, P6_STEPS, P6_BATCHES = 1280, 11, 8, (8, 4, 2)
P6_DATA, P6_RUNS = ROOT / "build" / "smoke_data_p6", ROOT / "build" / "smoke_runs_p6"
# Phase 10 (training on several ranks, on the one card). (a) Phase 7's bf16
# step through a one-rank NCCL group against the step without one, from the
# same state: bit-equal (a one-rank sum and a division by 1 are exact),
# under cuDNN's deterministic algorithms; the step without a group run twice
# is the control. (b) One fp32 step on PAR_RANKS gloo ranks on the card,
# each on its slice of the same BATCH images, against the one-process fp32
# step on all of them, from the same state (readings of batches 5-7 by
# tools/torch_rank_readings.py, H100 80GB HBM3, 700 W). The step's gradient
# is discontinuous at max-pool near-ties: another fp32 summation order
# routes some windows' gradient to another input, which moves the update of
# every layer upstream of a pool. The updates lie 4.1e-3 to 1.9e-2 (relative
# L2) from one process, 7.3e-3 on this batch in every run (the step run
# again: 1.3e-5, 0 under cuDNN's deterministic algorithms); the one-process
# step on the batch in reverse order lies 3.1e-3 to 5.4e-3; the layers
# upstream of a pool hold > 0.9999 of the squared distance. The layers that
# reach the head through no max pool (`pool_free_layers`) lie 1.6e-4 to
# 2.6e-4 for both. Faults in the collective path move those layers: BN's
# scale and bias grads summed twice 2.3e-2 (3.5e-2 in all), dx over the
# local n 0.39 (0.49 in all). So the pool-free layers' update is held
# within PAR_POOL_FREE_L2, and the updates of the params and of the EMA
# params (which follow the params) within PAR_UPDATE_L2, this batch's
# reading with room for its run-to-run spread; the loss items within
# PAR_ITEM_RTOL (the trainer tests' limit: fp32 sums over the positives in
# another order) and the BN state within PAR_STATE_REL relative L2 (phase
# 7 (b)'s). (c) The trainer on PAR_RANKS
# gloo ranks on the card, PAR_EPOCHS epoch on phase 8's set from its
# start: rank 0 alone validates (K1L, each evaluation equal with the plain
# keep-mask's) and writes. Every rank is joined within PAR_TIMEOUT_S.
PAR_RANKS, PAR_EPOCHS, PAR_TIMEOUT_S = 2, 1, 600
PAR_UPDATE_L2, PAR_ITEM_RTOL, PAR_STATE_REL = 1e-2, 1e-4, 1e-5
PAR_POOL_FREE_L2 = 1e-3
PAR_RUN = ROOT / "build" / "smoke_runs" / "ranks"
# Phase 11 (the rest of the zoo). yolov7-tiny's three cfgs at IMG px: the
# deploy forms (LeakyReLU, and SiLU) served as phase 4 serves yolov7, the
# training form (IDetect) through the Detector, `evaluate`, TINY_STEPS bf16
# steps with hyp.scratch.tiny's loss weights and the train and test CLIs
# (one epoch on a set drawn as phase 8's under ZOO_DATA). Then the 11
# baselines at their published sizes, each fused and served by the graph
# engine at batch BATCH, those of ZOO_AGREE (one a block group) held
# against the fp32 reference as phase 4 holds yolov7. Last, `nms_padded`
# on the card against its plain version at NMS_PADDED_CASES (rows, slots,
# IoU threshold): tests/test_nms.py's case (K1) and a large one (K1L).
ZOO_CFGS = ROOT / "yolo_series_tpu_torch/models/cfg"
TINY_DEPLOY_CFG = ZOO_CFGS / "deploy/yolov7-tiny.yaml"
TINY_SILU_CFG = ZOO_CFGS / "deploy/yolov7-tiny-silu.yaml"
TINY_TRAIN_CFG = ZOO_CFGS / "training/yolov7-tiny.yaml"
TINY_HYP = ROOT / "data/hyp.scratch.tiny.yaml"
TINY_STEPS = 4
# tiny's fp32 step on the card against the CPU (phase 7 (b)'s check): its
# gradient jumps where LeakyReLU's slope does (1 to 0.1 at 0). A
# BN-centred pre-activation within fp32 rounding of 0 takes the other
# slope in another summation order, and BN's backward spreads that over its
# channel: params nudged by 1e-7 relative move the gradient of the step's
# configuration (width 0.25, 320 px, batch 2) by 1.4e-2, 1.5e-3 and 4.3e-3
# on the CPU, and that of width 0.5 by 1.6e-3-1.1e-2, against 1.5e-5-2.9e-5
# with SiLU in its place (CPU runs; the H100 reads 1.37e-2, the
# BN stats 1.8e-8 and the loss items 2e-6 from the CPU's). So its updates
# within TINY_UPDATE_L2, its BN stats within STEP_STATE_REL as yolov7's.
TINY_UPDATE_L2 = 5e-2
ZOO_DATA, ZOO_RUNS = ROOT / "build" / "smoke_data_zoo", ROOT / "build" / "smoke_runs_zoo"
BASELINES = (("yolov3", 640), ("yolov3-spp", 640), ("yolov4-csp", 640), ("yolor-csp", 640),
             ("yolor-csp-x", 640), ("r50-csp", 640), ("x50-csp", 640), ("yolor-p6", 1280),
             ("yolor-w6", 1280), ("yolor-d6", 1280), ("yolor-e6", 1280))
ZOO_AGREE = ("yolov3-spp", "yolor-csp-x", "x50-csp", "yolor-p6")
NMS_PADDED_CASES = ((400, 100, 0.5), (4096, 300, 0.45))


def log(*a):
    print(*a, flush=True)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Median device time of fn() over `iters` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, reps=5, iters=10) -> float:
    """Device time of one fn() call: `reps` calls captured in a CUDA graph,
    the graph replayed `iters` times between two events (median), so the
    host's cost of launching is not counted, as for calls that a forward
    runs back to back while the card is busy."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    return statistics.median(times)


def bound_ms(ops, peak, nbytes):
    """(least time in ms, what bounds it) for `ops` operations at `peak`
    and `nbytes` moved at the card's memory rate."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# ------------------------------------------------------------ K1 ---

def chain_boxes(rng, b, k, nc=80):
    """Score-sorted xyxy boxes with class offsets (coordinates up to
    ~3.3e5): half in suppression chains (each box overlaps its neighbour
    above 0.45 IoU and the one after below it, so the fixpoint needs as
    many passes as the chain is long), half in random clusters."""
    out = np.zeros((b, k, 4), np.float32)
    for i in range(b):
        n_chain = k // 2
        w = rng.uniform(40, 80)
        j = np.arange(n_chain)
        x0 = 20 + (j % 64) * 0.3 * w + 40 * (j // 64)
        y0 = rng.uniform(20, 500) + 0 * j
        chain = np.stack([x0, y0, x0 + w, y0 + w], -1)
        centers = rng.uniform(50, 590, (max((k - n_chain) // 16, 1), 2))
        c = centers[rng.integers(0, len(centers), k - n_chain)] \
            + rng.normal(0, 8, (k - n_chain, 2))
        wh = rng.uniform(20, 90, (k - n_chain, 2))
        rand = np.concatenate([c - wh / 2, c + wh / 2], -1)
        boxes = np.concatenate([chain, rand])
        cls = np.concatenate([np.full(n_chain, rng.integers(0, nc)),
                              rng.integers(0, nc, k - n_chain)])
        out[i] = boxes + cls[:, None] * 4096.0
    return out


def keep_mask_pairs(boxes, valid, keep, thr) -> int:
    """IoUs greedy NMS needs on these inputs: for each kept box i, one per
    later box still alive when i is reached (image by image, so that K =
    8192 stays within a few GB)."""
    k = boxes.shape[1]
    upper = torch.ones((k, k), dtype=torch.bool, device=boxes.device).triu(1)
    total = 0
    for b in range(boxes.shape[0]):
        sup = keep[b, :, None] & (box_iou(boxes[b], boxes[b]) > thr) & upper
        before = torch.cumsum(sup, 0) - sup.long()   # kept q < i suppress p
        alive = valid[b, None, :] & (before == 0) & upper
        total += int((alive & keep[b, :, None]).sum())
        del sup, before, alive
    return total


def check_k1(dev, rows):
    rng = np.random.default_rng(0)
    result = None
    for k in (1024, 256):
        boxes = torch.from_numpy(chain_boxes(rng, BATCH, k)).to(dev)
        n_valid = torch.from_numpy(rng.integers(k // 2, k + 1, BATCH)).to(dev)
        n_valid[0] = k
        valid = torch.arange(k, device=dev)[None] < n_valid[:, None]
        got = nms_keep.nms_keep_mask(boxes, valid, 0.45)
        torch.cuda.synchronize()
        want = nms_keep.nms_keep_mask_plain(boxes, valid, 0.45)
        diff = int((got != want).sum())
        if diff:
            raise AssertionError(f"K1 K={k}: {diff} keep-mask entries differ")
        ms = cuda_ms(lambda: nms_keep.nms_keep_mask(boxes, valid, 0.45))
        g_ms = graph_ms(lambda: nms_keep.nms_keep_mask(boxes, valid, 0.45))
        plain_ms = cuda_ms(lambda: nms_keep.nms_keep_mask_plain(boxes, valid, 0.45),
                           iters=5, warmup=1)
        pairs = keep_mask_pairs(boxes, valid, want, 0.45)
        # one IoU is 13 fp32 operations; each box read once, mask written once
        b_ms, b_by = bound_ms(13 * pairs, PEAK_FP32,
                              nbytes(boxes, valid) + want.numel())
        log(f"K1 nms_keep_mask B={BATCH} K={k}: equal to plain "
            f"(kept {int(want.sum())} of {int(valid.sum())} valid); one call "
            f"{ms:.4f} ms (graph replay {g_ms:.4f}), plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.6f} ms ({b_by}, {pairs} IoUs)")
        if k == 1024:  # the serving engine's max_nms
            result = dict(max_abs_err=float(diff), ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=None, graph_ms=g_ms)
    rows["K1"] = result


@contextlib.contextmanager
def keep_mask(fn):
    """Inside: `ops/nms.py` takes `fn` for its keep-mask, on the card too
    (`plain_nms()`: the reference runs of the bit-equality checks; they
    count no launch)."""
    kernel = nms_keep.nms_keep_mask
    nms_keep.nms_keep_mask = fn
    try:
        yield
    finally:
        nms_keep.nms_keep_mask = kernel


def plain_nms():
    return keep_mask(nms_keep.nms_keep_mask_plain)


def eval_candidates(m, images, conf_thres=0.001, iou_thres=0.65, max_nms=8192):
    """The keep-mask inputs (score-sorted class-offset boxes, valid) of
    `evaluate`'s NMS on `images`: the fp32 forward of the fused model, then
    `batched_nms` multi-label with `max_nms` candidates, as eval runs it
    (the forward pinned to full fp32 as `evaluate` pins it)."""
    got = []

    def grab(boxes, valid, thr):
        got.append((boxes.clone(), valid.clone()))
        return torch.zeros_like(valid)

    with torch.inference_mode(), keep_mask(grab), full_fp32():
        x = torch.from_numpy(images).to(m.dev).float() / 255.0
        out, _ = apply_model(m.plan, m.params, m.state, x, dtype=torch.float32)
        batched_nms(out["pred"], conf_thres=conf_thres, iou_thres=iou_thres,
                    multi_label=True, max_nms=max_nms)
    return got[0]


def kernel_ms(fn, names, n=3):
    """Device ms of one fn() call spent in each kernel whose name holds one
    of `names` (torch.profiler over n calls; None where nothing was
    recorded)."""
    from torch.profiler import ProfilerActivity, profile

    out = {name: None for name in names}
    if not torch.cuda.is_available():   # a CPU rehearsal of this script
        return out
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
        for name in names:
            if name in e.key and us:
                out[name] = (out[name] or 0.0) + us / 1e3 / n
    return out


def peak_bytes(fn):
    """Bytes torch's allocator holds at the peak of one fn() call, above
    what it held before (None on the CPU)."""
    if not torch.cuda.is_available():
        return None
    fn()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - before


def library_nms_ms(boxes, valid, thr):
    """One call of torchvision's NMS per image on the same score-ordered
    boxes, where torchvision is installed (it is not a dependency of the
    port, and nothing installs it); else None."""
    import importlib.util

    if importlib.util.find_spec("torchvision") is None:
        return None
    import torchvision

    k = boxes.shape[1]
    scores = torch.linspace(1.0, 0.5, k, device=boxes.device)

    def run():
        for b in range(boxes.shape[0]):
            torchvision.ops.nms(boxes[b][valid[b]], scores[valid[b]], thr)

    return cuda_ms(run, iters=5)


def check_k1l(dev, rows, m):
    """K1L at B = 8 against the plain keep-mask on deep suppression chains
    (K = 1025, 4096, 8192) and on the real eval candidates of the model (K
    = 8192, IoU 0.65): equal. One call and graph replay times, the plain
    version's, the bound (IoUs greedy needs at 67 TFLOP/s fp32; boxes in,
    keep out) and beside it the design's own floor (every IoU of the upper
    triangle, the mask written and read once). The row of the kernels line
    is the eval candidates', the main path's input."""
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (BATCH, IMG, IMG, 3), np.uint8)
    cases = []
    for k in K1L_SIZES:
        boxes = torch.from_numpy(chain_boxes(rng, BATCH, k)).to(dev)
        n_valid = torch.from_numpy(rng.integers(k // 2, k + 1, BATCH)).to(dev)
        n_valid[0] = k
        cases.append((f"chains K={k}", boxes,
                      torch.arange(k, device=dev)[None] < n_valid[:, None], 0.45))
    boxes, valid = eval_candidates(m, images, max_nms=EVAL_NMS)
    cases.append((f"eval candidates K={boxes.shape[1]}", boxes, valid, 0.65))
    runs = []
    for name, boxes, valid, thr in cases:
        k = boxes.shape[1]
        got = nms_keep.nms_keep_mask(boxes, valid, thr)
        torch.cuda.synchronize()
        want = nms_keep.nms_keep_mask_plain(boxes, valid, thr)
        diff = int((got != want).sum())
        if diff:
            raise AssertionError(f"K1L {name}: {diff} keep-mask entries differ")
        call = lambda: nms_keep.nms_keep_mask_large(boxes, valid, thr)  # noqa: E731
        ms = cuda_ms(call, iters=10)
        g_ms = graph_ms(call, reps=3, iters=5)
        plain_ms = cuda_ms(lambda: nms_keep.nms_keep_mask_plain(boxes, valid, thr),
                           iters=1, warmup=0)
        split = kernel_ms(call, ("nms_mask_kernel", "nms_scan_kernel"))
        pairs = keep_mask_pairs(boxes, valid, want, thr)
        b_ms, b_by = bound_ms(13 * pairs, PEAK_FP32, nbytes(boxes, valid) + want.numel())
        ws = nms_keep.large_workspace_bytes(BATCH, k)   # the packed tiles
        floor_ms = max(13 * BATCH * k * (k - 1) / 2 / PEAK_FP32 * 1e3,
                       2 * ws / PEAK_BYTES * 1e3)
        peak = peak_bytes(call)
        # the allocator rounds a block up to 512 bytes and may leave up to
        # 1 MiB of a fresh segment unsplit
        if peak is not None and not ws + want.numel() <= peak <= ws + want.numel() + (1 << 20):
            raise AssertionError(f"K1L {name}: one call allocates {peak} bytes, the packed "
                                 f"workspace and the keep mask are {ws + want.numel()}")
        log(f"K1L nms_keep_mask_large B={BATCH} {name}: equal to plain (kept "
            f"{int(want.sum())} of {int(valid.sum())} valid); one call {ms:.4f} ms "
            f"(graph replay {g_ms:.4f}), plain {plain_ms:.3f} ms, bound {b_ms:.6f} ms "
            f"({b_by}, {pairs} IoUs), design floor {floor_ms:.4f} ms (all "
            f"{BATCH * k * (k - 1) // 2} IoUs, packed mask {ws / 1e6:.1f} MB written "
            f"and read); peak allocation of one call {peak} bytes (workspace {ws}, keep "
            f"{want.numel()}); profile: mask kernel {split['nms_mask_kernel']} ms, scan "
            f"kernel {split['nms_scan_kernel']} ms")
        runs.append(dict(case=name, k=k, ms=ms, graph_ms=g_ms, plain_ms=plain_ms,
                         mask_ms=split["nms_mask_kernel"], scan_ms=split["nms_scan_kernel"],
                         bound_ms=b_ms, bound_by=b_by, design_floor_ms=floor_ms,
                         workspace_bytes=ws, peak_bytes=peak,
                         ious=pairs, kept=int(want.sum()), valid=int(valid.sum())))
        del got, want
    ev = runs[-1]
    boxes, valid, thr = cases[-1][1:]
    lib_ms = library_nms_ms(boxes, valid, thr)
    log(f"K1L library yardstick (torchvision.ops.nms, image by image): "
        f"{'not installed' if lib_ms is None else f'{lib_ms:.4f} ms'}")
    rows["K1L"] = dict(max_abs_err=0.0, ms=ev["ms"], plain_ms=ev["plain_ms"],
                       bound_ms=ev["bound_ms"], bound_by=ev["bound_by"], library_ms=lib_ms,
                       graph_ms=ev["graph_ms"], design_floor_ms=ev["design_floor_ms"],
                       peak_bytes=ev["peak_bytes"])
    rows["k1l_runs"] = runs


# ------------------------------------------------------- K2 / K3 ---

def _bf16(gen, shape, std, dev):
    return (torch.randn(shape, generator=gen) * std).to(dev, torch.bfloat16)


def _conv_w(gen, kh, kw, cin, cout, dev):
    """HWIO bf16 weight with unit-gain fan-in scaling."""
    return _bf16(gen, (kh, kw, cin, cout), 1.0 / math.sqrt(kh * kw * cin), dev)


def _close(name, got, want):
    if got.shape != want.shape or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    scale = max(want.float().abs().max().item(), 1.0)
    if err > CONV_REL_TOL * scale:
        raise AssertionError(f"{name}: max abs err {err} > {CONV_REL_TOL} x {scale}")
    return err


def _cudnn_conv_silu(x, w, b, stride, pad):
    """The yardstick: one cuDNN bf16 conv + SiLU on NCHW channels_last
    views of the same NHWC tensors (pad = top, bottom, left, right)."""
    t, bo, l, r = pad
    xn = x.permute(0, 3, 1, 2)
    if t != bo or l != r:
        xn, t, l = torch.nn.functional.pad(xn, (l, r, t, bo)), 0, 0
    y = torch.nn.functional.conv2d(xn, w.permute(3, 2, 0, 1), b, stride, (t, l))
    return torch.nn.functional.silu(y).permute(0, 2, 3, 1)


@contextlib.contextmanager
def recorded_launches(errs=None):
    """Inside: each conv_silu.launch also appends its (args, kwargs) to the
    list yielded, so that the launches timed alone are the path's own.
    With a list `errs`, each launch is also held against the plain version
    on its own slices as soon as it has run (before a later launch may
    write over its input), its max abs error appended to `errs`."""
    real, calls = conv_silu.launch, []

    def record(*args, **kw):
        calls.append((args, kw))
        real(*args, **kw)
        if errs is not None:
            torch.cuda.synchronize()
            st = launch_stage((args, kw))
            errs.append(_close(f"conv_silu launch {len(calls)} {tuple(st.y.shape)}", st.y,
                               conv_silu.conv_silu_plain(st.x, st.w, st.b, st.stride,
                                                         st.pad)))

    conv_silu.launch = record
    try:
        yield calls
    finally:
        conv_silu.launch = real


def launch_stage(call):
    """The logical input and output slices, stride, pad (top, bottom, left,
    right; symmetric where that gives the same output), operations and
    bytes (each slice, weight and bias moved once) of a recorded launch."""
    (x, w, b, y), kw = call
    h, c, s, t, l = kw["h"], kw["c"], kw["stride"], kw["pad_t"], kw["pad_l"]
    r0, x0, y0 = kw.get("x_row0", 0), kw.get("x_coff", 0), kw.get("y_coff", 0)
    kh, kwd, _, co = w.shape
    bsz, oh, ow, _ = y.shape
    wid = x.shape[2]
    bo = t if (h + 2 * t - kh) // s + 1 == oh else (oh - 1) * s + kh - h - t
    r = l if (wid + 2 * l - kwd) // s + 1 == ow else (ow - 1) * s + kwd - wid - l
    xs, ys = x[:, r0:r0 + h, :, x0:x0 + c], y[..., y0:y0 + co]
    return SimpleNamespace(x=xs, w=w, b=b, y=ys, stride=s, pad=(t, bo, l, r),
                           ops=2 * bsz * oh * ow * co * kh * kwd * c,
                           nbytes=nbytes(w, b) + 2 * (xs.numel() + ys.numel()))


def check_launches(kid, names, calls):
    """Each recorded launch of K2 or K3 alone, at the tensors the path gave
    it: against the plain version, its time (CUDA-graph replay), achieved
    TFLOP/s and GB/s, its share of its own bound, and one cuDNN conv + SiLU
    on contiguous copies of the same slices. Returns one row a launch."""
    if len(calls) != len(names):
        raise AssertionError(f"{kid}: {len(calls)} conv_silu launches, want {len(names)}")
    out = []
    for name, (args, kwargs) in zip(names, calls):
        label, st = f"{kid} {name}", launch_stage((args, kwargs))
        conv_silu.launch(*args, **kwargs)
        torch.cuda.synchronize()
        err = _close(label, st.y, conv_silu.conv_silu_plain(st.x, st.w, st.b, st.stride,
                                                            st.pad))
        ms = graph_ms(lambda: conv_silu.launch(*args, **kwargs))
        xc = st.x.contiguous()
        lib_ms = graph_ms(lambda: _cudnn_conv_silu(xc, st.w, st.b, st.stride, st.pad))
        del xc
        b_ms, b_by = bound_ms(st.ops, PEAK_BF16, st.nbytes)
        kh, kw, c, co = st.w.shape
        m, k = st.y.shape[0] * st.y.shape[1] * st.y.shape[2], kh * kw * c
        log(f"stage {label:16s} (M, N, K, s) = ({m}, {co}, {k}, {st.stride}): "
            f"{ms:.4f} ms, {st.ops / ms / 1e9:.1f} TFLOP/s, {st.nbytes / ms / 1e6:.1f} "
            f"GB/s, {b_ms / ms:.1%} of its bound {b_ms:.4f} ms ({b_by}); cuDNN "
            f"{lib_ms:.4f} ms; max abs err {err:.3g}; tile {conv_silu.launch.tile}")
        out.append(dict(stage=label, m=m, n=co, k=k, stride=st.stride, ms=ms,
                        bound_ms=b_ms, bound_by=b_by, cudnn_ms=lib_ms, ops=st.ops,
                        tile=conv_silu.launch.tile))
    return out


def unchecked_stages(kid, names, calls):
    """The operations and staged bound of each recorded launch, not timed
    alone."""
    if len(calls) != len(names):
        raise AssertionError(f"{kid}: {len(calls)} conv_silu launches, want {len(names)}")
    return [{"ops": st.ops, "bound_ms": bound_ms(st.ops, PEAK_BF16, st.nbytes)[0]}
            for st in map(launch_stage, calls)]


def stages_total(kid, stages):
    log(f"stages {kid}: {len(stages)} launches, {sum(r['ms'] for r in stages):.3f} ms "
        f"alone (graph replay) against a staged floor of "
        f"{sum(r['bound_ms'] for r in stages):.4f} ms; cuDNN "
        f"{sum(r['cudnn_ms'] for r in stages):.3f} ms")


STEM_LAUNCHES = ("s1 k2", "s2 k3", "s3 k3/s2")
SPAN_LAUNCHES = ("x45", "c1", "c2", "c3", "c4", "out")   # x4 and x5 in one launch


def check_k2(dev, rows, side=IMG, batch=BATCH, key="K2", stages_alone=True):
    """K2 at its serving shape (a `side` px input: phase-folded maps of
    side / 2 rows) against its plain version, into rows[key]. `ms` and
    `library_ms` are one call between two events, as they have been since
    the port began; the CUDA-graph replay of the same call (no host launch
    cost) goes beside them. Then (stages_alone) each of its launches
    alone."""
    gen = torch.Generator().manual_seed(2)
    c1, cm, c2, hx, wid = 128, 64, 128, side // 2, side // 2
    p = {"wk2": _conv_w(gen, 2, 2, c1, cm, dev), "b1": _bf16(gen, (cm,), 0.1, dev),
         "ws2": _conv_w(gen, 3, 3, cm, cm, dev), "b2": _bf16(gen, (cm,), 0.1, dev),
         "ws3": _conv_w(gen, 3, 3, cm, c2, dev), "b3": _bf16(gen, (c2,), 0.1, dev)}
    x = _bf16(gen, (batch, hx + 2 * fused_stem._PAD, wid, c1), 1.0, dev)
    with recorded_launches() as calls:
        got = fused_stem.fused_stem(x, p)
    torch.cuda.synchronize()
    want = fused_stem.fused_stem_plain(x, p)
    err = _close(f"{key} fused_stem", got, want)
    ms = cuda_ms(lambda: fused_stem.fused_stem(x, p))
    g_ms = graph_ms(lambda: fused_stem.fused_stem(x, p))
    plain_ms = cuda_ms(lambda: fused_stem.fused_stem_plain(x, p), iters=5)
    xr = x[:, fused_stem._PAD:-fused_stem._PAD]

    def library():
        s1 = _cudnn_conv_silu(xr, p["wk2"], p["b1"], 1, (1, 0, 1, 0))
        s2 = _cudnn_conv_silu(s1, p["ws2"], p["b2"], 1, (1, 1, 1, 1))
        return _cudnn_conv_silu(s2, p["ws3"], p["b3"], 2, (1, 1, 1, 1))

    lib_ms, lib_g_ms = cuda_ms(library), graph_ms(library)
    stages = (check_launches(key, STEM_LAUNCHES, calls) if stages_alone
              else unchecked_stages(key, STEM_LAUNCHES, calls))
    del calls
    ops = sum(r["ops"] for r in stages)
    b_ms, b_by = bound_ms(ops, PEAK_BF16, nbytes(x, got, *p.values()))
    floor = sum(r["bound_ms"] for r in stages)
    log(f"{key} fused_stem x {tuple(x.shape)} -> {tuple(got.shape)}: max abs err "
        f"{err:.4g}; one call {ms:.3f} ms (graph replay {g_ms:.3f}), plain "
        f"{plain_ms:.3f} ms, cuDNN one call {lib_ms:.3f} ms (graph replay "
        f"{lib_g_ms:.3f}), bound {b_ms:.4f} ms ({b_by}, {ops / 1e9:.1f} GFLOP), "
        f"staged floor {floor:.4f} ms")
    rows[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=lib_ms, staged_floor_ms=floor,
                     graph_ms=g_ms, library_graph_ms=lib_g_ms)
    if stages_alone:
        stages_total(key, stages)
        rows["stages"] = stages


def span_params(gen, cin, ct, cc, cout, order, dev):
    """A span's params as `fused_elan.pack_span` lays them out (merged
    x4/x5 weight included)."""
    _, cat = fused_elan.concat_slots(order, ct, cc)
    return fused_elan.merge_x45({
        "w4": _conv_w(gen, 1, 1, cin, ct, dev), "b4": _bf16(gen, (ct,), 0.1, dev),
        "w5": _conv_w(gen, 1, 1, cin, ct, dev), "b5": _bf16(gen, (ct,), 0.1, dev),
        "wc0": _conv_w(gen, 3, 3, ct, cc, dev), "bc0": _bf16(gen, (cc,), 0.1, dev),
        "wc": torch.stack([_conv_w(gen, 3, 3, cc, cc, dev) for _ in range(3)]),
        "bc": _bf16(gen, (3, cc), 0.1, dev),
        "w11": _conv_w(gen, 1, 1, cat, cout, dev), "b11": _bf16(gen, (cout,), 0.1, dev)})


def check_k3(dev, rows, spans=SPANS, batch=BATCH, key="K3", stages_alone=True):
    """K3 on each span of `spans` (H, cin, ct, cc, cout, order) at its
    serving shape, timed as K2 is, and summed over the spans into
    rows[key]; then (stages_alone) each span's launches alone."""
    gen = torch.Generator().manual_seed(3)
    tot = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
               library_ms=0.0, staged_floor_ms=0.0, graph_ms=0.0,
               library_graph_ms=0.0)
    by = {"bytes": 0.0, "operations": 0.0}  # bound time of each kind
    stages = []
    for h, cin, ct, cc, cout, order in spans:
        p = span_params(gen, cin, ct, cc, cout, order, dev)
        x = _bf16(gen, (batch, h, h, cin), 1.0, dev)
        with recorded_launches() as calls:
            got = fused_elan.fused_elan(x, p, order)
        torch.cuda.synchronize()
        want = fused_elan.fused_elan_plain(x, p, order)
        err = _close(f"{key} fused_elan {order} {h}x{h}x{cin}", got, want)
        ms = cuda_ms(lambda: fused_elan.fused_elan(x, p, order))
        g_ms = graph_ms(lambda: fused_elan.fused_elan(x, p, order))
        plain_ms = cuda_ms(lambda: fused_elan.fused_elan_plain(x, p, order), iters=5)
        slots, _ = fused_elan.concat_slots(order, ct, cc)

        def library():
            same = (1, 1, 1, 1)
            t = {"x4": _cudnn_conv_silu(x, p["w4"], p["b4"], 1, (0, 0, 0, 0)),
                 "x5": _cudnn_conv_silu(x, p["w5"], p["b5"], 1, (0, 0, 0, 0))}
            t["c1"] = _cudnn_conv_silu(t["x5"], p["wc0"], p["bc0"], 1, same)
            for j, (a, b) in enumerate((("c1", "c2"), ("c2", "c3"), ("c3", "c4"))):
                t[b] = _cudnn_conv_silu(t[a], p["wc"][j], p["bc"][j], 1, same)
            cat = torch.cat([t[n] for n in slots], dim=-1)
            return _cudnn_conv_silu(cat, p["w11"], p["b11"], 1, (0, 0, 0, 0))

        lib_ms, lib_g_ms = cuda_ms(library), graph_ms(library)
        span = (check_launches(f"{key} {order[:4]}{h}", SPAN_LAUNCHES, calls)
                if stages_alone else unchecked_stages(key, SPAN_LAUNCHES, calls))
        del calls
        stages += span
        ops = sum(r["ops"] for r in span)
        # the fused bound: the span's input, weights and output only (the
        # merged w45/b45 repeat w4/w5, b4/b5)
        nb = nbytes(x, got, *(v for k, v in p.items() if k not in ("w45", "b45")))
        b_ms, b_by = bound_ms(ops, PEAK_BF16, nb)
        floor = sum(r["bound_ms"] for r in span)
        log(f"{key} fused_elan {order:8s} x {tuple(x.shape)} -> {tuple(got.shape)}: "
            f"max abs err {err:.4g}; one call {ms:.3f} ms (graph replay {g_ms:.3f}), "
            f"plain {plain_ms:.3f} ms, cuDNN one call {lib_ms:.3f} ms (graph replay "
            f"{lib_g_ms:.3f}), bound {b_ms:.4f} ms ({b_by}, {ops / 1e9:.1f} GFLOP), "
            f"staged floor {floor:.4f} ms")
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        for name, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                        ("bound_ms", b_ms), ("staged_floor_ms", floor),
                        ("graph_ms", g_ms), ("library_graph_ms", lib_g_ms)):
            tot[name] += v
        by[b_by] += b_ms
        if not stages_alone:
            rows.setdefault(f"{key}_spans", []).append(dict(
                h=h, cin=cin, ct=ct, cc=cc, cout=cout, order=order, max_abs_err=err, ms=ms,
                graph_ms=g_ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_graph_ms=lib_g_ms, bound_ms=b_ms, bound_by=b_by,
                staged_floor_ms=floor))
        del x, got, want, p
    # the spans run one after another: their bounds add up
    log(f"{key} all {len(spans)} spans (one batch-{batch} forward): one call each "
        f"{tot['ms']:.3f} ms "
        f"(graph replay {tot['graph_ms']:.3f}), plain {tot['plain_ms']:.3f} ms, cuDNN "
        f"one call each {tot['library_ms']:.3f} ms (graph replay "
        f"{tot['library_graph_ms']:.3f}), bound {tot['bound_ms']:.4f} ms, staged floor "
        f"{tot['staged_floor_ms']:.4f} ms")
    rows[key] = dict(tot, bound_by=max(by, key=by.get))
    if stages_alone:
        stages_total(key, stages)
        rows["stages"] += stages


# ------------------------------------------------------- K4 / K4b ---

def k4_shapes(plan, batch, img):
    """(M, K, N) of the K4 launches of one forward of `plan` (the fused
    deploy plan) at `batch` x `img` px: every conv that
    `quant.pallas_1x1_eligible` passes (the convs `quantize_model(mixed=
    True)` quantizes), at its layer's resolution."""
    def convs(block):
        if isinstance(block, (L.ConvBnAct, L.RepConv, L.PlainConv)):
            return [block]
        if isinstance(block, L.Composite):
            return [c for child in block.children().values() for c in convs(child)]
        return []

    out = []
    for spec in plan.layers:
        if spec.is_head:
            continue
        side = int(img / spec.stride)
        out += [(batch * side * side, blk.c1, blk.c2)
                for blk in convs(spec.block) * spec.n_seq
                if quant.pallas_1x1_eligible(blk)]
    return out


def _int8(gen, shape, dev):
    return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(dev)


def check_k4(dev, rows, plan):
    """K4 at every (M, K, N) of one batch-8, 640 px forward: equal to the
    plain version; times summed over the forward, and one row a conv."""
    gen = torch.Generator().manual_seed(4)
    shapes = k4_shapes(plan, BATCH, IMG)
    tot = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    convs = []
    by = {"bytes": 0.0, "operations": 0.0}
    ops_all = bytes_all = 0
    for m, k, n in shapes:
        xq = _int8(gen, (m, k), dev)
        wq = _int8(gen, (n, k), dev).t()        # (K, N) column-major, as OIHW
        scale = (torch.rand(n, generator=gen) * 1e-2 + 1e-4).to(dev)
        bias = torch.randn(n, generator=gen).to(dev)
        got = int8_mm.int8_matmul_dequant(xq, wq, scale, bias)
        torch.cuda.synchronize()
        want = int8_mm.int8_matmul_dequant_plain(xq, wq, scale, bias)
        if not torch.equal(got, want):
            diff = int((got != want).sum())
            raise AssertionError(f"K4 ({m}, {k}, {n}): {diff} outputs differ from plain")
        tot["max_abs_err"] = max(tot["max_abs_err"], (got - want).abs().max().item())
        tile = int8_mm.int8_matmul_dequant.tile
        ms = graph_ms(lambda: int8_mm.int8_matmul_dequant(xq, wq, scale, bias))
        plain_ms = graph_ms(lambda: int8_mm.int8_matmul_dequant_plain(xq, wq, scale, bias),
                            reps=2, iters=3)
        lib_ms = graph_ms(lambda: torch._int_mm(xq, wq).float() * scale + bias)
        ops, nb = 2 * m * k * n, nbytes(xq, wq, scale, bias, got)
        b_ms, b_by = bound_ms(ops, PEAK_INT8, nb)
        log(f"K4 int8_matmul_dequant ({m}, {k}, {n}): equal to plain; {ms:.4f} ms, "
            f"{b_ms / ms:.1%} of its bound {b_ms:.4f} ms ({b_by}), tile {tile}; plain "
            f"{plain_ms:.3f} ms, _int_mm+dequant {lib_ms:.4f} ms")
        convs.append(dict(m=m, k=k, n=n, tile=tile, ms=ms, bound_ms=b_ms,
                          library_ms=lib_ms))
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                       ("bound_ms", b_ms)):
            tot[key] += v
        by[b_by] += b_ms
        ops_all += ops
        bytes_all += nb
    log(f"K4 all {len(shapes)} convs (one batch-{BATCH} forward, {ops_all / 1e9:.1f} G "
        f"int8 ops, {bytes_all / 1e9:.3f} GB): {tot['ms']:.3f} ms, plain "
        f"{tot['plain_ms']:.3f} ms, _int_mm+dequant {tot['library_ms']:.3f} ms, bound "
        f"{tot['bound_ms']:.4f} ms")
    rows["K4"] = dict(tot, bound_by=max(by, key=by.get))
    rows["k4_convs"] = convs


def check_k4b(dev, rows):
    """K4b, the bench template, at the bench's shapes: int8 -> int32 equal
    to the plain version, bf16 -> fp32 within BF16_MM_TOL; rates against
    torch._int_mm and bf16 torch.matmul. The row's numbers are the int8
    form's, summed over the shapes."""
    gen = torch.Generator().manual_seed(5)
    tot = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    by = {"bytes": 0.0, "operations": 0.0}
    for m, k, n in K4B_SHAPES:
        ops = 2 * m * k * n
        x, w = _int8(gen, (m, k), dev), _int8(gen, (n, k), dev).t()
        got = int8_mm.matmul(x, w, torch.int32)
        torch.cuda.synchronize()
        want = int8_mm.matmul_plain(x, w, torch.int32)
        if not torch.equal(got, want):
            raise AssertionError(f"K4b int8 ({m}, {k}, {n}) differs from plain")
        tot["max_abs_err"] = max(tot["max_abs_err"], float((got - want).abs().max()))
        tile = int8_mm.matmul.tile
        ms = graph_ms(lambda: int8_mm.matmul(x, w, torch.int32))
        plain_ms = graph_ms(lambda: int8_mm.matmul_plain(x, w, torch.int32), reps=2,
                            iters=3)
        lib_ms = graph_ms(lambda: torch._int_mm(x, w))
        b_ms, b_by = bound_ms(ops, PEAK_INT8, nbytes(x, w, got))
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                       ("bound_ms", b_ms)):
            tot[key] += v
        by[b_by] += b_ms

        xb = (torch.randn((m, k), generator=gen)).to(dev, torch.bfloat16)
        wb = (torch.randn((n, k), generator=gen) / math.sqrt(k)).to(dev, torch.bfloat16).t()
        gotb = int8_mm.matmul(xb, wb, torch.float32)
        torch.cuda.synchronize()
        wantb = int8_mm.matmul_plain(xb, wb, torch.float32)
        errb = (gotb - wantb).abs()
        limit = k * BF16_MM_TOL * (xb.float().abs() @ wb.float().abs())
        if not bool((errb <= limit).all()):
            raise AssertionError(f"K4b bf16 ({m}, {k}, {n}): max abs err "
                                 f"{errb.max().item()} beyond K * 2^-22 * sum|xw|")
        msb = graph_ms(lambda: int8_mm.matmul(xb, wb, torch.float32))
        libb = graph_ms(lambda: torch.matmul(xb, wb))
        log(f"K4b matmul ({m}, {k}, {n}) tile {tile}: int8 equal to plain, {ms:.4f} ms = "
            f"{ops / ms / 1e9:.1f} TOPS (_int_mm {lib_ms:.4f} ms = "
            f"{ops / lib_ms / 1e9:.1f} TOPS, plain {plain_ms:.3f} ms, bound "
            f"{b_ms:.4f} ms, {b_by}); bf16 max abs err {errb.max().item():.3g}, "
            f"{msb:.4f} ms = {ops / msb / 1e9:.1f} TFLOP/s (torch.matmul bf16 "
            f"{libb:.4f} ms = {ops / libb / 1e9:.1f} TFLOP/s)")
    rows["K4b"] = dict(tot, bound_by=max(by, key=by.get))


# --------------------------------------------------------- serving ---

def _bn_leaves(tree):
    """Every BN param dict ({scale, bias}) in a param tree."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias"}:
            return [tree]
        return [b for v in tree.values() for b in _bn_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [b for v in tree for b in _bn_leaves(v)]
    return []


@torch.no_grad()
def settle_bn(plan, params, state, x):
    """Set every BN's running mean and variance to its input's moments on
    the images x (a training forward with BN momentum 1): then the
    evaluation forward on such images equals the training forward, as in a
    trained network, and a training step moves the BN state by a little,
    not from the init's (0, 1) to the batch's moments."""
    momentum = L.BN_MOMENTUM
    L.BN_MOMENTUM = 1.0
    try:
        _, new = apply_model(plan, params, state, x.float(), training=True,
                             dtype=torch.float32)
    finally:
        L.BN_MOMENTUM = momentum
    for a, b in zip(tree_leaves(state), tree_leaves(new)):
        a.copy_(b)


@torch.no_grad()
def liven(plan, params, state, x, *, act_rms=0.1, head_gain=20.0,
          candidates=300, conf_thres=0.25):
    """Edit a random-init unfused param tree in place so it detects, and
    detects what is in the image. Random init fades the activations through
    the ~100 layers (each conv shrinks them ~sqrt(3)x), so the head sees
    nearly the same input for every image, and the Detect bias prior puts
    objectness near -6.7, where nothing passes conf_thres.

    Layer by layer on the (B, H, W, 3) images x (fp32), each layer's BN
    biases are zeroed and its BN gains scaled until its output has RMS
    act_rms. At 0.1 SiLU works near its linear range, where the random
    network does not amplify rounding noise: at RMS 1 it does, and two
    bf16 paths of equal merit land 3% and 8% (RMS) from the fp32 head
    inputs. The head's weights are multiplied by head_gain, its class
    biases zeroed, and one objectness bias chosen by bisection so that
    about `candidates` anchors per image pass conf_thres. act_rms=None
    leaves the BN layers as they are (`settle_bn` has set them)."""
    ctx = L.Ctx(torch.float32)
    lp, ls = params["layers"], state["layers"]
    saved = {}
    y = x.float().permute(0, 3, 1, 2)
    for idx, spec in enumerate(plan.layers):
        if isinstance(spec.frm, tuple):
            inp = [y if j == -1 else saved[j] for j in spec.frm]
        else:
            inp = y if spec.frm == -1 else saved[spec.frm]
        if spec.is_head:
            break
        bns = _bn_leaves(lp[idx]) if act_rms is not None else []
        for bn in bns:
            bn["bias"].zero_()
        for _ in range(12):
            out, _ = _run_layer(ctx, spec, lp[idx], ls[idx], inp)
            rms = out.square().mean().sqrt().item()
            if not bns or abs(rms / act_rms - 1.0) < 0.05:
                break
            # a chain of n BN'd convs scales ~ f^n: damp by the BN count
            f = (act_rms / rms) ** (1.0 / len(bns))
            for bn in bns:
                bn["scale"].mul_(f)
        y = out
        if idx in plan.save:
            saved[idx] = y
    head = plan.head
    if isinstance(head, H.IKeypoint):
        return _liven_kpt_head(head, lp[-1], inp, head_gain, candidates, conf_thres)
    # the objectness channel: IBin's follows its w and h bins
    oi = 4 if not isinstance(head, H.IBin) else 2 * (head.bin_count + 1) + 2
    obj, cls = [], []
    for i, m in enumerate(lp[-1]["m"]):
        m["w"].mul_(head_gain)
        b = m["b"].view(head.na, head.no)
        b[:, oi:] = 0.0
        r, _ = head._convs()[i].apply(m, {}, inp[i], ctx)
        r = r.permute(0, 2, 3, 1).reshape(r.shape[0], -1, head.no)
        obj.append(r[..., oi])
        cls.append(r[..., oi + 1:].max(-1).values)
    lo = _obj_bias(torch.cat(obj, 1), torch.sigmoid(torch.cat(cls, 1)), candidates, conf_thres)
    for m in lp[-1]["m"]:
        m["b"].view(head.na, head.no)[:, oi] = lo
    return lo


def _obj_bias(obj, cls, candidates, conf_thres):
    """The objectness bias, by bisection, with which about `candidates`
    anchors an image pass conf_thres (obj: logits, cls: probabilities)."""
    lo, hi = -30.0, 30.0
    for _ in range(40):
        mid = (lo + hi) / 2
        n = ((torch.sigmoid(obj + mid) * cls) > conf_thres).sum(1).float().mean()
        lo, hi = (lo, mid) if n > candidates else (mid, hi)
    return lo


@torch.no_grad()
def _liven_kpt_head(head, hp, inp, head_gain, candidates, conf_thres):
    """`liven`'s head part for IKeypoint: its det and kpt convs' outputs
    are concatenated and read as (na, no), so anchor a's objectness and
    class are channels a no + 4 and a no + 5 of the concatenation, held by
    the det or the kpt convs' biases. The weights times head_gain, the
    biases zeroed, and one objectness bias for every anchor by bisection."""
    for kind in ("m", "m_kpt"):
        for m in hp[kind]:
            m["w"].mul_(head_gain)
            m["b"].zero_()
    out, _ = head.apply(hp, {}, inp, L.Ctx(torch.float32, training=True))
    raw = torch.cat([r.reshape(r.shape[0], -1, head.no) for r in out["raw"]], 1)
    lo = _obj_bias(raw[..., 4], torch.sigmoid(raw[..., 5]), candidates, conf_thres)
    n_det = head.na * head.no_det
    for a in range(head.na):
        c = a * head.no + 4
        kind, c = ("m", c) if c < n_det else ("m_kpt", c - n_det)
        for m in hp[kind]:
            m["b"][c] = lo
    return lo


def match_fraction(a, b, iou_min=MATCH_IOU, score_tol=MATCH_SCORE):
    """Fraction of the detections of `a` (one image: (n, 4) boxes, (n,)
    scores and classes) with a detection of `b` of the same class, IoU >=
    iou_min and score within score_tol."""
    if len(a["scores"]) == 0:
        return 1.0 if len(b["scores"]) == 0 else 0.0
    if len(b["scores"]) == 0:
        return 0.0
    iou = box_iou(torch.tensor(a["boxes"]), torch.tensor(b["boxes"])).numpy()
    ok = ((iou >= iou_min) & (a["classes"][:, None] == b["classes"][None])
          & (np.abs(a["scores"][:, None] - b["scores"][None]) <= score_tol))
    return float(ok.any(1).mean())


def feature_error(got, want):
    """Largest relative RMS difference over the head's input levels."""
    return max(float((g.float() - w.float()).square().mean().sqrt()
                     / w.float().square().mean().sqrt()) for g, w in zip(got, want))


def image_rows(out, i):
    n = int(np.asarray(out["num_dets"]).reshape(len(out["num_dets"]), -1)[i, 0])
    return {"boxes": np.asarray(out["det_boxes"])[i, :n],
            "scores": np.asarray(out["det_scores"])[i, :n],
            "classes": np.asarray(out["det_classes"])[i, :n]}


def agreement(name, got, want):
    """Mean over images of the matched fraction of detections, the smaller
    of the two ways; raises on non-finite or missing output."""
    fracs = []
    for i in range(len(want["num_dets"])):
        a, b = image_rows(got, i), image_rows(want, i)
        for key in ("boxes", "scores"):
            if not np.isfinite(a[key]).all():
                raise AssertionError(f"{name} image {i}: non-finite {key}")
        if len(b["scores"]) == 0:
            raise AssertionError(f"{name} image {i}: the reference detects nothing")
        fracs.append(min(match_fraction(a, b), match_fraction(b, a)))
    return float(np.mean(fracs))


def cfg_name(cfg):
    """A cfg's name: a file's stem, a cfg dict's "name" entry (the graph
    compiler reads no such key)."""
    return cfg["name"] if isinstance(cfg, dict) else Path(cfg).stem


def make_model(dev, width=1.0, img=IMG, cfg=CFG, name=None):
    """The deploy form of `cfg` (yolov7 unless given) at `width` with random
    weights (torch.Generator seed 0), livened on two noise frames and
    re-parameterized. Returns a namespace with the fused plan, params and
    state, and the numpy generator that made the frames (phase 4 draws its
    images from it)."""
    model = Model.from_yaml(_cfg(width, cfg), seed=0, device=dev)
    rng = np.random.default_rng(0)
    calib = torch.from_numpy(rng.integers(0, 256, (2, img, img, 3), np.uint8))
    obj_bias = liven(model.plan, model.params, model.state,
                     calib.to(dev).float() / 255.0)
    params, state = fuse_model(model.plan, model.params, model.state)
    return SimpleNamespace(plan=model.plan, params=params, state=state, rng=rng,
                           n_params=model.num_params(), obj_bias=obj_bias,
                           width=width, img=img, dev=dev, name=name or cfg_name(cfg))


def make_reference(m):
    """The references on the same card: the untransformed fused plan through
    cuDNN with the plain keep-mask, in the working dtype and in fp32.
    Returns (normalized, reference): uint8 images -> the input in a dtype,
    and (images, dtype) -> (head inputs, numpy detections)."""
    dev = m.dev
    ref_params = {torch.float32: m.params, torch.bfloat16: tree_map(
        lambda t: t.to(torch.bfloat16) if t.dtype == torch.float32 else t, m.params)}

    def normalized(images, dtype=torch.bfloat16):
        return torch.from_numpy(images).to(dev).to(dtype) / 255.0

    @torch.inference_mode()
    def reference(images, dtype):
        p = ref_params[dtype]
        feats, _ = apply_model(m.plan, p, m.state, normalized(images, dtype), dtype=dtype,
                               return_head_inputs=True)
        with plain_nms():
            out = fused_head_nms(m.plan.head, p["layers"][-1], feats, conf_thres=0.25,
                                 iou_thres=0.45, max_det=100, max_nms=1024,
                                 compute_dtype=dtype)
        return feats, {"num_dets": out.num_dets[:, None].cpu().numpy(),
                       "det_boxes": out.boxes.cpu().numpy(),
                       "det_scores": out.scores.cpu().numpy(),
                       "det_classes": out.classes.cpu().numpy()}

    return normalized, reference


def zero_counts():
    for fn in COUNTED.values():
        fn.launches = 0
    conv_silu.launch.launches = 0


def read_counts():
    return {kid: fn.launches for kid, fn in COUNTED.items()}


def drive(engine, engine1, batches, lone, frames):
    """The main path: `infer` on each batch and on a partial one (the first
    call captures the engine's CUDA graph on the card), then lone and
    concurrent requests through a `DynamicBatcher` with the batch-1 engine
    (the batcher captures it). Returns (outs, partial, lone results,
    concurrent results)."""
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    outs = [engine.infer(b) for b in batches]
    partial = engine.infer(batches[0][:3])
    batcher = DynamicBatcher(engine, max_delay_ms=20, bs1_engine=engine1)
    lone_res = [DynamicBatcher.wait(batcher.submit(f), timeout=300) for f in lone]
    results = [None] * len(frames)

    def client(i):
        results[i] = DynamicBatcher.wait(batcher.submit(frames[i]), timeout=300)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(frames))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    batcher.close()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    if any(r is None for r in results + lone_res):
        raise AssertionError("a batcher request got no result")
    return outs, partial, lone_res, results


def check_path_counts(what, counts, engines, per_forward):
    """The counted main path of graph engines: each engine ran `end2end`
    eagerly once (its warm-up) and once under capture, and every forward
    after that was a replay. So each launch counter holds 2 x engines x its
    per-forward count, and replays == forwards. A replay does not pass
    through the wrappers: what the replays launch is read from a trace
    (`speed`). On the CPU (a rehearsal of this script) nothing launches and
    nothing is checked."""
    if engines[0].device.type != "cuda":
        return
    calls = 2 * len(engines)
    want = {kid: calls * per_forward.get(kid, 0) for kid in COUNTED}
    forwards = sum(e.batches for e in engines)
    replays = sum(e.replays for e in engines)
    log(f"{what}: {forwards} forwards, all CUDA-graph replays ({replays}); host "
        f"launch counts (eager warm-up + capture of {len(engines)} engines) {counts}")
    if counts != want:
        raise AssertionError(f"{what}: launch counts {counts}, want {want}")
    if replays != forwards or forwards == 0:
        raise AssertionError(f"{what}: {replays} replays for {forwards} forwards")


def graph_equals_eager(what, engine, outs, batches):
    """Each graph output of the main path equals the same engine's eager
    `end2end` on the same frames, bit for bit."""
    for j, (got, images) in enumerate(zip(outs, batches)):
        with torch.inference_mode():
            want = engine.to_host(engine.end2end(torch.from_numpy(images).to(engine.device)))
        for key in want:
            if not np.array_equal(got[key], want[key]):
                raise AssertionError(f"{what}: batch {j}: {key} differ between the "
                                     "CUDA graph and eager end2end")
    log(f"{what}: CUDA-graph output bit-equal to eager end2end on {len(outs)} batches")


def agreements(what, reference, outs, partial, lone_res, results, batches, lone,
               frames):
    """Mean detection agreement with the fp32 reference of the engine's
    outputs and of cuDNN bf16's, over the main path's image sets."""
    stacked = lambda rs: {k: np.stack([r[k] for r in rs]) for k in rs[0]}  # noqa: E731
    sets = [(f"infer batch {j}", outs[j], b) for j, b in enumerate(batches)]
    sets += [("partial batch", partial, batches[0][:3]),
             ("batcher", stacked(results), np.stack(frames)),
             ("bs1 path", stacked(lone_res), np.stack(lone))]
    agree_eng, agree_bf16 = [], []
    for name, got, images in sets:
        _, want = reference(images, torch.float32)
        _, cudnn = reference(images, torch.bfloat16)
        agree_eng.append(agreement(name, got, want))
        agree_bf16.append(agreement(name, cudnn, want))
        log(f"{what}: {name}: detections agree {agree_eng[-1]:.3f} with the "
            f"fp32 reference (cuDNN bf16 {agree_bf16[-1]:.3f}); "
            f"{int(got['num_dets'].sum())} / {int(want['num_dets'].sum())} detections")
    return float(np.mean(agree_eng)), float(np.mean(agree_bf16))


def speed(engine, engine1, batches, lone, what, traced):
    """img/s from `infer_async` (the frames' upload, the graph replay and
    the outputs' clones) between two events, the replay's device time
    alone, host-to-host `infer` p50 at the engine's batch and at batch 1,
    the host's time per `infer_async` and per eager `end2end` (no
    synchronise inside the window), and profiles of both. The graph's
    profile must count `traced` (kernel -> launches a forward) of the
    port's kernels in each replay, where the trace records device time."""
    batch = engine.batch_size
    xd = torch.from_numpy(batches[0]).to(engine.device)
    fwd_ms = cuda_ms(lambda: engine.infer_async(batches[0]), iters=20)
    replay_ms = cuda_ms(engine._graph.replay, iters=20)
    eager_ms = cuda_ms(lambda: engine.end2end(xd), iters=10)
    lat = []
    for _ in range(20):
        t = time.perf_counter()
        engine.infer(batches[1])
        lat.append((time.perf_counter() - t) * 1e3)
    lat1 = []
    for _ in range(20):
        t = time.perf_counter()
        engine1.infer(lone[0][None])
        lat1.append((time.perf_counter() - t) * 1e3)

    def host_ms(fn):
        # host clock around one call, no synchronise inside the window:
        # beside the device busy time it says whether the host or the card
        # paces the engine
        out = []
        for _ in range(20):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(out)

    res = dict(img_s=batch / fwd_ms * 1e3, device_ms_bs8=fwd_ms, replay_ms_bs8=replay_ms,
               eager_ms_bs8=eager_ms, p50_ms_bs8=statistics.median(lat),
               p50_ms_bs1=statistics.median(lat1),
               host_ms_infer_async=host_ms(lambda: engine.infer_async(batches[0])),
               enqueue_ms_bs8=host_ms(lambda: engine.end2end(xd)))
    log(f"{what}: {res['img_s']:.1f} img/s (one batch-{batch} infer_async {fwd_ms:.3f} ms "
        f"between events: upload, graph replay, output clones; the replay alone "
        f"{replay_ms:.3f} ms; eager end2end {eager_ms:.3f} ms); infer p50 host-to-host "
        f"batch {batch} {res['p50_ms_bs8']:.3f} ms, batch 1 {res['p50_ms_bs1']:.3f} ms; "
        f"host time of one infer_async {res['host_ms_infer_async']:.3f} ms, of one eager "
        f"end2end {res['enqueue_ms_bs8']:.3f} ms (medians of 20)")
    res.update(profile_forwards(lambda: engine.infer_async(batches[0]),
                                f"{what} (graph)"))
    got = res["profile"] and res["profile"]["launches"]
    want = {k: float(traced.get(k, 0)) for k in TRACED}
    if got is not None and got != want:
        raise AssertionError(f"{what}: a replay launched {got} in the trace, want {want}")
    res["profile_eager"] = profile_forwards(lambda: engine.end2end(xd),
                                            f"{what} (eager)")["profile"]
    return res


def plan_names(engine):
    names = [type(layer.block).__name__ for layer in engine.plan.layers]
    return names.count("FusedStem"), names.count("FusedELAN")


def serving(dev, m, batch=BATCH, requests=12, what="serving", transforms=(1, 8),
            with_ingest=True):
    """Phase 4 (and 9 (a) on w6): the bf16 graph engines. The plan must
    hold `transforms` = (FusedStem, FusedELAN) blocks. Returns the launch
    counts of the main-path run and the serving numbers."""
    img, rng = m.img, m.rng
    plan, params, state = m.plan, m.params, m.state
    engine = ServingEngine(plan, params, state, batch_size=batch, img_size=img,
                           dtype=torch.bfloat16, device=dev)
    engine1 = ServingEngine(plan, params, state, batch_size=1, img_size=img,
                            dtype=torch.bfloat16, device=dev)
    n_stem, n_elan = plan_names(engine)
    log(f"{what}: {m.name} deploy width {m.width}, {m.n_params} params, {img} px, "
        f"batch {batch}, bf16; objectness bias {m.obj_bias:.3f}; the plan has "
        f"{n_stem} FusedStem, {n_elan} FusedELAN")
    if (n_stem, n_elan) != tuple(transforms):
        raise AssertionError(f"transforms did not engage: {n_stem} stems, {n_elan} spans")
    conv_a_forward = 3 * n_stem + 6 * n_elan
    normalized, reference = make_reference(m)

    batches = [rng.integers(0, 256, (batch, img, img, 3), np.uint8) for _ in range(3)]
    lone = [rng.integers(0, 256, (img, img, 3), np.uint8) for _ in range(2)]
    frames = [f for f in rng.integers(0, 256, (requests, img, img, 3), np.uint8)]

    # ---- the main path, counted: captures, then replays ----
    zero_counts()
    outs, partial, lone_res, results = drive(engine, engine1, batches, lone, frames)
    counts = read_counts()
    per_forward = {"K1": 1, "K2": n_stem, "K3": n_elan}
    check_path_counts(what, counts, (engine, engine1), per_forward)
    # device launches of the conv + SiLU kernel: 3 per stem, 6 per span
    conv_launches = conv_silu.launch.launches
    log(f"{what}: {conv_launches} conv_silu launches at the warm-up and capture calls "
        f"(3 per stem + 6 per span = {conv_a_forward} a forward)")
    if dev.type == "cuda" and conv_launches != conv_a_forward * 4:
        raise AssertionError(f"{conv_launches} conv_silu launches, want {conv_a_forward * 4}")
    graph_equals_eager(what, engine, outs, batches)
    graph_equals_eager(f"{what} bs1", engine1, [engine1.infer(lone[0][None])],
                       [lone[0][None]])

    # ---- the output against the references ----
    with torch.inference_mode():
        feats, _ = apply_model(engine.plan, engine._params, engine._state,
                               normalized(batches[0]), dtype=torch.bfloat16,
                               return_head_inputs=True)
        f32, _ = reference(batches[0], torch.float32)
        f16, _ = reference(batches[0], torch.bfloat16)
        nms_kw = dict(conf_thres=0.25, iou_thres=0.45, max_det=100, max_nms=1024,
                      compute_dtype=torch.bfloat16)
        hp = engine._params["layers"][-1]
        with_kernel = fused_head_nms(engine.plan.head, hp, feats, **nms_kw)
        with plain_nms():
            with_plain = fused_head_nms(engine.plan.head, hp, feats, **nms_kw)
    for a, b, field in zip(with_kernel, with_plain, with_plain._fields):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: NMS tail: {field} differ between the keep-mask "
                                 "kernel and the plain keep-mask")
    err_eng, err_bf16 = feature_error(feats, f32), feature_error(f16, f32)
    log(f"{what}: NMS tail equal with the kernel and the plain keep-mask "
        f"({int(with_plain.num_dets.sum())} detections); head inputs "
        f"{err_eng:.4f} relative RMS from the fp32 reference (cuDNN bf16 "
        f"{err_bf16:.4f})")
    if not err_eng <= FEAT_RATIO * err_bf16:
        raise AssertionError(f"head inputs: {err_eng} relative RMS from the fp32 "
                             f"reference, cuDNN bf16 {err_bf16}")

    agree_eng, agree_bf16 = agreements(what, reference, outs, partial, lone_res,
                                       results, batches, lone, frames)
    if not agree_eng >= agree_bf16 - MATCH_MARGIN:
        raise AssertionError(f"detections agree with the fp32 reference {agree_eng:.3f}, "
                             f"cuDNN bf16's {agree_bf16:.3f}")

    # ---- speed ----
    res = {"launches": counts, "replays": engine.replays + engine1.replays,
           "agreement": agree_eng,
           "agreement_cudnn_bf16": agree_bf16, "feature_rms_err": err_eng,
           "feature_rms_err_cudnn_bf16": err_bf16}
    if dev.type == "cuda":
        res.update(speed(engine, engine1, batches, lone, what,
                         {"nms_keep_kernel": 1, "conv_silu_kernel": conv_a_forward}))
    if with_ingest:
        res["ingest"] = ingest(dev, m, engine, reference)
    return res


def ingest(dev, m, engine, reference):
    """An engine that takes raw frames of twice the letterbox's scale
    ((B, 720, 1280, 3) at 640 px; `ingest_hw`): its
    device letterbox within 1 of the host letterbox on every pixel (the
    stated tolerance: bilinear sums in another order round the other way
    near .5), its detections bit-equal to the plain engine's on the same
    letterboxed pixels scaled back to the frame with the same operations,
    and their agreement with the plain engine on the host's letterbox at
    least cuDNN bf16's agreement with fp32 on those frames less
    MATCH_MARGIN: a one-level change of a few pixels should move the
    detections no more than bf16 rounding does."""
    batch, hw = engine.batch_size, (m.img * 9 // 8, m.img * 2)
    eng = ServingEngine(m.plan, m.params, m.state, batch_size=batch, img_size=m.img,
                        dtype=torch.bfloat16, ingest_hw=hw, device=dev)
    # noise at the letterboxed scale, upscaled x2 and jittered by a few
    # levels: the network sees the statistics it was livened on (plain
    # 720p noise averages to flat grey, where it detects nothing), and the
    # bilinear average still has ties to round
    rng = np.random.default_rng(5)
    small = rng.integers(0, 256, (batch, hw[0] // 2, hw[1] // 2, 3)).repeat(2, 1).repeat(2, 2)
    frames = np.clip(small + rng.integers(-3, 4, small.shape), 0, 255).astype(np.uint8)
    zero_counts()
    got = eng.infer(frames)
    counts = read_counts()
    check_path_counts(f"ingest {hw}", counts, (eng,), {"K1": 1, "K2": 1, "K3": 8})
    with torch.inference_mode():
        dev_lb = eng._letterbox(torch.from_numpy(frames).to(dev)).cpu().numpy()
    host_lb = np.stack([letterbox(f, m.img, auto=False)[0] for f in frames])
    diff = np.abs(dev_lb.astype(int) - host_lb.astype(int))
    log(f"ingest {hw}: device letterbox against the host's: max |diff| {diff.max()}, "
        f"{(diff > 0).mean():.3%} of pixels differ")
    if diff.max() > 1:
        raise AssertionError(f"ingest: device letterbox off the host's by {diff.max()}")
    ref = engine.infer(dev_lb)
    (dw, dh), r = eng._pad, eng._ratio
    b = torch.from_numpy(ref["det_boxes"]).to(dev)
    x1, y1, x2, y2 = ((b[..., i] - off) / r for i, off in enumerate((dw, dh, dw, dh)))
    back = torch.stack([x1.clamp(0.0, hw[1]), y1.clamp(0.0, hw[0]),
                        x2.clamp(0.0, hw[1]), y2.clamp(0.0, hw[0])], -1).cpu().numpy()
    if not (got["num_dets"] > 0).all():
        raise AssertionError(f"ingest: detections per frame {got['num_dets'].ravel()}: "
                             "the check needs some on every frame")
    for key, want in (("num_dets", ref["num_dets"]), ("det_scores", ref["det_scores"]),
                      ("det_classes", ref["det_classes"]), ("det_boxes", back)):
        if not np.array_equal(got[key], want):
            raise AssertionError(f"ingest: {key} differ from the plain engine on the "
                                 "same letterboxed pixels")
    # the rescale against the host's (`scale_coords_np`, as detect runs it)
    ratio_pad = ((r, r), (dw, dh))
    box_err = max(float(np.abs(scale_coords_np((m.img, m.img), bx[:n], hw, ratio_pad)
                               - gb[:n]).max())
                  for bx, gb, n in zip(ref["det_boxes"], got["det_boxes"],
                                       got["num_dets"].ravel()))
    if not box_err <= RESCALE_TOL:
        raise AssertionError(f"ingest: boxes {box_err} px from the host's rescale")
    # the letterbox's effect, in letterboxed pixels (boxes clipped to the
    # frame from the padding are degenerate and match nothing)
    agree = agreement("ingest vs host letterbox", ref, engine.infer(host_lb))
    _, want32 = reference(host_lb, torch.float32)
    _, cudnn = reference(host_lb, torch.bfloat16)
    agree_min = agreement("ingest cuDNN bf16", cudnn, want32) - MATCH_MARGIN
    log(f"ingest {hw}: detections bit-equal to the plain engine on the device-"
        f"letterboxed pixels, scaled back ({int(got['num_dets'].sum())} detections), "
        f"{box_err:.2e} px from the host's rescale; agreement {agree:.3f} with the "
        f"plain engine on the host's letterbox (limit: cuDNN bf16's with fp32 on it "
        f"less {MATCH_MARGIN}, {agree_min:.3f})")
    if not agree >= agree_min:
        raise AssertionError(f"ingest: agreement {agree:.3f} with the host letterbox's "
                             f"detections, limit {agree_min:.3f}")
    return {"launches": counts, "max_pixel_diff": int(diff.max()),
            "pixel_diff_share": float((diff > 0).mean()), "rescale_err_px": box_err,
            "agreement_host_letterbox": agree, "agreement_min": agree_min}


@contextlib.contextmanager
def plain_k4():
    """Inside: every K4 call runs the plain version, on the card too (the
    reference run of the bit-equality checks; it counts no launch)."""
    kernel = int8_mm.int8_matmul_dequant
    int8_mm.int8_matmul_dequant = int8_mm.int8_matmul_dequant_plain
    try:
        yield
    finally:
        int8_mm.int8_matmul_dequant = kernel


def _count_wq(tree):
    if isinstance(tree, dict):
        return ("wq" in tree) + sum(_count_wq(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_count_wq(v) for v in tree)
    return 0


def same_as_plain_k4(name, engine, normalized, images):
    """Head inputs and detections of `engine` on `images`: with K4 (the
    detections from the engine's CUDA graph) and with the plain K4 (eager,
    under `plain_k4`): they must be bit-equal. Returns the head inputs."""
    runs = []
    x = torch.from_numpy(images).to(engine.device)
    for plain in (False, True):
        with plain_k4() if plain else contextlib.nullcontext(), torch.inference_mode():
            feats, _ = apply_model(engine.plan, engine._params, engine._state,
                                   normalized(images), dtype=torch.bfloat16,
                                   return_head_inputs=True)
            dets = (engine.to_host(engine.end2end(x)) if plain
                    else engine.infer(images))
            runs.append((feats, dets))
    (fk, dk), (fp, dp) = runs
    for lvl, (a, b) in enumerate(zip(fk, fp)):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: head input {lvl} differs between K4 and "
                                 "the plain K4")
    for key in dp:
        if not np.array_equal(dk[key], dp[key]):
            raise AssertionError(f"{name}: {key} differ between K4 and the plain K4")
    log(f"{name}: head inputs and detections bit-equal with K4 (graph) and with the "
        f"plain K4 (eager) ({int(dp['num_dets'].sum())} detections)")
    return fk


def int8_serving(dev, m, batch=BATCH, requests=12):
    """Phase 4b: the mixed int8 graph engines (calibrated scales, the
    K4-eligible 1x1 convs quantized), as `tools/exp_int8_serve.py` builds
    them. Returns its launch counts and numbers."""
    img = m.img
    rng = np.random.default_rng(1)
    cal = [rng.uniform(0, 1, (2, img, img, 3)).astype(np.float32) for _ in range(2)]
    t = time.perf_counter()
    scales = quant.calibrate(m.plan, m.params, m.state, cal)
    cal_s = time.perf_counter() - t
    qp, qs = quant.quantize_model(m.plan, m.params, m.state, scales, mixed=True)
    n_k4 = len(k4_shapes(m.plan, 1, img))
    if _count_wq(qp) != n_k4:
        raise AssertionError(f"{_count_wq(qp)} quantized convs, want {n_k4}")
    engine = ServingEngine(m.plan, qp, qs, batch_size=batch, img_size=img,
                           dtype=torch.bfloat16, device=dev)
    engine1 = ServingEngine(m.plan, qp, qs, batch_size=1, img_size=img,
                            dtype=torch.bfloat16, device=dev)
    n_stem, n_elan = plan_names(engine)
    log(f"int8 serving: calibrated {len(scales)} conv inputs on 2 x 2 noise frames "
        f"in {cal_s:.1f} s; {n_k4} convs quantized (mixed); the plan has {n_stem} "
        f"FusedStem, {n_elan} FusedELAN")
    # a span fuses only while its 1x1 convs stay fp: at full width each has
    # a quantized one (at width 0.5 the 64-channel first span has none)
    if n_stem != 1 or (m.width == 1.0 and n_elan != 0):
        raise AssertionError(f"want the fused stem and, at full width, no fused span "
                             f"in mixed int8; got {n_stem} stems, {n_elan} spans")
    normalized, reference = make_reference(m)

    batches = [rng.integers(0, 256, (batch, img, img, 3), np.uint8) for _ in range(3)]
    lone = [rng.integers(0, 256, (img, img, 3), np.uint8) for _ in range(2)]
    frames = [f for f in rng.integers(0, 256, (requests, img, img, 3), np.uint8)]

    # ---- the int8 main path, counted: captures, then replays ----
    zero_counts()
    outs, partial, lone_res, results = drive(engine, engine1, batches, lone, frames)
    counts = read_counts()
    per_forward = {"K1": 1, "K2": 1, "K3": n_elan, "K4": n_k4}
    check_path_counts("int8 serving", counts, (engine, engine1), per_forward)
    want_conv = (3 + 6 * n_elan) * 4
    if dev.type == "cuda" and conv_silu.launch.launches != want_conv:
        raise AssertionError(f"int8: {conv_silu.launch.launches} conv_silu launches, "
                             f"want {want_conv}")
    graph_equals_eager("int8 serving", engine, outs, batches)

    # ---- K4 against its plain version on the whole path; the error ----
    feats = same_as_plain_k4("int8 serving", engine, normalized, batches[0])
    f32, _ = reference(batches[0], torch.float32)
    f16, _ = reference(batches[0], torch.bfloat16)
    err_int8, err_bf16 = feature_error(feats, f32), feature_error(f16, f32)
    log(f"int8 serving: head inputs {err_int8:.4f} relative RMS from the fp32 "
        f"reference (cuDNN bf16 {err_bf16:.4f}); limit {INT8_FEAT_MAX}")
    if not err_int8 <= INT8_FEAT_MAX:
        raise AssertionError(f"int8 head inputs {err_int8} relative RMS from the fp32 "
                             f"reference > {INT8_FEAT_MAX}")
    agree_int8, agree_bf16 = agreements("int8 serving", reference, outs, partial,
                                        lone_res, results, batches, lone, frames)
    log(f"int8 serving: detections agree {agree_int8:.3f} with the fp32 reference "
        f"(cuDNN bf16 {agree_bf16:.3f})")

    res = {"launches": counts, "replays": engine.replays + engine1.replays,
           "agreement": agree_int8,
           "agreement_cudnn_bf16": agree_bf16, "feature_rms_err": err_int8,
           "feature_rms_err_cudnn_bf16": err_bf16, "calibrate_s": cal_s}
    if dev.type == "cuda":
        res.update(speed(engine, engine1, batches, lone, "int8 serving",
                         {"nms_keep_kernel": 1, "conv_silu_kernel": 3 + 6 * n_elan,
                          "int8_mm_kernel": n_k4}))
    return res


def full_int8(dev, m, batch=2):
    """Full int8 (every conv but the head's, dynamic activation scales), as
    `tools/serve_http.py --int8` builds it: one counted forward through a
    batch-`batch` graph engine (warm-up + capture, then a replay),
    bit-equal with the plain K4."""
    qp, qs = quant.quantize_model(m.plan, m.params, m.state)
    engine = ServingEngine(m.plan, qp, qs, batch_size=batch, img_size=m.img,
                           dtype=torch.bfloat16, device=dev)
    normalized, reference = make_reference(m)
    images = np.random.default_rng(2).integers(0, 256, (batch, m.img, m.img, 3), np.uint8)
    zero_counts()
    out = engine.infer(images)
    counts = read_counts()
    n_k4 = len(k4_shapes(m.plan, 1, m.img))
    log(f"full int8: {_count_wq(qp)} convs quantized (dynamic scales), plan "
        f"{plan_names(engine)} (FusedStem, FusedELAN); one batch-{batch} forward: "
        f"{int(out['num_dets'].sum())} detections")
    check_path_counts("full int8", counts, (engine,), {"K1": 1, "K4": n_k4})
    feats = same_as_plain_k4("full int8", engine, normalized, images)
    f32, _ = reference(images, torch.float32)
    err = feature_error(feats, f32)
    log(f"full int8: head inputs {err:.4f} relative RMS from the fp32 reference; "
        f"limit {INT8_FEAT_MAX}")
    if not err <= INT8_FEAT_MAX:
        raise AssertionError(f"full int8 head inputs {err} relative RMS from the fp32 "
                             f"reference > {INT8_FEAT_MAX}")
    return {"launches": counts, "feature_rms_err": err}


def rows_out(dets, max_det=300):
    """Detector rows (list of (n, 6)) as the engine's output dict."""
    b = len(dets)
    out = {"num_dets": np.array([[len(d)] for d in dets]),
           "det_boxes": np.zeros((b, max_det, 4), np.float32),
           "det_scores": np.zeros((b, max_det), np.float32),
           "det_classes": np.zeros((b, max_det), np.int32)}
    for i, d in enumerate(dets):
        out["det_boxes"][i, :len(d)] = d[:, :4]
        out["det_scores"][i, :len(d)] = d[:, 4]
        out["det_classes"][i, :len(d)] = d[:, 5]
    return out


def noise_image(rng, hw, size=None):
    """A (h, w, 3) uint8 image whose letterbox to `size` (IMG) is noise as
    the network was livened on: noise drawn at the letterboxed scale,
    resized to (h, w) nearest and jittered by a few levels (noise drawn at
    720p averages to flat grey in the letterbox, where it detects
    nothing)."""
    import cv2

    h, w = hw
    r = min((size or IMG) / h, (size or IMG) / w)
    small = rng.integers(0, 256, (round(h * r), round(w * r), 3)).astype(np.uint8)
    img = cv2.resize(small, (w, h), interpolation=cv2.INTER_NEAREST).astype(int)
    return np.clip(img + rng.integers(-3, 4, img.shape), 0, 255).astype(np.uint8)


def detect_model(dev, width=1.0, cfg=TRAIN_CFG, img=IMG):
    """Phase 5's model and images: the training form of `cfg` at `width`,
    random weights (seed 1) livened and fused, and four BGR noise images of
    DATA_SHAPES. Returns (model, fused params, fused state, images)."""
    model = Model.from_yaml(_cfg(width, cfg), seed=1, device=dev)
    rng = np.random.default_rng(11)
    calib = torch.from_numpy(rng.integers(0, 256, (2, img, img, 3), np.uint8))
    liven(model.plan, model.params, model.state, calib.to(dev).float() / 255.0)
    params, state = fuse_model(model.plan, model.params, model.state)
    return model, params, state, [noise_image(rng, hw, img) for hw in DATA_SHAPES]


def detect(dev, width=1.0, cfg=TRAIN_CFG, img=IMG, transforms=(1, 8), what="detect"):
    """Phase 5 (and 9 (c) on w6): the training form of `cfg` (yolov7's,
    IDetect, unless given) at `width`, random weights (seed 1) livened and
    fused, through the bf16 Detector at `img` px (fast stem, and the fused
    stem and spans where they match: `transforms` = (FusedStem, FusedELAN)
    blocks) on four BGR images of different sizes. Counted: K1L once (4096
    candidates), K2 once a stem, K3 once a span; bit-equal to the same
    Detector with the plain keep-mask; agreement with an fp32 cuDNN
    Detector at least cuDNN bf16's less MATCH_MARGIN."""
    model, params, state, images = detect_model(dev, width, cfg, img)
    shapes = DATA_SHAPES
    det = Detector(model.plan, params, state, img_size=img, dtype=torch.bfloat16,
                   device=dev)
    n_stem, n_elan = plan_names(det)
    log(f"{what}: {cfg_name(cfg)} training form ({type(model.plan.head).__name__} head), "
        f"width {width}, {model.num_params()} params, fused; Detector bf16 at {img} px "
        f"with {n_stem} FusedStem, {n_elan} FusedELAN; images {shapes}")
    if dev.type == "cuda" and (n_stem, n_elan) != tuple(transforms):
        raise AssertionError(f"{what}: transforms did not engage: {n_stem}, {n_elan}")
    zero_counts()
    got = det(images)
    counts = read_counts()
    log(f"{what}: {sum(len(d) for d in got)} detections; launches {counts}")
    want = {kid: 0 for kid in COUNTED} | {"K1L": 1, "K2": n_stem, "K3": n_elan}
    if dev.type == "cuda" and counts != want:
        raise AssertionError(f"{what}: launch counts {counts}, want {want}")
    with plain_nms():
        plain = det(images)
        refs = {dt: Detector(model.plan, params, state, img_size=img, dtype=dt, device=dev,
                             fast_stem=False)(images)
                for dt in (torch.float32, torch.bfloat16)}
    for i, (a, b) in enumerate(zip(got, plain)):
        if not np.array_equal(a, b):
            raise AssertionError(f"{what} image {i}: detections differ between K1L and "
                                 "the plain keep-mask")
    want32 = rows_out(refs[torch.float32])
    agree = agreement(what, rows_out(got), want32)
    agree_bf16 = agreement(f"{what} cuDNN bf16", rows_out(refs[torch.bfloat16]), want32)
    log(f"{what}: detections bit-equal with K1L and with the plain keep-mask; agree "
        f"{agree:.3f} with the fp32 cuDNN Detector (cuDNN bf16 {agree_bf16:.3f})")
    if not agree >= agree_bf16 - MATCH_MARGIN:
        raise AssertionError(f"{what}: agreement {agree:.3f}, cuDNN bf16 {agree_bf16:.3f}")
    ms = cuda_ms(lambda: det(images), iters=5, warmup=1) if dev.type == "cuda" else None
    log(f"{what}: one call on {len(images)} images {ms} ms (host letterbox, "
        f"forward, NMS, rows to the host)")
    return {"launches": counts, "agreement": agree, "agreement_cudnn_bf16": agree_bf16,
            "detections": sum(len(d) for d in got), "ms": ms}


def eval_batches(m, batch=BATCH, n_images=16):
    """`n_images` uniform-noise images in rect batches of `batch`, half at
    img x img and half at 3/5 of the height (m.img = 640: 640 x 640 and
    384 x 640; 1280: 1280 x 1280 and 768 x 1280), in the loader's batch
    dicts, labelled with the model's own
    detections (conf 0.25 through the fp32 cuDNN path with the plain
    keep-mask) jittered by a few pixels, plus one box the model does not
    find an image (so map50 is neither 0 nor 1)."""
    rng = np.random.default_rng(13)
    img, gs = m.img, int(max(m.plan.strides))
    batches = []
    for bi, (h, w) in enumerate(((img, img), (img * 3 // 5 // gs * gs, img))):
        for _ in range(n_images // batch // 2):
            imgs = rng.integers(0, 256, (batch, h, w, 3), np.uint8)
            with torch.inference_mode(), plain_nms(), full_fp32():
                x = torch.from_numpy(imgs).to(m.dev).float() / 255.0
                out, _ = apply_model(m.plan, m.params, m.state, x, dtype=torch.float32)
                dets = batched_nms(out["pred"], max_det=20)
            labels = np.zeros((batch, 21, 5), np.float32)
            mask = np.zeros((batch, 21), bool)
            for si in range(batch):
                n = int(dets.num_dets[si])
                xyxy = dets.boxes[si, :n].cpu().numpy() + rng.normal(0, 3, (n, 4))
                xywh = np.concatenate([(xyxy[:, :2] + xyxy[:, 2:]) / 2,
                                       xyxy[:, 2:] - xyxy[:, :2]], 1) / [w, h, w, h]
                rows = np.concatenate([dets.classes[si, :n].cpu().numpy()[:, None], xywh], 1)
                rows = np.concatenate([rows, [[si % m.plan.nc, 0.5, 0.5, 0.2, 0.3]]])
                labels[si, :len(rows)] = rows
                mask[si, :len(rows)] = True
            batches.append({"images": imgs, "labels": labels, "label_mask": mask,
                            "shapes": [None] * batch,
                            "paths": [f"{bi}_{len(batches)}_{si}.jpg" for si in range(batch)]})
    return batches


@contextlib.contextmanager
def global_tf32(on: bool):
    """Inside: torch's global TF32 flag for cuDNN set to `on` (True is
    torch's default) and the matmul precision to "high" (TF32) or
    "highest"; restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = on
    torch.set_float32_matmul_precision("high" if on else "highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


@contextlib.contextmanager
def first_pred():
    """Inside: the `pred` of the first forward `evaluate` runs is appended
    (a clone) to the list this yields."""
    got, real = [], evaluator.apply_model

    def grab(*args, **kwargs):
        out = real(*args, **kwargs)
        if not got:
            got.append(out[0]["pred"].clone())
        return out

    evaluator.apply_model = grab
    try:
        yield got
    finally:
        evaluator.apply_model = real


# kernel-name groups of eval's NMS on the card: the stable sorts of the
# candidates, K1L, and everything else (scores, gathers, the packing)
NMS_GROUPS = (("sort", ("sort", "Sort", "radix", "Radix")),
              ("K1L", ("nms_mask_kernel", "nms_scan_kernel")))


def nms_split_ms(pred, n=3, **kw):
    """Device ms of one `batched_nms(pred, **kw)` call by kernel group
    (NMS_GROUPS, the rest as "packing"), torch.profiler over n calls; None
    on the CPU (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        return None
    call = lambda: batched_nms(pred, **kw)  # noqa: E731
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    out = {name: 0.0 for name, _ in NMS_GROUPS} | {"packing": 0.0}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
        if e.device_type != torch.autograd.DeviceType.CUDA or not us:
            continue
        group = next((name for name, keys in NMS_GROUPS if any(k in e.key for k in keys)),
                     "packing")
        out[group] += us / 1e3 / n
    return out


def evaluation(dev, m, batch=BATCH, n_images=16, what="eval"):
    """Phase 6 (and 9 (c) on w6): `evaluate` in fp32 over `eval_batches`
    (16 images, rect batches of 8). Counted: K1L once a batch (8192 candidates); map50 /
    map / mp / mr equal those of the same run with the plain keep-mask, and
    those of a run with the global TF32 flags at torch's defaults (on):
    `evaluate` pins full fp32 itself. Its first batch's fp32 pred is
    bit-equal in those two runs, and (on the card) the same forward without
    the pin under TF32 differs from it. Logged beside: one batch's fp32
    forward timed with TF32 on and off (what the pin costs), and the NMS ms
    of one batch split into the stable sort, K1L and the packing."""
    batches = eval_batches(m, batch, n_images)
    log(f"{what}: {n_images} images in {len(batches)} batches of {batch} "
        f"({[b['images'].shape[1:3] for b in batches]}), fp32, global cuDNN TF32 "
        f"{torch.backends.cudnn.allow_tf32}, matmul precision "
        f"{torch.get_float32_matmul_precision()}")
    zero_counts()
    with first_pred() as pred_off:
        got = evaluate(m.plan, m.params, m.state, batches, device=dev)
    counts = read_counts()
    want = {kid: 0 for kid in COUNTED} | {"K1L": len(batches)}
    if dev.type == "cuda" and counts != want:
        raise AssertionError(f"{what}: launch counts {counts}, want {want}")
    with plain_nms():
        plain = evaluate(m.plan, m.params, m.state, batches, device=dev)
    with global_tf32(True), first_pred() as pred_on:
        tf32 = evaluate(m.plan, m.params, m.state, batches, device=dev)
    log(f"{what}: map50 {got['map50']:.6f}, map {got['map']:.6f} (plain keep-mask "
        f"{plain['map50']:.6f}, {plain['map']:.6f}; global TF32 on {tf32['map50']:.6f}, "
        f"{tf32['map']:.6f}); per image: inference {got['speed_ms']['inference']:.3f} ms, "
        f"NMS {got['speed_ms']['nms']:.3f} ms (plain keep-mask NMS "
        f"{plain['speed_ms']['nms']:.3f} ms); launches {counts}")
    for key in ("map50", "map", "mp", "mr"):
        if got[key] != plain[key]:
            raise AssertionError(f"{what}: {key} {got[key]} with K1L, {plain[key]} with the "
                                 "plain keep-mask")
        if got[key] != tf32[key]:
            raise AssertionError(f"{what}: {key} {got[key]} with the global TF32 off, "
                                 f"{tf32[key]} with it on: the fp32 pin does not hold")
    if not 0.0 < got["map50"] < 1.0:
        raise AssertionError(f"{what}: map50 {got['map50']} is not a meaningful check")

    # the pin's cost, and where one batch's NMS goes
    with torch.inference_mode():
        x = torch.from_numpy(batches[0]["images"]).to(dev).float() / 255.0
        forward = lambda: apply_model(m.plan, m.params, m.state, x,  # noqa: E731
                                      dtype=torch.float32)
        fwd_ms = {}
        if dev.type == "cuda":
            for on in (True, False):
                with global_tf32(on):
                    fwd_ms["tf32_on" if on else "tf32_off"] = cuda_ms(forward, iters=10)
        pred = forward()[0]["pred"]
        # the pin at the forward's output: evaluate's first batch is
        # bit-equal with the global TF32 on and off; the control, the same
        # forward unpinned with TF32 on, is not (on the card)
        with global_tf32(True):
            unpinned = forward()[0]["pred"]
        tf32_err = float((unpinned - pred_off[0]).abs().max())
        if not torch.equal(pred_on[0], pred_off[0]):
            raise AssertionError(f"{what}: evaluate's fp32 pred differs with the global TF32 on: "
                                 "the fp32 pin does not hold")
        if dev.type == "cuda" and tf32_err == 0.0:
            raise AssertionError(f"{what}: the unpinned forward with TF32 on equals the pinned "
                                 "one: the pin check cannot fail")
        split = nms_split_ms(pred, conf_thres=0.001, iou_thres=0.65, multi_label=True,
                             max_nms=EVAL_NMS)
    per_image = None if split is None else {k: v / batch for k, v in split.items()}
    log(f"{what}: evaluate's fp32 pred of batch 0 bit-equal with the global TF32 on and off; "
        f"the unpinned forward with TF32 on differs by up to {tf32_err:.6g}")
    log(f"{what}: fp32 forward of one batch of {batch}: TF32 on {fwd_ms.get('tf32_on')} ms, "
        f"off (the pin) {fwd_ms.get('tf32_off')} ms; NMS device ms an image by group "
        f"{per_image}")
    return {"launches": counts, "map50": got["map50"], "map": got["map"],
            "speed_ms": got["speed_ms"], "plain_nms_ms": plain["speed_ms"]["nms"],
            "tf32_on_map50": tf32["map50"], "forward_ms_bs8": fwd_ms,
            "unpinned_tf32_pred_max_abs_err": tf32_err, "nms_ms_an_image": per_image}


# ------------------------------------------------------------ train ---

def train_batch(rng, batch, img, nc=80):
    """uint8 noise frames (batch, img, img, 3) and labels padded to
    MAX_LABELS rows, LABELS_AN_IMAGE boxes an image: random classes,
    centres in [0.1, 0.9], sides in [0.02, 0.4] of the image."""
    images = rng.integers(0, 256, (batch, img, img, 3), dtype=np.uint8)
    labels = np.zeros((batch, MAX_LABELS, 5), np.float32)
    mask = np.zeros((batch, MAX_LABELS), bool)
    for b in range(batch):
        k = int(rng.integers(LABELS_AN_IMAGE[0], LABELS_AN_IMAGE[1] + 1))
        labels[b, :k] = np.concatenate([rng.integers(0, nc, (k, 1)),
                                        rng.uniform(0.1, 0.9, (k, 2)),
                                        rng.uniform(0.02, 0.4, (k, 2))], 1)
        mask[b, :k] = True
    return images, labels, mask


def train_model(dev, width, seed=2, cfg=TRAIN_CFG):
    """The training form of `cfg` (yolov7's, IDetect, unless given) at
    `width`, the port's seeded init with the Detect bias prior, on `dev`."""
    return Model.from_yaml(_cfg(width, cfg), seed=seed, device=dev)


def lr_after_warmup(opt):
    """(lr_groups, momentum) of the first step past a 1000-step warmup, at
    epoch 0 of 300 (hyp.scratch.p5: lrf 0.1, warmup_bias_lr 0.1,
    warmup_momentum 0.8)."""
    return warmup_factors(1000, 1000, 0.0, 300, opt.lr0, 0.1, 0.1, 0.8, opt.momentum)


def tree_update(new, old):
    """One flat fp64 vector of new - old over all leaves (on the host)."""
    return torch.cat([(a.detach().double() - b.detach().double()).reshape(-1).cpu()
                      for a, b in zip(tree_leaves(new), tree_leaves(old))])


def tree_rel_l2(got, want):
    """|got - want| / |want| over all leaves of two trees (fp64, host)."""
    num = den = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        num += float((a - b).square().sum())
        den += float(b.square().sum())
    return (num / den) ** 0.5


def check_ota(dev, plan, raw, labels, mask):
    """(a) The OTA loss and assignment on the card against the CPU on the
    same fp32 raw maps and labels."""
    hyp = LossHyp()
    head = plan.head
    anchors = np.asarray(head.anchors, np.float32).reshape(head.nl, head.na, 2)
    strides = np.asarray(head.strides, np.float32)
    loss_fn = make_compute_loss_ota(head, hyp)
    out = {}
    for where in (dev, torch.device("cpu")):
        r = [t.to(where) for t in raw]
        lb, mk = labels.to(where), mask.to(where)
        total, items = loss_fn(r, lb, mk)
        fg, mg, _ = ota_assign_batch(r, lb, mk, anchors, strides, hyp, 0.5, 10)
        out[where.type] = ({k: float(v) for k, v in items.items()} | {"total": float(total)},
                           fg.cpu(), mg.cpu())
    (card, fg_c, mg_c), (cpu, fg_h, mg_h) = out[dev.type], out["cpu"]
    same = ((fg_c == fg_h) & (~fg_c | (mg_c == mg_h))).double().mean().item()
    err = max(abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-30) for k in cpu)
    log(f"train (a): OTA at {tuple(raw[0].shape[:1])} images, {labels.shape[1]} label rows, "
        f"{fg_c.shape[1]} candidate columns an image: items card {card}, CPU {cpu}, "
        f"largest relative difference {err:.3g} (limit {OTA_ITEM_RTOL}); columns with "
        f"the same (fg, matched_gt) {same:.6f} (limit {OTA_COLUMN_SHARE}); "
        f"fg {int(fg_c.sum())} card, {int(fg_h.sum())} CPU")
    if not same >= OTA_COLUMN_SHARE:
        raise AssertionError(f"train (a): OTA assignments agree on {same} of the columns")
    if not err <= OTA_ITEM_RTOL:
        raise AssertionError(f"train (a): OTA loss items differ by {err} relative")
    return {"items_card": card, "items_cpu": cpu, "item_rel_err": err, "same_columns": same,
            "fg": int(fg_c.sum())}


def check_fp32_step(dev, width=0.25, img=320, batch=2, cfg=TRAIN_CFG, hyp=None,
                    what="train (b)", update_l2=None, make_loss=make_compute_loss_ota):
    """(b) One fp32 step (OTA with `hyp`, `LossHyp()` unless given; SGD) of
    the training form of `cfg` on the card, TF32 off, against the same
    step on the CPU from the same state on the same batch (`make_loss`:
    the bin-OTA loss for an IBin cfg). The updates of
    the params within STEP_UPDATE_L2, the new BN stats and EMA trees within
    STEP_STATE_REL; with `update_l2` (a model whose step is discontinuous,
    TINY_UPDATE_L2), the updates of the params and of the EMA params
    within it instead, the BN stats and the EMA's within STEP_STATE_REL."""
    hyp = LossHyp() if hyp is None else hyp
    model = train_model(torch.device("cpu"), width, seed=3, cfg=cfg)
    opt = train_optim.OptimConfig()
    lr, mom = lr_after_warmup(opt)
    batch_np = train_batch(np.random.default_rng(5), batch, img)
    res = {}
    for where in (dev, torch.device("cpu")):
        ts = init_train_state(model.params, model.state, opt, device=where)
        step = make_train_step(model.plan, make_loss(model.plan.head, hyp), opt,
                               compute_dtype=torch.float32)
        with full_fp32(where.type == "cuda"):
            new, metrics = step(ts, *batch_np, lr, mom)
        res[where.type] = (ts, new, {k: float(v) for k, v in metrics.items()})
    (ts_c, new_c, m_c), (ts_h, new_h, m_h) = res[dev.type], res["cpu"]
    du_c, du_h = tree_update(new_c.params, ts_c.params), tree_update(new_h.params, ts_h.params)
    l2 = float((du_c - du_h).norm() / du_h.norm())
    state_err = tree_rel_l2(new_c.state, new_h.state)
    ema_err = max(tree_rel_l2(new_c.ema_params, new_h.ema_params),
                  tree_rel_l2(new_c.ema_state, new_h.ema_state))
    # the step's gradient before the params take it (the momentum slot,
    # zero before the step), and the update's fp32 resolution: half an ulp
    # of each new param over the update's norm
    v_l2 = tree_rel_l2(new_c.opt_state["v"], new_h.opt_state["v"])
    ulp = torch.cat([(torch.nextafter(t, torch.tensor(math.inf)) - t).reshape(-1)
                     for t in (x.detach().cpu().abs() for x in tree_leaves(new_h.params))])
    floor = float(ulp.double().norm() / 2 / du_h.norm())
    log(f"{what}: one fp32 step of {cfg_name(cfg)}, width {width}, {img} px, batch {batch}: "
        f"losses card {m_c}, CPU {m_h}; parameter updates' relative L2 distance {l2:.3g} "
        f"(limit {STEP_UPDATE_L2}; their fp32 resolution {floor:.3g}), the momentum slot's "
        f"{v_l2:.3g}; BN stats {state_err:.3g}, EMA {ema_err:.3g} (params "
        f"{tree_rel_l2(new_c.ema_params, new_h.ema_params):.3g}, state "
        f"{tree_rel_l2(new_c.ema_state, new_h.ema_state):.3g}; limit {STEP_STATE_REL})")
    if update_l2 is not None:
        ema_l2 = float((tree_update(new_c.ema_params, ts_c.ema_params)
                        - tree_update(new_h.ema_params, ts_h.ema_params)).norm()
                       / tree_update(new_h.ema_params, ts_h.ema_params).norm())
        ema_state = tree_rel_l2(new_c.ema_state, new_h.ema_state)
        log(f"{what}: the EMA params' updates {ema_l2:.3g} apart; updates held within "
            f"{update_l2}, BN stats and the EMA's within {STEP_STATE_REL}")
        if not max(l2, ema_l2) <= update_l2:
            raise AssertionError(f"{what}: fp32 updates differ by {l2}, the EMA's by {ema_l2}")
        if not max(state_err, ema_state) <= STEP_STATE_REL:
            raise AssertionError(f"{what}: BN stats {state_err}, EMA BN stats {ema_state}")
    elif not l2 <= STEP_UPDATE_L2:
        raise AssertionError(f"{what}: fp32 updates differ by {l2} (relative L2)")
    elif not max(state_err, ema_err) <= STEP_STATE_REL:
        raise AssertionError(f"{what}: BN stats {state_err}, EMA {ema_err}")
    return {"update_rel_l2": l2, "update_fp32_floor": floor, "momentum_rel_l2": v_l2,
            "bn_state_rel_err": state_err, "ema_rel_err": ema_err, "losses_card": m_c,
            "losses_cpu": m_h}


def step_timing(fn, batch, iters=5, warmup=1, host_reps=3):
    """A train step `fn` (the card only): ms a step (median of `iters`
    between CUDA events), img/s at `batch`, the peak allocation from there,
    and the host's ms a step (median of `host_reps` enqueues between
    synchronises)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(fn, iters=iters, warmup=warmup)
    peak = torch.cuda.max_memory_allocated()
    host = []
    for _ in range(host_reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return {"ms_step": ms, "img_s": batch / ms * 1e3, "host_ms_step": statistics.median(host),
            "peak_bytes": peak}


def step_profile(dev, plan, step, ts, batch_np, lr, mom, loss_fn, opt):
    """Device time of one bf16 step by part, from torch.profiler: the
    step's cuDNN convolution kernels (by name), the loss (OTA forward and
    backward on the step's raw maps) and the optimizer with the EMA, each
    profiled alone (`kernel_ms`), and BN and elementwise, the rest of the
    step's device time; the device's busy share of the profiled step's
    wall."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.from_numpy(batch_np[0]).to(dev).float() / 255.0
    labels, mask = (torch.from_numpy(a).to(dev) for a in batch_np[1:])
    with torch.no_grad():
        out, _ = apply_model(plan, ts.params, ts.state, x, training=True, dtype=torch.bfloat16)
    raw = [r.detach().requires_grad_() for r in out["raw"]]
    del out

    def loss_part():
        total, _ = loss_fn(raw, labels, mask)
        torch.autograd.grad(total, raw)

    _, update = train_optim.make_optimizer(opt, ts.params)
    grads = tree_map(torch.ones_like, ts.params)

    def optim_part():
        p, _ = update(ts.opt_state, ts.params, grads, lr, mom)
        ema_update(ts.ema_params, p, 1)
        ema_update(ts.ema_state, ts.state, 1)

    step(ts, *batch_np, lr, mom)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(ts, *batch_np, lr, mom)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if e.device_type == torch.autograd.DeviceType.CUDA and us:
            kernels.append((us / 1e3, e.key))
    if not kernels:
        log("train (e): profile: no device time recorded (not measured)")
        return None
    busy = sum(ms for ms, _ in kernels)
    conv = sum(ms for ms, name in kernels if any(k in name.lower() for k in CUDNN_NAMES))
    # "" is in every kernel's name: each part's whole device time
    loss, optim = (kernel_ms(part, ("",), n=2)[""] for part in (loss_part, optim_part))
    split = {"cudnn_conv_fwd_bwd": conv, "loss_ota": loss, "optimizer_ema": optim,
             "bn_elementwise": busy - conv - loss - optim}
    log(f"train (e): one-step profile: device busy {busy:.3f} ms of {wall_ms:.3f} ms wall "
        f"({busy / wall_ms:.1%}); device ms by part (the loss and the optimizer profiled "
        f"alone) {split}")
    log("train (e): top kernels (ms/step): "
        + "; ".join(f"{name[:70]} {ms:.3f}" for ms, name in sorted(kernels, reverse=True)[:10]))
    return {"wall_ms": wall_ms, "busy_ms": busy, "busy_share": busy / wall_ms,
            "split_ms": split}


def train(dev, width=1.0, img=IMG, batch=BATCH):
    """Phase 7: the yolov7 train step (training form, IDetect, full width)
    at `img` px, batch `batch`, bf16, the OTA loss with `LossHyp()`
    (hyp.scratch.p5 at nl 3, nc 80, 640 px), SGD with `OptimConfig()`,
    labels padded to 256 rows an image. The step runs no kernel of the
    port (its custom gradients are autograd Functions over PyTorch ops):
    the launch counters stay 0. (a) OTA card against CPU, (b) one fp32
    step card against CPU at width 0.25, (c) the bf16 step against the
    fp32 step, (d) TRAIN_STEPS bf16 steps on one fixed batch past warmup:
    the loss falls, everything finite, BN stats and EMA move; one step
    with the warmup's step-0 factors and one with accumulate=2, (e) ms a
    step, img/s, host time a step, peak memory and a one-step profile."""
    t_phase = time.perf_counter()
    model = train_model(dev, width)
    plan = model.plan
    opt = train_optim.OptimConfig()
    hyp = LossHyp()
    loss_fn = make_compute_loss_ota(plan.head, hyp)
    rng = np.random.default_rng(7)
    batch_np = train_batch(rng, batch, img)
    labels, mask = (torch.from_numpy(a).to(dev) for a in batch_np[1:])
    log(f"train: yolov7 training form ({type(plan.head).__name__} head), width {width}, "
        f"{model.num_params()} params, {img} px, batch {batch}, OTA loss {hyp}, {opt}, "
        f"{int(batch_np[2].sum())} boxes in {MAX_LABELS}-row label pads")
    zero_counts()

    # (a) OTA on the card against the CPU, on the fp32 raw maps of a
    # training forward
    x = torch.from_numpy(batch_np[0]).to(dev).float() / 255.0
    with torch.no_grad():
        out, _ = apply_model(plan, model.params, model.state, x, training=True,
                             dtype=torch.bfloat16)
    ota = check_ota(dev, plan, [r.float() for r in out["raw"]], labels, mask)
    del out

    # (b) fp32 step, card against CPU
    fp32_cpu = check_fp32_step(dev)

    # (c) the bf16 step against the fp32 step, from the same state
    lr, mom = lr_after_warmup(opt)
    ts = init_train_state(model.params, model.state, opt, device=dev)
    steps = {dt: make_train_step(plan, loss_fn, opt, compute_dtype=dt)
             for dt in (torch.bfloat16, torch.float32)}
    with full_fp32():
        new32, m32 = steps[torch.float32](ts, *batch_np, lr, mom)
    new16, m16 = steps[torch.bfloat16](ts, *batch_np, lr, mom)
    du16, du32 = tree_update(new16.params, ts.params), tree_update(new32.params, ts.params)
    cos = float(du16 @ du32 / (du16.norm() * du32.norm()))
    m16, m32 = ({k: float(v) for k, v in m.items()} for m in (m16, m32))
    item_err = max(abs(m16[k] - m32[k]) / abs(m32[k]) for k in m32)
    log(f"train (c): bf16 step against the fp32 step: losses bf16 {m16}, fp32 {m32}, "
        f"largest relative difference {item_err:.3g} (limit {BF16_ITEM_RTOL}); parameter "
        f"updates' cosine similarity {cos:.6f} (limit {BF16_UPDATE_COS})")
    if not item_err <= BF16_ITEM_RTOL:
        raise AssertionError(f"train (c): bf16 loss items differ by {item_err} relative")
    if not cos >= BF16_UPDATE_COS:
        raise AssertionError(f"train (c): bf16 update cosine {cos}")
    del new32, new16

    # (d) TRAIN_STEPS bf16 steps on the batch, past warmup
    step = steps[torch.bfloat16]
    cur, totals = ts, []
    for i in range(TRAIN_STEPS):
        cur, metrics = step(cur, *batch_np, lr, mom)
        totals.append(metrics["total"])
    totals = [float(t) for t in torch.stack(totals).cpu()]
    finite = all(bool(torch.isfinite(t).all()) for t in
                 tree_leaves(cur.params) + tree_leaves(cur.opt_state) + tree_leaves(cur.state)
                 + tree_leaves(cur.ema_params))
    moved = {name: tree_rel_l2(getattr(cur, name), getattr(ts, name)) > 0
             for name in ("state", "ema_params", "ema_state")}
    last3 = statistics.mean(totals[-3:])
    log(f"train (d): {TRAIN_STEPS} bf16 steps on one batch, lr {lr.tolist()}, momentum "
        f"{float(mom):.4f}: total loss {[round(t, 5) for t in totals]}; mean of the last 3 "
        f"{last3:.5f} against {totals[0]:.5f} at the first; params, momentum buffer "
        f"(the sum of every grad so far), BN stats and EMA finite {finite}; moved {moved}")
    if not last3 < totals[0]:
        raise AssertionError(f"train (d): the loss did not fall: {totals}")
    if not finite or not all(moved.values()):
        raise AssertionError(f"train (d): finite {finite}, moved {moved}")
    lr0, mom0 = warmup_factors(0, 1000, 0.0, 300, opt.lr0, 0.1, 0.1, 0.8, opt.momentum)
    _, m_warm = step(cur, *batch_np, lr0, mom0)
    acc_step = make_train_step(plan, loss_fn, opt, compute_dtype=torch.bfloat16, accumulate=2)
    half = batch // 2
    micro = tuple(a.reshape(2, half, *a.shape[1:]) for a in batch_np)
    _, m_acc = acc_step(cur, *micro, lr, mom)
    extra = {"warmup_step0": {k: float(v) for k, v in m_warm.items()},
             "accumulate2": {k: float(v) for k, v in m_acc.items()}}
    log(f"train (d): one step with the warmup's step-0 factors (lr {lr0.tolist()}, momentum "
        f"{float(mom0):.3f}): {extra['warmup_step0']}; one with accumulate=2 (2 x {half} "
        f"images): {extra['accumulate2']}")
    if not all(math.isfinite(v) for m in extra.values() for v in m.values()):
        raise AssertionError(f"train (d): non-finite losses {extra}")

    # (e) time, memory, profile
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"train: the step launched a kernel of the port: {counts}")
    timing = {"ms_step": None, "img_s": None, "host_ms_step": None, "peak_bytes": None,
              "profile": None}
    if dev.type == "cuda":
        timing.update(step_timing(lambda: step(cur, *batch_np, lr, mom), batch, iters=10,
                                  warmup=2, host_reps=5))
        timing["profile"] = step_profile(dev, plan, step, cur, batch_np, lr, mom, loss_fn, opt)
    secs = time.perf_counter() - t_phase
    log(f"train (e): bf16 step at batch {batch}, {img} px: {timing['ms_step']} ms a step "
        f"(median of 10, CUDA events), {timing['img_s']} img/s, host {timing['host_ms_step']} "
        f"ms a step (enqueue, median of 5), peak allocation {timing['peak_bytes']} bytes; "
        f"phase {secs:.1f} s")
    return {"ota": ota, "fp32_card_cpu": fp32_cpu,
            "bf16_vs_fp32": {"item_rel_err": item_err, "update_cos": cos,
                             "losses_bf16": m16, "losses_fp32": m32},
            "losses": totals, **extra, **timing, "phase_s": secs, "launches": counts}


# ------------------------------------------------- train and test CLIs ---

def write_dataset(root, n_train=TRAIN_IMAGES, n_val=VAL_IMAGES, nc=80, size=None):
    """A detection set under `root`: train/ and val/ with images/ (JPEGs at
    DATA_SHAPES in turn, blocky noise as `noise_image` makes it at `size`)
    and labels/ (YOLO txt: BOXES_AN_IMAGE filled rectangles an image, each
    of a random class and colour), and data.yaml. Drawn from SMOKE_SEED;
    returns the yaml's path."""
    import cv2
    import yaml

    rng = np.random.default_rng(SMOKE_SEED)
    for split, n in (("train", n_train), ("val", n_val)):
        (root / split / "images").mkdir(parents=True, exist_ok=True)
        (root / split / "labels").mkdir(parents=True, exist_ok=True)
        for i in range(n):
            h, w = DATA_SHAPES[i % len(DATA_SHAPES)]
            img = noise_image(rng, (h, w), size)
            rows = []
            for _ in range(int(rng.integers(BOXES_AN_IMAGE[0], BOXES_AN_IMAGE[1] + 1))):
                bw, bh = (int(rng.uniform(0.05, 0.4) * w), int(rng.uniform(0.05, 0.4) * h))
                x1, y1 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
                colour = tuple(int(c) for c in rng.integers(0, 256, 3))
                cv2.rectangle(img, (x1, y1), (x1 + bw - 1, y1 + bh - 1), colour, -1)
                rows.append(f"{int(rng.integers(0, nc))} {(x1 + bw / 2) / w:.6f} "
                            f"{(y1 + bh / 2) / h:.6f} {bw / w:.6f} {bh / h:.6f}")
            cv2.imwrite(str(root / split / "images" / f"{split}{i:03d}.jpg"), img)
            (root / split / "labels" / f"{split}{i:03d}.txt").write_text("\n".join(rows))
    data = root / "data.yaml"
    data.write_text(yaml.safe_dump({"train": str(root / "train" / "images"),
                                    "val": str(root / "val" / "images"), "nc": nc,
                                    "names": [f"class{i}" for i in range(nc)]}))
    return str(data)


def label_own_detections(model, val_dir, img, batch, max_det=30):
    """Append to each val image's labels the model's `max_det` most
    confident detections on it (conf 0.25, fp32), found on the val images
    as the trainer's evaluation letterboxes them and mapped back to the
    image: so the evaluations' mAP is above 0 and best.ckpt is written.
    Training moves the detections (the card's bf16 steps are not
    deterministic): with 3 an image, 4 of the 10 validations of five
    phase-8 runs on the card read map50 0 and one run wrote no best.ckpt;
    with 10, one run of three wrote none; with 30, the 6 validations of
    three runs read 0.00039-0.0026."""
    ds = DetectionDataset(str(val_dir / "images"), img_size=img, batch_size=batch, rect=True,
                          pad=0.5, stride=int(max(model.plan.strides)))
    dev = tree_leaves(model.params)[0].device
    for b in create_loader(ds, batch_size=batch, shuffle=False, drop_last=False):
        with torch.inference_mode(), full_fp32():
            x = torch.from_numpy(b["images"]).to(dev).float() / 255.0
            out, _ = apply_model(model.plan, model.params, model.state, x, dtype=torch.float32)
            dets = batched_nms(out["pred"], max_det=max_det)
        hw = b["images"].shape[1:3]
        for si, path in enumerate(b["paths"]):
            n = int(dets.num_dets[si])
            (h0, w0), ratio_pad = b["shapes"][si]
            xyxy = scale_coords_np(hw, dets.boxes[si, :n].cpu().numpy(), (h0, w0), ratio_pad)
            xyxy = xyxy.clip(0, [w0, h0, w0, h0])
            label = val_dir / "labels" / (Path(path).stem + ".txt")
            rows = [label.read_text()] + [
                f"{int(c)} {(x1 + x2) / 2 / w0:.6f} {(y1 + y2) / 2 / h0:.6f} "
                f"{(x2 - x1) / w0:.6f} {(y2 - y1) / h0:.6f}"
                for c, (x1, y1, x2, y2) in zip(dets.classes[si, :n].tolist(), xyxy)
                if x2 - x1 >= 2 and y2 - y1 >= 2]
            label.write_text("\n".join(rows))


def loader_img_s(data_dir, img, batch, workers):
    """img/s of one epoch of `create_loader` over the training images, as
    the trainer builds it (host augment with the default hyp), no step."""
    ds = DetectionDataset(str(data_dir), img_size=img, batch_size=batch, augment=True,
                          hyp=trainer.load_hyp(None), seed=0)
    loader = create_loader(ds, batch_size=batch, workers=workers, hold=2)
    t = time.perf_counter()
    n = sum(len(b["images"]) for b in loader)
    return n / (time.perf_counter() - t)


def loader_split_ms(data_dir, img, n=32):
    """On one thread, ms an image: the decode and resize of one file
    (`load_image`, every training image once) and a whole training sample
    (`__getitem__`: four decodes a mosaic, the warp, mixup, HSV, flips),
    n samples."""
    ds = DetectionDataset(str(data_dir), img_size=img, augment=True,
                          hyp=trainer.load_hyp(None), seed=0)
    t = time.perf_counter()
    for i in range(len(ds)):
        ds.load_image(i)
    decode = (time.perf_counter() - t) * 1e3 / len(ds)
    t = time.perf_counter()
    for i in range(n):
        ds[i % len(ds)]
    return {"decode": decode, "sample": (time.perf_counter() - t) * 1e3 / n}


def smoke_set(dev, width=1.0, img=IMG, batch=BATCH, n_train=TRAIN_IMAGES, n_val=VAL_IMAGES,
              root=SMOKE_DATA, runs=SMOKE_RUNS, train_cfg=TRAIN_CFG, hyp=None):
    """Phase 8's set under `root` (`root` and `runs` emptied first) and its
    start, the training form of `train_cfg` (yolov7's unless given), its
    BN settled on a batch augmented with `hyp` (the default hyp unless
    given): (data.yaml, model.yaml, livened.ckpt) paths."""
    import yaml

    for d in (root, runs):
        shutil.rmtree(d, ignore_errors=True)
    data = write_dataset(root, n_train, n_val, size=img)
    cfg = root / "model.yaml"
    cfg.write_text(yaml.safe_dump(_cfg(width, train_cfg)))
    # the start: the training form (seed 1) with its BN state set on a
    # training batch and its head made to pass candidates (a random init
    # passes none at conf 0.001, where mAP and the NMS would check
    # nothing), written by the port's checkpoint writer. With the BN state
    # of its own batches a step moves it by a little: livened as phase 5's,
    # one step takes its mAP to 0.
    model = Model.from_yaml(str(cfg), seed=1, device=dev)
    ds = DetectionDataset(str(root / "train" / "images"), img_size=img, augment=True,
                          hyp=trainer.load_hyp(hyp), seed=SMOKE_SEED)
    calib = next(iter(create_loader(ds, batch_size=batch)))["images"]
    calib = torch.from_numpy(calib.copy()).to(dev).float() / 255.0
    settle_bn(model.plan, model.params, model.state, calib)
    liven(model.plan, model.params, model.state, calib, act_rms=None, head_gain=1.0)
    start = root / "livened.ckpt"
    save_checkpoint(start, init_train_state(model.params, model.state,
                                            train_optim.OptimConfig(), device=dev),
                    cfg=_cfg(width, train_cfg))
    label_own_detections(model, root / "val", img, batch)
    return data, cfg, start


def train_and_test(dev, width=1.0, img=IMG, batch=BATCH, n_train=TRAIN_IMAGES,
                   n_val=VAL_IMAGES):
    """Phase 8: `cli/train.py` at `width` (1.0: the training form as
    published) from a settled start (seed 1, `settle_bn` and `liven`'s
    head on a training batch) on a synthetic set written under build/,
    `img` px, batch
    `batch` accumulated to CLI_NBS, bf16, CLI_EPOCHS epochs with the default
    hyp (mosaic, mixup, paste-in), autoanchor and per-epoch validation, on
    `dev`; then `cli/test.py` on its last.ckpt (fused, fp32), with K1L and
    with the plain keep-mask. Held: every loss item finite; last.ckpt and
    best.ckpt written and stripped, and read back; validation launched K1L
    (two batches an evaluation, one evaluation an epoch and a final one)
    and nothing else; the test CLI's mAP equal with K1L and with the plain
    keep-mask, and so are its detections (txt). Timed on the card: img/s and ms a step an epoch, the share
    of the trainer's time spent waiting for a batch, the loader alone with 1
    and CLI_WORKERS threads (and, on one thread, a file's decode and a
    whole sample), a checkpoint's bytes and seconds to write,
    validation ms an image, the test CLI's inference and NMS ms an image,
    and the peak allocation."""
    t_phase = time.perf_counter()
    data, cfg, start = smoke_set(dev, width, img, batch, n_train, n_val)
    on_cpu = ["--device", "cpu"] if dev.type == "cpu" else []
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    val = {"s": 0.0, "images": 0}
    real_evaluate = trainer.evaluate

    def timed_evaluate(*args, **kwargs):
        sync()
        t = time.perf_counter()
        res = real_evaluate(*args, **kwargs)
        sync()
        val["s"] += time.perf_counter() - t
        val["images"] += res["seen"]
        return res

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    trainer.evaluate = timed_evaluate
    try:
        out = cli_train.main(["--cfg", str(cfg), "--data", data, "--weights", str(start),
                              "--epochs", str(CLI_EPOCHS),
                              "--batch-size", str(batch), "--nbs", str(CLI_NBS),
                              "--no-warmup-accumulate", "--img-size", str(img),
                              "--workers", str(CLI_WORKERS), "--project", str(SMOKE_RUNS),
                              "--name", "exp"] + on_cpu)
    finally:
        trainer.evaluate = real_evaluate
    train_counts = read_counts()
    peak = torch.cuda.max_memory_allocated() if cuda else None
    rows = out["results"]
    items = [{k: v for k, v in r.items() if k.startswith("train/")} for r in rows]
    log(f"train CLI: width {width}, {img} px, batch {batch} x {CLI_NBS // batch} micro-batches, "
        f"{CLI_EPOCHS} epochs of {n_train} images, {CLI_WORKERS} loader threads: rows {rows}")
    if not all(math.isfinite(v) for r in items for v in r.values()) or len(items[0]) != 4:
        raise AssertionError(f"train CLI: loss items {items}")
    evals = CLI_EPOCHS + 1
    want = {kid: 0 for kid in COUNTED} | {"K1L": evals * -(-n_val // batch)}
    if cuda and train_counts != want:
        raise AssertionError(f"train CLI: launch counts {train_counts}, want {want}")
    weights = Path(out["save_dir"]) / "weights"
    for name in ("last.ckpt", "best.ckpt"):
        blob = load_checkpoint(weights / name)
        if blob["opt_state"] is not None or blob["epoch"] != -1:
            raise AssertionError(f"train CLI: {name} is not stripped")
        load_checkpoint_any(str(weights / name))

    # the test CLI on last.ckpt: K1L against the plain keep-mask
    # (with its detections as txt, which must be equal too: the mAP of a
    # model trained 8 steps may well be 0 with either keep-mask)
    def test_cli(name):
        return cli_test.main(["--weights", str(weights / "last.ckpt"), "--data", data,
                              "--img-size", str(img), "--batch-size", str(batch),
                              "--save-txt", "--save-conf", "--project", str(SMOKE_RUNS),
                              "--name", name] + on_cpu)

    zero_counts()
    test = test_cli("test_k1l")
    test_counts = read_counts()
    with plain_nms():
        plain = test_cli("test_plain")
    want = {kid: 0 for kid in COUNTED} | {"K1L": -(-n_val // batch)}
    if cuda and test_counts != want:
        raise AssertionError(f"test CLI: launch counts {test_counts}, want {want}")
    for key in ("map50", "map", "mp", "mr"):
        if test[key] != plain[key]:
            raise AssertionError(f"test CLI: {key} {test[key]} with K1L, {plain[key]} with "
                                 "the plain keep-mask")
    txt = {name: {p.name: p.read_text() for p in (SMOKE_RUNS / name / "labels").glob("*.txt")}
           for name in ("test_k1l", "test_plain")}
    n_dets = sum(t.count("\n") for t in txt["test_k1l"].values())
    if txt["test_k1l"] != txt["test_plain"] or not n_dets:
        raise AssertionError(f"test CLI: {n_dets} detections, the txts equal with K1L and the "
                             f"plain keep-mask: {txt['test_k1l'] == txt['test_plain']}")
    log(f"test CLI: last.ckpt, fused, fp32: map50 {test['map50']:.6f}, map {test['map']:.6f}, "
        f"mp {test['mp']:.6f}, mr {test['mr']:.6f} (plain keep-mask map50 "
        f"{plain['map50']:.6f}, map {plain['map']:.6f}); {n_dets} detections on {n_val} "
        f"images, their txt rows equal with the plain keep-mask; launches {test_counts}")

    timing = {"epochs": None, "loader_img_s": None, "loader_ms_an_image": None,
              "ckpt_bytes": None, "ckpt_write_s": None,
              "val_ms_an_image": None, "test_ms_an_image": None, "peak_bytes": peak}
    if cuda:
        steps = n_train // batch // (CLI_NBS // batch)
        timing["epochs"] = [{"img_s": n_train / r["time_s"],
                             "ms_step": r["time_s"] * 1e3 / steps,
                             "wait_share": r["wait_s"] / r["time_s"]} for r in rows]
        timing["loader_img_s"] = {w: loader_img_s(SMOKE_DATA / "train" / "images", img,
                                                  batch, w) for w in (1, CLI_WORKERS)}
        timing["loader_ms_an_image"] = loader_split_ms(SMOKE_DATA / "train" / "images", img)
        path = SMOKE_RUNS / "ckpt_write.ckpt"
        t = time.perf_counter()
        save_checkpoint(path, out["train_state"], cfg=load_checkpoint(weights / "last.ckpt")["cfg"])
        timing["ckpt_write_s"] = time.perf_counter() - t
        timing["ckpt_bytes"] = path.stat().st_size
        timing["val_ms_an_image"] = val["s"] * 1e3 / val["images"]
        timing["test_ms_an_image"] = test["speed_ms"]
    secs = time.perf_counter() - t_phase
    log(f"train and test CLIs: {timing}; phase {secs:.1f} s; card {smi() if cuda else 'none'}")
    return {"rows": rows, "launches_train": train_counts, "launches_test": test_counts,
            "test": {k: test[k] for k in ("map50", "map", "mp", "mr", "speed_ms")},
            **timing, "phase_s": secs}


# ------------------------------------------------------ the P6 family ---

def model_spans(m):
    """(H, cin, ct, cc, cout, order) of the ELAN spans that `make_fused_elan`
    rewrites in the fused plan of `m`, at m.img px, in plan order."""
    out = []
    for i, order in fused_elan.find_elan_spans(m.plan, m.params):
        layers = m.plan.layers
        out.append((int(m.img / layers[i].stride), layers[i].block.c1, layers[i].block.c2,
                    layers[i + 2].block.c2, layers[i + 7].block.c2, order))
    return tuple(out)


def aux_hyp(nl, img):
    """The aux loss's hyp as the trainer scales hyp.scratch.p6 (nc 80)."""
    return trainer._scaled_loss_hyp(trainer.load_hyp(str(P6_HYP)), nl, 80, img)


def check_aux_loss(dev, head, hyp, raw, labels, mask):
    """(d) The aux OTA loss on the card against the CPU on the same fp32
    raw maps (lead and aux) and labels: both assignments (lead g 0.5 and
    aux g 1.0, top-20, from the lead maps) and the loss items, held as
    phase 7 (a) holds the OTA loss."""
    nl = head.nl
    anchors = np.asarray(head.anchors, np.float32).reshape(nl, head.na, 2)
    strides = np.asarray(head.strides, np.float32)
    loss_fn = make_compute_loss_aux_ota(head, hyp)
    out = {}
    for where in (dev, torch.device("cpu")):
        r = [t.to(where) for t in raw]
        lb, mk = labels.to(where), mask.to(where)
        total, items = loss_fn(r, lb, mk)
        assign = [ota_assign_batch(r[:nl], lb, mk, anchors, strides, hyp, g, 20)[:2]
                  for g in (0.5, 1.0)]
        out[where.type] = ({k: float(v) for k, v in items.items()} | {"total": float(total)},
                           [(fg.cpu(), mg.cpu()) for fg, mg in assign])
    (card, a_c), (cpu, a_h) = out[dev.type], out["cpu"]
    same = min(((fc == fh) & (~fc | (mc == mh))).double().mean().item()
               for (fc, mc), (fh, mh) in zip(a_c, a_h))
    err = max(abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-30) for k in cpu)
    log(f"p6 (d): aux OTA at {raw[0].shape[0]} images, {2 * nl} maps, {labels.shape[1]} label "
        f"rows: items card {card}, CPU {cpu}, largest relative difference {err:.3g} (limit "
        f"{OTA_ITEM_RTOL}); columns with the same (fg, matched_gt), the lesser of the lead "
        f"and the aux assignment, {same:.6f} (limit {OTA_COLUMN_SHARE}); fg lead / aux "
        f"{int(a_c[0][0].sum())} / {int(a_c[1][0].sum())}")
    if not same >= OTA_COLUMN_SHARE:
        raise AssertionError(f"p6 (d): aux assignments agree on {same} of the columns")
    if not err <= OTA_ITEM_RTOL:
        raise AssertionError(f"p6 (d): aux loss items differ by {err} relative")
    return {"items_card": card, "items_cpu": cpu, "item_rel_err": err, "same_columns": same}


def train_aux(dev, width=1.0, img=P6_IMG):
    """Phase 9 (d): the yolov7-w6 train step (IAuxDetect, full width) at
    `img` px, bf16, the aux OTA loss with hyp.scratch.p6 scaled as the
    trainer scales it, SGD: the largest batch of P6_BATCHES that the card
    holds (the cut logged). The aux loss card against CPU on the same fp32
    raw maps; P6_STEPS steps on one batch past warmup (finite, the loss
    falls); ms a step, host ms a step, peak allocation. No kernel of the
    port is on this path: the counters stay 0."""
    t_phase = time.perf_counter()
    model = Model.from_yaml(_cfg(width, P6_TRAIN_CFG), seed=2, device=dev)
    plan, head = model.plan, model.plan.head
    hyp = aux_hyp(head.nl, img)
    loss_fn = make_compute_loss_aux_ota(head, hyp)
    opt = train_optim.OptimConfig()
    lr, mom = lr_after_warmup(opt)
    step = make_train_step(plan, loss_fn, opt, compute_dtype=torch.bfloat16)
    zero_counts()
    batch = cur = None
    for b in P6_BATCHES:
        batch_np = train_batch(np.random.default_rng(7), b, img)
        ts = init_train_state(model.params, model.state, opt, device=dev)
        try:
            cur, first = step(ts, *batch_np, lr, mom)
            batch = b
            break
        except torch.cuda.OutOfMemoryError:
            del ts
            cur = None
            torch.cuda.empty_cache()
            log(f"p6 (d): a batch of {b} at {img} px does not fit the card's memory")
    if batch is None:
        raise AssertionError(f"p6 (d): no batch of {P6_BATCHES} fits")
    log(f"p6 (d): yolov7-w6 training form ({type(head).__name__}), width {width}, "
        f"{model.num_params()} params, {img} px, batch {batch} (of {P6_BATCHES}), bf16, aux "
        f"OTA loss {hyp}, {opt}")
    labels, mask = (torch.from_numpy(a).to(dev) for a in batch_np[1:])
    x = torch.from_numpy(batch_np[0]).to(dev).float() / 255.0
    with torch.no_grad():
        out, _ = apply_model(plan, ts.params, ts.state, x, training=True, dtype=torch.bfloat16)
    if len(out["raw"]) != 2 * head.nl:
        raise AssertionError(f"p6 (d): {len(out['raw'])} raw maps, want {2 * head.nl}")
    aux = check_aux_loss(dev, head, hyp, [r.float() for r in out["raw"]], labels, mask)
    del out, x
    totals = [first["total"]]
    for _ in range(P6_STEPS - 1):
        cur, metrics = step(cur, *batch_np, lr, mom)
        totals.append(metrics["total"])
    totals = [float(t) for t in torch.stack(totals).cpu()]
    finite = all(bool(torch.isfinite(t).all()) for t in
                 tree_leaves(cur.params) + tree_leaves(cur.state) + tree_leaves(cur.ema_params))
    last3 = statistics.mean(totals[-3:])
    log(f"p6 (d): {P6_STEPS} bf16 steps on one batch: total loss "
        f"{[round(t, 5) for t in totals]}; mean of the last 3 {last3:.5f} against "
        f"{totals[0]:.5f} at the first; params, BN stats and EMA finite {finite}")
    if not (last3 < totals[0] and finite):
        raise AssertionError(f"p6 (d): finite {finite}, losses {totals}")
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"p6 (d): the step launched a kernel of the port: {counts}")
    timing = {"ms_step": None, "img_s": None, "host_ms_step": None, "peak_bytes": None}
    if dev.type == "cuda":
        timing.update(step_timing(lambda: step(cur, *batch_np, lr, mom), batch))
    secs = time.perf_counter() - t_phase
    log(f"p6 (d): bf16 aux step at batch {batch}, {img} px: {timing['ms_step']} ms a step "
        f"(median of 5, CUDA events), {timing['img_s']} img/s, host {timing['host_ms_step']} "
        f"ms a step (median of 3), peak allocation {timing['peak_bytes']} bytes; phase "
        f"{secs:.1f} s")
    return {"batch": batch, "aux_loss": aux, "losses": totals, **timing, "phase_s": secs,
            "launches": counts}


def bridge(dev, width=1.0, img=P6_IMG, batch=BATCH, n_train=TRAIN_IMAGES,
           n_val=VAL_IMAGES):
    """Phase 9 (e): the yolov7-w6 training form (seed 1, BN state settled
    and the head livened on a training batch, as phase 8's start) written
    as a reference `.pt` (`{"model": state_dict, "ema": None}`, fp16
    tensors, `torch.save`), read back by `load_checkpoint_any`; then
    `cli/train.py --weights that.pt --hyp hyp.scratch.p6.yaml` for one
    epoch on phase 8's generator at `img` px (n_train / n_val images, the
    val labels holding the start's own detections), and `cli/test.py` on
    its last.ckpt (fused, fp32) with K1L and with the plain keep-mask:
    every loss item finite, validation launches K1L only, the test CLI's
    mAP and detections equal with either keep-mask."""
    import yaml

    t_phase = time.perf_counter()
    for d in (P6_DATA, P6_RUNS):
        shutil.rmtree(d, ignore_errors=True)
    data = write_dataset(P6_DATA, n_train, n_val, size=img)
    cfg = P6_DATA / "model.yaml"
    cfg.write_text(yaml.safe_dump(_cfg(width, P6_TRAIN_CFG)))
    model = Model.from_yaml(str(cfg), seed=1, device=dev)
    ds = DetectionDataset(str(P6_DATA / "train" / "images"), img_size=img, augment=True,
                          hyp=trainer.load_hyp(str(P6_HYP)), seed=SMOKE_SEED,
                          stride=int(max(model.plan.strides)))
    calib = next(iter(create_loader(ds, batch_size=batch)))["images"]
    calib = torch.from_numpy(calib.copy()).to(dev).float() / 255.0
    settle_bn(model.plan, model.params, model.state, calib)
    liven(model.plan, model.params, model.state, calib, act_rms=None, head_gain=1.0)
    del calib
    label_own_detections(model, P6_DATA / "val", img, batch)
    pt = P6_DATA / "yolov7-w6.pt"
    sd = export_state_dict(model.plan, model.params, model.state)
    torch.save({"model": {k: torch.from_numpy(v).half() for k, v in sd.items()}, "ema": None},
               pt)
    _, params, state = load_checkpoint_any(str(pt), str(cfg))
    for a, b in zip(tree_leaves(params) + tree_leaves(state),
                    tree_leaves(model.params) + tree_leaves(model.state)):
        if not torch.equal(a, b.detach().cpu().half().float()):
            raise AssertionError("p6 (e): the .pt does not read back as the fp16 trees")
    log(f"p6 (e): {pt.name}: {len(sd)} keys, {pt.stat().st_size} bytes (fp16), read back "
        f"bit-equal with the fp16-rounded trees")
    del model, params, state
    res = cli_pair(dev, "p6 (e)", cfg, data, pt, P6_HYP, P6_RUNS, width, img, batch, n_train,
                   n_val)
    secs = time.perf_counter() - t_phase
    log(f"p6 (e): phase {secs:.1f} s")
    return {**res, "pt_bytes": pt.stat().st_size, "phase_s": secs}


def cli_pair(dev, what, cfg, data, weights, hyp, runs, width, img, batch, n_train, n_val,
             stripped=False):
    """`cli/train.py --weights weights --hyp hyp` for one epoch (no
    accumulation) on the set of `data`, then `cli/test.py` on its
    last.ckpt (fused, fp32) with K1L and with the plain keep-mask: every
    loss item finite, validation launches K1L only (two evaluations), the
    test CLI's mAP and detections equal with either keep-mask; with
    `stripped`, last.ckpt and best.ckpt written stripped and read back."""
    on_cpu = ["--device", "cpu"] if dev.type == "cpu" else []
    cuda = dev.type == "cuda"
    zero_counts()
    out = cli_train.main(["--cfg", str(cfg), "--data", data, "--weights", str(weights),
                          "--hyp", str(hyp), "--epochs", "1", "--batch-size", str(batch),
                          "--nbs", str(batch), "--img-size", str(img),
                          "--workers", str(CLI_WORKERS), "--project", str(runs),
                          "--name", "exp"] + on_cpu)
    train_counts = read_counts()
    rows = out["results"]
    items = [{k: v for k, v in r.items() if k.startswith("train/")} for r in rows]
    log(f"{what} train CLI from {Path(weights).name}: width {width}, {img} px, batch {batch}, "
        f"1 epoch of {n_train} images, hyp {Path(hyp).name}: rows {rows}")
    if not all(math.isfinite(v) for r in items for v in r.values()) or len(items[0]) != 4:
        raise AssertionError(f"{what} train CLI: loss items {items}")
    want = {kid: 0 for kid in COUNTED} | {"K1L": 2 * -(-n_val // batch)}
    if cuda and train_counts != want:
        raise AssertionError(f"{what} train CLI: launch counts {train_counts}, want {want}")
    weights_dir = Path(out["save_dir"]) / "weights"
    if stripped:
        for name in ("last.ckpt", "best.ckpt"):
            blob = load_checkpoint(weights_dir / name)
            if blob["opt_state"] is not None or blob["epoch"] != -1:
                raise AssertionError(f"{what} train CLI: {name} is not stripped")
            load_checkpoint_any(str(weights_dir / name))
    last = weights_dir / "last.ckpt"

    def test_cli(name):
        return cli_test.main(["--weights", str(last), "--data", data, "--img-size", str(img),
                              "--batch-size", str(batch), "--save-txt", "--save-conf",
                              "--project", str(runs), "--name", name] + on_cpu)

    zero_counts()
    test = test_cli("test_k1l")
    test_counts = read_counts()
    with plain_nms():
        plain = test_cli("test_plain")
    want = {kid: 0 for kid in COUNTED} | {"K1L": -(-n_val // batch)}
    if cuda and test_counts != want:
        raise AssertionError(f"{what} test CLI: launch counts {test_counts}, want {want}")
    for key in ("map50", "map", "mp", "mr"):
        if test[key] != plain[key]:
            raise AssertionError(f"{what} test CLI: {key} {test[key]} with K1L, {plain[key]} "
                                 "with the plain keep-mask")
    txt = {name: {p.name: p.read_text() for p in (runs / name / "labels").glob("*.txt")}
           for name in ("test_k1l", "test_plain")}
    n_dets = sum(t.count("\n") for t in txt["test_k1l"].values())
    if txt["test_k1l"] != txt["test_plain"] or not n_dets:
        raise AssertionError(f"{what} test CLI: {n_dets} detections, the txts equal with K1L "
                             f"and the plain keep-mask: {txt['test_k1l'] == txt['test_plain']}")
    log(f"{what} test CLI: last.ckpt, fused, fp32: map50 {test['map50']:.6f}, map "
        f"{test['map']:.6f} (plain keep-mask map50 {plain['map50']:.6f}, map "
        f"{plain['map']:.6f}); {n_dets} detections on {n_val} images, equal with the plain "
        f"keep-mask; launches {test_counts}; ms an image {test['speed_ms']}")
    return {"rows": rows, "launches_train": train_counts, "launches_test": test_counts,
            "test": {k: test[k] for k in ("map50", "map", "mp", "mr", "speed_ms")}}


def p6(dev, rows, width=1.0, img=P6_IMG, batch=BATCH, requests=12):
    """Phase 9: the P6 family (yolov7-w6) on the card. (a) the deploy form's
    bf16 graph engines at `img` px (no fused stem: the ReOrg stem; the fast
    stem folds the pair after it; P6_SPANS fused spans); (b) K3 at each of
    those spans against its plain version; (c) the Detector and fp32
    `evaluate` on the training form (IAuxDetect, fused); (d) the aux train
    step; (e) the `.pt` bridge through the train and test CLIs. Returns the
    numbers, with the launches of the counted main paths: K1 and K3 of (a),
    K3 and K1L of (c), K1L of (e)."""
    t_phase = time.perf_counter()
    m = make_model(dev, width, img, P6_DEPLOY_CFG)
    spans = model_spans(m)
    log(f"p6: yolov7-w6 deploy at {img} px: {len(spans)} ELAN spans (H, cin, ct, cc, cout, "
        f"order) {spans}")
    if len(spans) != P6_SPANS:
        raise AssertionError(f"p6: {len(spans)} ELAN spans, want {P6_SPANS}")
    srv = serving(dev, m, batch, requests, what="p6 (a) serving", transforms=(0, P6_SPANS),
                  with_ingest=False)
    del m
    if dev.type == "cuda":
        check_k3(dev, rows, spans, batch, key="K3_p6", stages_alone=False)
    det = detect(dev, width, P6_TRAIN_CFG, img, transforms=(0, P6_SPANS), what="p6 (c) detect")
    m = make_model(dev, width, img, P6_TRAIN_CFG)
    ev = evaluation(dev, m, batch, 16, what="p6 (c) eval")
    del m
    tr = train_aux(dev, width, img)
    br = bridge(dev, width, img, tr["batch"])
    launches = {"K1": srv["launches"]["K1"],
                "K3": srv["launches"]["K3"] + det["launches"]["K3"],
                "K1L": det["launches"]["K1L"] + ev["launches"]["K1L"]
                + br["launches_train"]["K1L"] + br["launches_test"]["K1L"]}
    secs = time.perf_counter() - t_phase
    log(f"p6: launches of its main paths {launches}; phase {secs:.1f} s")
    keys = ("replays", "img_s", "device_ms_bs8", "replay_ms_bs8", "eager_ms_bs8", "p50_ms_bs8",
            "p50_ms_bs1", "host_ms_infer_async", "enqueue_ms_bs8", "profile",
            "feature_rms_err", "feature_rms_err_cudnn_bf16", "agreement",
            "agreement_cudnn_bf16")
    return {"launches": launches, "serving": {k: srv.get(k) for k in keys},
            "k3_spans": rows.get("K3_p6_spans"), "k3": rows.get("K3_p6"), "detect": det,
            "eval": ev, "train": tr, "bridge": br, "phase_s": secs}


# ----------------------------------------------------- the rest of the zoo ---

def serve_baseline(dev, m, batch=BATCH, agree=False, what="zoo (d)"):
    """Phase 11 (d): one baseline's fused deploy form through the bf16 graph
    engine at `batch` (no fused stem or span: the baselines hold none; the
    fast stem folds where it matches). Counted: K1 once at the warm-up and
    once at the capture, every forward after them a replay, each replay
    bit-equal to the eager `end2end`; img/s of one `infer_async` between
    events and the busy share of the graph's profile, whose trace must show
    one `nms_keep_kernel` a replay and no other kernel of the port. With
    `agree`, the head inputs and detections held against the fp32 and
    cuDNN bf16 references as phase 4 holds yolov7's."""
    engine = ServingEngine(m.plan, m.params, m.state, batch_size=batch, img_size=m.img,
                           dtype=torch.bfloat16, device=dev)
    folded = [type(s.block).__name__ for s in engine.plan.layers].count("PhasedConv")
    if plan_names(engine) != (0, 0):
        raise AssertionError(f"{what}: a fused stem or span matched: {plan_names(engine)}")
    batches = [m.rng.integers(0, 256, (batch, m.img, m.img, 3), np.uint8) for _ in range(3)]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    zero_counts()
    outs = [engine.infer(b) for b in batches]
    counts = read_counts()
    check_path_counts(what, counts, (engine,), {"K1": 1})
    graph_equals_eager(what, engine, outs, batches)
    res = {"launches": counts, "params": m.n_params, "img": m.img, "phased_convs": folded}
    if agree:
        normalized, reference = make_reference(m)
        with torch.inference_mode():
            feats, _ = apply_model(engine.plan, engine._params, engine._state,
                                   normalized(batches[0]), dtype=torch.bfloat16,
                                   return_head_inputs=True)
        f32, want = reference(batches[0], torch.float32)
        f16, cudnn = reference(batches[0], torch.bfloat16)
        err_eng, err_bf16 = feature_error(feats, f32), feature_error(f16, f32)
        agree_eng = agreement(what, outs[0], want)
        agree_bf16 = agreement(f"{what} cuDNN bf16", cudnn, want)
        log(f"{what}: head inputs {err_eng:.4f} relative RMS from the fp32 reference (cuDNN "
            f"bf16 {err_bf16:.4f}); detections agree {agree_eng:.3f} with it (cuDNN bf16 "
            f"{agree_bf16:.3f}); {int(outs[0]['num_dets'].sum())} / "
            f"{int(want['num_dets'].sum())} detections")
        if not err_eng <= FEAT_RATIO * err_bf16:
            raise AssertionError(f"{what}: head inputs {err_eng} relative RMS from the fp32 "
                                 f"reference, cuDNN bf16 {err_bf16}")
        if not agree_eng >= agree_bf16 - MATCH_MARGIN:
            raise AssertionError(f"{what}: detections agree {agree_eng:.3f}, cuDNN bf16's "
                                 f"{agree_bf16:.3f}")
        res.update(feature_rms_err=err_eng, feature_rms_err_cudnn_bf16=err_bf16,
                   agreement=agree_eng, agreement_cudnn_bf16=agree_bf16)
    if dev.type == "cuda":
        fwd_ms = cuda_ms(lambda: engine.infer_async(batches[0]), iters=10)
        prof = profile_forwards(lambda: engine.infer_async(batches[0]), f"{what} (graph)",
                                n=3)["profile"]
        got = prof and prof["launches"]
        want = {k: float(k == "nms_keep_kernel") for k in TRACED}
        if got is not None and got != want:
            raise AssertionError(f"{what}: a replay launched {got} in the trace, want {want}")
        res.update(img_s=batch / fwd_ms * 1e3, device_ms_bs8=fwd_ms, profile=prof)
        log(f"{what}: {res['img_s']:.1f} img/s (one batch-{batch} infer_async {fwd_ms:.3f} ms "
            f"between events), busy {prof and prof['busy_share']}")
    return res


def train_tiny(dev, width=1.0, img=IMG, batch=BATCH):
    """Phase 11 (c): yolov7-tiny's training form (IDetect, LeakyReLU) at
    `img` px, batch `batch`, bf16, the OTA loss with hyp.scratch.tiny's
    weights scaled as the trainer scales them, SGD past warmup: a fp32 step
    on the card against the CPU (phase 7 (b), width 0.25, 320 px), then
    TINY_STEPS bf16 steps on one batch (finite; params, BN stats and EMA
    move; a few steps of a random init need not lower the loss), ms a step
    (CUDA events), host ms a step, peak allocation and the busy share of a
    profiled step. No kernel of the port is on this path."""
    t_phase = time.perf_counter()
    hyp_of = lambda size: trainer._scaled_loss_hyp(  # noqa: E731
        trainer.load_hyp(str(TINY_HYP)), 3, 80, size)
    fp32 = check_fp32_step(dev, cfg=TINY_TRAIN_CFG, hyp=hyp_of(320), what="zoo (c) train",
                           update_l2=TINY_UPDATE_L2)
    model = train_model(dev, width, cfg=TINY_TRAIN_CFG)
    plan, hyp = model.plan, hyp_of(img)
    opt = train_optim.OptimConfig()
    lr, mom = lr_after_warmup(opt)
    step = make_train_step(plan, make_compute_loss_ota(plan.head, hyp), opt,
                           compute_dtype=torch.bfloat16)
    batch_np = train_batch(np.random.default_rng(7), batch, img)
    zero_counts()
    ts = init_train_state(model.params, model.state, opt, device=dev)
    cur, totals = ts, []
    for _ in range(TINY_STEPS):
        cur, metrics = step(cur, *batch_np, lr, mom)
        totals.append(metrics["total"])
    totals = [float(t) for t in torch.stack(totals).cpu()]
    finite = all(math.isfinite(t) for t in totals) and all(
        bool(torch.isfinite(t).all()) for t in
        tree_leaves(cur.params) + tree_leaves(cur.state) + tree_leaves(cur.ema_params))
    moved = {name: tree_rel_l2(getattr(cur, name), getattr(ts, name)) > 0
             for name in ("params", "state", "ema_params")}
    log(f"zoo (c) train: yolov7-tiny training form ({type(plan.head).__name__}), width {width}, "
        f"{model.num_params()} params, {img} px, batch {batch}, bf16, OTA loss {hyp}: "
        f"{TINY_STEPS} steps on one batch, total loss {[round(t, 5) for t in totals]}; "
        f"losses, params, BN stats and EMA finite {finite}; moved {moved}")
    if not (finite and all(moved.values())):
        raise AssertionError(f"zoo (c) train: finite {finite}, moved {moved}, losses {totals}")
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"zoo (c) train: the step launched a kernel of the port: {counts}")
    timing = {"ms_step": None, "img_s": None, "host_ms_step": None, "peak_bytes": None,
              "profile": None}
    if dev.type == "cuda":
        timing.update(step_timing(lambda: step(cur, *batch_np, lr, mom), batch))
        timing["profile"] = profile_forwards(lambda: step(cur, *batch_np, lr, mom),
                                             "zoo (c) train step", n=2)["profile"]
    secs = time.perf_counter() - t_phase
    log(f"zoo (c) train: bf16 step at batch {batch}, {img} px: {timing['ms_step']} ms a step "
        f"(median of 5, CUDA events), {timing['img_s']} img/s, host {timing['host_ms_step']} "
        f"ms a step (median of 3), peak allocation {timing['peak_bytes']} bytes; "
        f"{secs:.1f} s")
    return {"fp32_card_cpu": fp32, "losses": totals, **timing, "launches": counts,
            "phase_s": secs}


def clustered_boxes(rng, n, size=640):
    """tests/test_nms.py's boxes: n boxes in clusters of ~8 (overlapping,
    so suppression chains form), scores uniform in [0.01, 1)."""
    centers = rng.uniform(100, size - 100, (max(n // 8, 1), 2))
    cxy = centers[rng.integers(0, len(centers), n)] + rng.normal(0, 20, (n, 2))
    wh = rng.uniform(20, 120, (n, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], 1).astype(np.float32)
    return boxes, rng.uniform(0.01, 1.0, n).astype(np.float32)


def check_nms_padded(dev):
    """Phase 11 (e): `ops/nms.nms_padded` on the card against the same call
    with the plain keep-mask: indices and count equal, at each of
    NMS_PADDED_CASES (rows 7 of tests/test_nms.py's generator at 400 rows;
    at 4096 a tenth of the rows invalid, -inf). Counted: K1 once at 400
    rows, K1L once at 4096. Timed: one call between events, kernel and
    plain keep-mask."""
    out, launches = [], {kid: 0 for kid in COUNTED}
    for n, slots, thr in NMS_PADDED_CASES:
        boxes, scores = clustered_boxes(np.random.default_rng(7 if n == 400 else n), n)
        if n > 400:
            scores[::10] = -np.inf
        b, sc = torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)
        zero_counts()
        idx, valid = nms_padded(b, sc, thr, max_output=slots)
        counts = read_counts()
        with plain_nms():
            pidx, pvalid = nms_padded(b, sc, thr, max_output=slots)
        kid = "K1" if n <= nms_keep.MAX_K else "K1L"
        want = {k: int(k == kid) for k in COUNTED}
        if dev.type == "cuda" and counts != want:
            raise AssertionError(f"zoo (e): nms_padded at {n} rows launched {counts}, "
                                 f"want {want}")
        if not (torch.equal(idx, pidx) and int(valid) == int(pvalid) > 0):
            raise AssertionError(f"zoo (e): nms_padded at {n} rows: {int(valid)} kept with "
                                 f"{kid}, {int(pvalid)} with the plain keep-mask, indices "
                                 f"equal {torch.equal(idx, pidx)}")
        for k, v in counts.items():
            launches[k] += v
        row = {"rows": n, "slots": slots, "kept": int(valid), "keep_mask": kid}
        if dev.type == "cuda":
            row["ms"] = cuda_ms(lambda: nms_padded(b, sc, thr, max_output=slots), iters=10)
            with plain_nms():
                row["plain_ms"] = cuda_ms(lambda: nms_padded(b, sc, thr, max_output=slots),
                                          iters=3, warmup=1)
        log(f"zoo (e): nms_padded at {n} rows, {slots} slots, IoU {thr}: {int(valid)} kept, "
            f"indices and count equal with {kid} and with the plain keep-mask; one call "
            f"{row.get('ms')} ms ({kid}), {row.get('plain_ms')} ms (plain)")
        out.append(row)
    return {"cases": out, "launches": launches}


def zoo(dev, img=IMG, batch=BATCH, requests=12, baselines=BASELINES, width=1.0,
        n_train=TRAIN_IMAGES, n_val=VAL_IMAGES):
    """Phase 11: the rest of the zoo on the card. (a) yolov7-tiny deploy
    (LeakyReLU) through the bf16 graph engines at batch `batch` and 1 as
    phase 4 drives yolov7's (no fused stem or span: every conv is cuDNN's,
    each replay's trace one `nms_keep_kernel` and no `conv_silu_kernel`);
    (b) tiny-silu deploy the same; (c) tiny's training form (IDetect):
    the Detector (K1L at 4096), fp32 `evaluate` (K1L at 8192), the train
    step (`train_tiny`) and the train and test CLIs (`cli_pair`, K1L);
    (d) the baselines (`serve_baseline`); (e) `nms_padded` (K1, K1L).
    Returns the numbers, with the launches of the counted main paths."""
    t_phase = time.perf_counter()
    m = make_model(dev, width, img, TINY_DEPLOY_CFG)
    tiny = serving(dev, m, batch, requests, what="zoo (a) tiny", transforms=(0, 0),
                   with_ingest=False)
    m = make_model(dev, width, img, TINY_SILU_CFG)
    silu = serving(dev, m, batch, 4, what="zoo (b) tiny-silu", transforms=(0, 0),
                   with_ingest=False)
    del m
    det = detect(dev, width, TINY_TRAIN_CFG, img, transforms=(0, 0), what="zoo (c) detect")
    m = make_model(dev, width, img, TINY_TRAIN_CFG)
    ev = evaluation(dev, m, batch, 16, what="zoo (c) eval")
    del m
    tr = train_tiny(dev, width, img, batch)
    data, cfg, start = smoke_set(dev, width, img, batch, n_train, n_val, root=ZOO_DATA,
                                 runs=ZOO_RUNS, train_cfg=TINY_TRAIN_CFG, hyp=str(TINY_HYP))
    clis = cli_pair(dev, "zoo (c)", cfg, data, start, TINY_HYP, ZOO_RUNS, width, img, batch,
                    n_train, n_val, stripped=True)
    base = {}
    for name, size in baselines:
        t = time.perf_counter()
        m = make_model(dev, width, size, ZOO_CFGS / f"baseline/{name}.yaml")
        base[name] = serve_baseline(dev, m, batch, name in ZOO_AGREE, f"zoo (d) {name}")
        base[name]["s"] = time.perf_counter() - t
        del m
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    nms_res = check_nms_padded(dev)
    launches = {"K1": tiny["launches"]["K1"] + silu["launches"]["K1"] + nms_res["launches"]["K1"]
                + sum(r["launches"]["K1"] for r in base.values()),
                "K1L": det["launches"]["K1L"] + ev["launches"]["K1L"]
                + clis["launches_train"]["K1L"] + clis["launches_test"]["K1L"]
                + nms_res["launches"]["K1L"]}
    secs = time.perf_counter() - t_phase
    log(f"zoo: launches of its main paths {launches}; phase {secs:.1f} s")
    keys = ("replays", "img_s", "device_ms_bs8", "replay_ms_bs8", "eager_ms_bs8", "p50_ms_bs8",
            "p50_ms_bs1", "host_ms_infer_async", "enqueue_ms_bs8", "profile",
            "feature_rms_err", "feature_rms_err_cudnn_bf16", "agreement",
            "agreement_cudnn_bf16")
    return {"launches": launches, "tiny": {k: tiny.get(k) for k in keys},
            "tiny_silu": {k: silu.get(k) for k in keys}, "detect": det, "eval": ev,
            "train": tr, "clis": clis, "baselines": base, "nms_padded": nms_res["cases"],
            "phase_s": secs}


# substrings of the names of cuDNN's convolution kernels
CUDNN_NAMES = ("conv", "xmma", "cudnn", "cutlass", "gemm")


# the device kernels of the port's wrappers, as the trace names them
TRACED = ("nms_keep_kernel", "nms_mask_kernel", "nms_scan_kernel", "conv_silu_kernel",
          "int8_mm_kernel")


def profile_forwards(fn, what="profile", n=5):
    """Device time by kernel over n back-to-back forwards (torch.profiler,
    CUPTI), the device's busy share of their wall time, and the launches a
    forward of each of the port's kernels (TRACED) as the trace counts
    them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    groups = {"conv_silu (K2, K3)": 0.0, "nms (K1, K1L)": 0.0, "int8_mm (K4)": 0.0,
              "cuDNN conv": 0.0, "other": 0.0}
    top = []
    traced = {k: 0 for k in TRACED}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if e.device_type != torch.autograd.DeviceType.CUDA or not us:
            continue
        name = e.key
        g = ("conv_silu (K2, K3)" if "conv_silu" in name else
             "nms (K1, K1L)" if "nms_" in name else
             "int8_mm (K4)" if "int8_mm" in name else
             "cuDNN conv" if any(k in name.lower() for k in CUDNN_NAMES)
             else "other")
        groups[g] += us / 1e3 / n
        top.append((us / 1e3 / n, name[:70]))
        for k in TRACED:
            if k in name:
                traced[k] += e.count
    busy = sum(groups.values())
    if busy == 0.0:
        log(f"{what} profile: no device time recorded (not measured)")
        return {"profile": None}
    top.sort(reverse=True)
    log(f"{what} profile: {n} forwards, {wall_ms / n:.3f} ms wall each, device "
        f"busy {busy:.3f} ms ({busy / (wall_ms / n):.1%}); by group (ms/forward): "
        + ", ".join(f"{k} {v:.3f}" for k, v in groups.items()))
    traced = {k: c / n for k, c in traced.items()}
    log(f"{what} profile: top kernels (ms/forward): "
        + "; ".join(f"{name} {ms:.3f}" for ms, name in top[:8]))
    log(f"{what} profile: launches a forward in the trace: {traced}")
    return {"profile": {"wall_ms": wall_ms / n, "busy_ms": busy,
                        "busy_share": busy / (wall_ms / n), "groups_ms": groups,
                        "launches": traced}}


# ------------------------------------------ training on several ranks ---

def same_step(a, b) -> bool:
    """Two train steps' results (new TrainState, metrics) bit-equal."""
    (ta, ma), (tb, mb) = a, b
    names = ("params", "state", "opt_state", "ema_params", "ema_state")
    return (ta.step == tb.step and set(ma) == set(mb)
            and all(torch.equal(ma[k], mb[k]) for k in ma)
            and all(torch.equal(x, y) for n in names
                    for x, y in zip(tree_leaves(getattr(ta, n)), tree_leaves(getattr(tb, n)))))


def world1_step(dev, width=1.0, img=IMG, batch=BATCH):
    """(a) Phase 7's bf16 step through a one-rank group (NCCL on the card,
    gloo on the CPU) against the step without a group, bit for bit, then
    ms a step of both."""
    model = train_model(dev, width)
    plan, opt = model.plan, train_optim.OptimConfig()
    loss_fn = make_compute_loss_ota(plan.head, LossHyp())
    lr, mom = lr_after_warmup(opt)
    batch_np = train_batch(np.random.default_rng(7), batch, img)
    ts = init_train_state(model.params, model.state, opt, device=dev)
    del model
    group = init_distributed(0, 1, f"tcp://localhost:{free_port()}", dev.type)
    try:
        backend = dist.get_backend(group)
        steps = {"alone": make_train_step(plan, loss_fn, opt),
                 "group": make_train_step(plan, loss_fn, opt, mesh=group)}
        cudnn = torch.backends.cudnn
        deterministic = cudnn.deterministic
        cudnn.deterministic = True
        try:
            alone, control, grouped = (steps[k](ts, *batch_np, lr, mom)
                                       for k in ("alone", "alone", "group"))
        finally:
            cudnn.deterministic = deterministic
        control_equal, equal = same_step(alone, control), same_step(alone, grouped)
        items = {k: float(v) for k, v in grouped[1].items()}
        del alone, control, grouped
        log(f"ranks (a): the bf16 step at width {width}, {img} px, batch {batch} through a "
            f"one-rank {backend} group against the step without a group, cuDNN deterministic: "
            f"bit-equal {equal} (the step without a group twice: {control_equal}); items "
            f"{items}")
        if not control_equal:
            raise AssertionError("ranks (a): the step without a group is not deterministic")
        if not equal:
            raise AssertionError(f"ranks (a): the one-rank {backend} step is not bit-equal")
        timing = {"ms_step": None, "host_ms_step": None}
        if dev.type == "cuda":
            timing["ms_step"], timing["host_ms_step"] = {}, {}
            for k, fn in steps.items():
                timing["ms_step"][k] = cuda_ms(lambda fn=fn: fn(ts, *batch_np, lr, mom),
                                               iters=10, warmup=2)
                host = []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    fn(ts, *batch_np, lr, mom)
                    host.append((time.perf_counter() - t) * 1e3)
                timing["host_ms_step"][k] = statistics.median(host)
            torch.cuda.synchronize()
        log(f"ranks (a): ms a step (CUDA events, median of 10) {timing['ms_step']}, host ms a "
            f"step (enqueue, median of 5) {timing['host_ms_step']}: the group's cost is two "
            "collectives a BN layer, the loss's counts and the gradient buckets")
    finally:
        dist.destroy_process_group()
    return {"backend": backend, "bit_equal": equal, "items": items, **timing}


# the blocks that hold a max pool
POOLING = (L.MP, L.SP, L.SPP, L.SPPCSPC, L.DownC, L.Stem)


def pool_free_layers(plan):
    """The layers whose params reach the head through no max pool: neither
    a pooling block (MP, SP, SPP, SPPCSPC, DownC, Stem) nor upstream of
    one. Their
    gradient is continuous in the activations; a max pool's is not at
    near-ties, where another fp32 summation order can route a window's
    gradient to another input."""
    n = len(plan.layers)
    consumers = [[] for _ in range(n)]
    for i, spec in enumerate(plan.layers):
        for j in spec.frm if isinstance(spec.frm, tuple) else (spec.frm,):
            consumers[i - 1 if j == -1 else j].append(i)
    reaches = [False] * n
    for j in reversed(range(n)):
        reaches[j] = (isinstance(plan.layers[j].block, POOLING)
                      or any(reaches[i] for i in consumers[j]))
    return {j for j in range(n) if not reaches[j]}


def update_readings(plan, new, ref, old):
    """Two updates of the params from `old` (new - old against ref - old),
    per layer and in all (fp64, host): the relative L2 over all leaves,
    over the pool-free layers' (`pool_free_layers`) and over the others',
    the others' share of the squared distance, and the five layers that
    hold most of it (index, block, share, the layer's relative L2)."""
    per = []
    for a, b, o in zip(new["layers"], ref["layers"], old["layers"]):
        num = den = 0.0
        for x, y, z in zip(tree_leaves(a), tree_leaves(b), tree_leaves(o)):
            z = z.detach().double().cpu()
            dr = y.detach().double().cpu() - z
            num += float((x.detach().double().cpu() - z - dr).square().sum())
            den += float(dr.square().sum())
        per.append((num, den))
    free = pool_free_layers(plan)

    def rel(idx):
        num, den = sum(per[i][0] for i in idx), sum(per[i][1] for i in idx)
        return (num / den) ** 0.5 if den else 0.0

    total = sum(p[0] for p in per) or 1.0
    pooled = [i for i in range(len(per)) if i not in free]
    top = sorted(range(len(per)), key=lambda i: -per[i][0])[:5]
    return {"rel_l2": rel(range(len(per))), "pool_free_rel_l2": rel(sorted(free)),
            "pooled_rel_l2": rel(pooled),
            "pooled_share": sum(per[i][0] for i in pooled) / total,
            "top_layers": [(i, type(plan.layers[i].block).__name__, per[i][0] / total,
                            (per[i][0] / per[i][1]) ** 0.5 if per[i][1] else 0.0)
                           for i in top]}


def ranks_step(rank, world, group, dev, width, img, batch, batch_seed=5):
    """(b) on one rank: the fp32 step of `make_train_step(mesh=group)` on
    this rank's slice of the batch; rank 0 then runs the one-process fp32
    step on the whole batch from the same state, and holds the two (the
    other ranks wait). Two controls on rank 0 read how far the step itself
    moves under fp32 rounding: the one-process step again, and on the
    batch in reverse image order (the same function summed in other
    orders)."""
    model = train_model(torch.device("cpu"), width, seed=3)
    plan = model.plan
    opt = train_optim.OptimConfig()
    lr, mom = lr_after_warmup(opt)
    batch_np = train_batch(np.random.default_rng(batch_seed), batch, img)
    loss_fn = make_compute_loss_ota(plan.head, LossHyp())
    ts = init_train_state(model.params, model.state, opt, device=dev)
    sl = host_local_slice(batch, rank, world)
    step = make_train_step(plan, loss_fn, opt, mesh=group, compute_dtype=torch.float32)
    with full_fp32(dev.type == "cuda"):
        new, metrics = step(ts, *(a[sl] for a in batch_np), lr, mom)
    res = None
    if rank == 0:
        one = make_train_step(plan, loss_fn, opt, compute_dtype=torch.float32)
        with full_fp32(dev.type == "cuda"):
            ref, ref_m = one(ts, *batch_np, lr, mom)
            again = one(ts, *batch_np, lr, mom)[0]
            rev = one(ts, *(a[::-1].copy() for a in batch_np), lr, mom)[0]
        m, rm = ({k: float(v) for k, v in x.items()} for x in (metrics, ref_m))
        de = tree_update(new.ema_params, ts.ema_params)
        dre = tree_update(ref.ema_params, ts.ema_params)
        res = {"ranks": update_readings(plan, new.params, ref.params, ts.params),
               "again": update_readings(plan, again.params, ref.params, ts.params),
               "reversed": update_readings(plan, rev.params, ref.params, ts.params),
               "ema_update_rel_l2": float((de - dre).norm() / dre.norm()),
               "bn_state_rel_err": tree_rel_l2(new.state, ref.state),
               "item_rel_err": max(abs(m[k] - rm[k]) / abs(rm[k]) for k in rm),
               "losses_ranks": m, "losses_one": rm}
        res["update_rel_l2"] = res["ranks"]["rel_l2"]
    sync_processes("ranks (b)", group)
    return res


def ranks_trainer(world, dev, img, batch):
    """(c) on one rank: the trainer on phase 8's set from its start, one
    process a rank; on rank 0 each validation is run again with the plain
    keep-mask (which counts no launch) and must give the same metrics."""
    evals = []
    real_evaluate = trainer.evaluate

    def checked_evaluate(plan, params, state, loader, **kw):
        res = real_evaluate(plan, params, state, loader, **kw)
        with plain_nms():
            plain = real_evaluate(plan, params, state, loader, **kw)
        evals.append({k: (res[k], plain[k]) for k in ("map50", "map", "mp", "mr")})
        return res

    tc = trainer.TrainConfig(
        cfg=str(SMOKE_DATA / "model.yaml"), data=str(SMOKE_DATA / "data.yaml"),
        weights=str(SMOKE_DATA / "livened.ckpt"), epochs=PAR_EPOCHS, batch_size=batch,
        nominal_batch_size=CLI_NBS, warmup_accumulate=False, img_size=img,
        workers=CLI_WORKERS, save_dir=str(PAR_RUN), device=dev.type, n_data_devices=world)
    zero_counts()
    trainer.evaluate = checked_evaluate
    try:
        out = trainer.train(tc)
    finally:
        trainer.evaluate = real_evaluate
    return {"rows": out["results"], "launches": read_counts(), "evals": evals}


def ranks_main(rank, world, init_method, dev_type, width, img, batch):
    """One rank of (b) and (c): every rank on card 0 through gloo (NCCL
    takes one rank a card)."""
    if dev_type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world,
                            timeout=DIST_TIMEOUT)
    dev = torch.device(dev_type)
    step = ranks_step(rank, world, dist.group.WORLD, dev, width, img, batch)
    if dev_type == "cuda":
        torch.cuda.empty_cache()
    return {"step": step, "trainer": ranks_trainer(world, dev, img, batch)}


def ranks(dev, width=1.0, img=IMG, batch=BATCH, n_train=TRAIN_IMAGES, n_val=VAL_IMAGES):
    """Phase 10: training on several ranks. (a) in this process; (b) and (c)
    in PAR_RANKS spawned processes, gloo on the one card (each joined
    within PAR_TIMEOUT_S; a rank that fails or hangs fails the phase).
    Needs phase 8's set and start under build/."""
    t_phase = time.perf_counter()
    a = world1_step(dev, width, img, batch)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(PAR_RUN, ignore_errors=True)
    outs = launch(ranks_main, PAR_RANKS, args=(dev.type, width, img, batch),
                  timeout=PAR_TIMEOUT_S, threads=None if dev.type == "cuda" else 2)
    b = outs[0]["step"]
    for k in ("ranks", "again", "reversed"):
        r = b[k]
        log(f"ranks (b) {k}: relative L2 of the params' update from the one-process step's "
            f"{r['rel_l2']:.3g}: pool-free layers {r['pool_free_rel_l2']:.3g}, the others "
            f"{r['pooled_rel_l2']:.3g} ({r['pooled_share']:.4f} of the squared distance); "
            "top layers (index, block, share, relative L2): "
            + "; ".join(f"{i} {n} {sh:.3f} {e:.3g}" for i, n, sh, e in r["top_layers"]))
    log(f"ranks (b): one fp32 step on {PAR_RANKS} gloo ranks on one {dev.type} device, "
        f"{batch // PAR_RANKS} of the same {batch} images each, width {width}, {img} px, "
        f"against the one-process step on all {batch}: relative L2 of the params' update "
        f"{b['update_rel_l2']:.3g} and of the EMA params' {b['ema_update_rel_l2']:.3g} "
        f"(limit {PAR_UPDATE_L2}), of the pool-free layers' {b['ranks']['pool_free_rel_l2']:.3g} "
        f"(limit {PAR_POOL_FREE_L2}), loss items {b['item_rel_err']:.3g} (limit "
        f"{PAR_ITEM_RTOL}), BN state {b['bn_state_rel_err']:.3g} (limit {PAR_STATE_REL}); "
        f"losses {b['losses_ranks']}, one process {b['losses_one']}")
    if not max(b["update_rel_l2"], b["ema_update_rel_l2"]) <= PAR_UPDATE_L2:
        raise AssertionError(f"ranks (b): the updates lie {b['update_rel_l2']}, "
                             f"{b['ema_update_rel_l2']} from one process")
    if not b["ranks"]["pool_free_rel_l2"] <= PAR_POOL_FREE_L2:
        raise AssertionError(f"ranks (b): the pool-free layers' update lies "
                             f"{b['ranks']['pool_free_rel_l2']} from one process")
    if not b["item_rel_err"] <= PAR_ITEM_RTOL:
        raise AssertionError(f"ranks (b): loss items differ by {b['item_rel_err']}")
    if not b["bn_state_rel_err"] <= PAR_STATE_REL:
        raise AssertionError(f"ranks (b): BN state {b['bn_state_rel_err']}")

    c = [o["trainer"] for o in outs]
    rows = c[0]["rows"]
    items = [{k: v for k, v in r.items() if k.startswith("train/")} for r in rows]
    if any(o["rows"] != rows for o in c):
        raise AssertionError("ranks (c): the ranks returned different rows")
    if not all(math.isfinite(v) for r in items for v in r.values()) or len(items[0]) != 4:
        raise AssertionError(f"ranks (c): loss items {items}")
    evals = PAR_EPOCHS + 1
    want = {kid: 0 for kid in COUNTED} | {"K1L": evals * -(-n_val // batch)}
    if dev.type == "cuda" and c[0]["launches"] != want:
        raise AssertionError(f"ranks (c): rank 0's launch counts {c[0]['launches']}, want {want}")
    if any(c[r]["launches"]["K1L"] or c[r]["evals"] for r in range(1, PAR_RANKS)):
        raise AssertionError("ranks (c): a rank other than 0 validated")
    if len(c[0]["evals"]) != evals or any(k1l != plain for e in c[0]["evals"]
                                          for k1l, plain in e.values()):
        raise AssertionError(f"ranks (c): validations with K1L and the plain keep-mask "
                             f"{c[0]['evals']}")
    weights = PAR_RUN / "weights"
    blob = load_checkpoint(weights / "last.ckpt")
    if blob["opt_state"] is not None or blob["epoch"] != -1:
        raise AssertionError("ranks (c): last.ckpt is not stripped")
    load_checkpoint_any(str(weights / "last.ckpt"))
    lines = (PAR_RUN / "results.jsonl").read_text().strip().splitlines()
    if len(lines) != PAR_EPOCHS:
        raise AssertionError(f"ranks (c): results.jsonl holds {len(lines)} rows")
    img_s = [n_train // batch * batch / r["time_s"] for r in rows]
    log(f"ranks (c): the trainer on {PAR_RANKS} gloo ranks on one {dev.type} device, "
        f"{PAR_EPOCHS} epoch of {n_train} images, batch {batch} ({batch // PAR_RANKS} a rank) "
        f"x {CLI_NBS // batch}: rows {rows}; rank 0 validated {len(c[0]['evals'])} times, "
        f"launches {c[0]['launches']}, each equal with the plain keep-mask; last.ckpt "
        f"stripped and read back; img/s {img_s} ({PAR_RANKS} ranks on one card (gloo): not a "
        "multi-GPU rate)")
    secs = time.perf_counter() - t_phase
    log(f"ranks: phase {secs:.1f} s")
    return {"world1": a, "ranks_step": b,
            "trainer": {"rows": rows, "img_s_not_multi_gpu": img_s,
                        "evals": c[0]["evals"]},
            "launches": c[0]["launches"], "phase_s": secs}


# ---------------------------------------------------- entry points ---

TTA_SIDES = tuple(math.ceil(IMG * r / 32) * 32 for r in (1.0, 0.83, 0.67))   # 640, 544, 448
ENTRY_RUNS = ROOT / "build" / "smoke_runs" / "entry"
LOADER_THREADS = (1, CLI_WORKERS)


def tta_spans(side):
    """SPANS at a `side` px input: each span's rows scaled from 640 px
    (136/68/34/17 at 544, 112/56/28/14 at 448)."""
    return tuple((h * side // IMG, *rest) for h, *rest in SPANS)


def scale_of(rows, sides=TTA_SIDES):
    """The TTA input side whose maps (side / 2 ... side / 32) have `rows`
    rows (the sets are disjoint for 640, 544 and 448)."""
    for side in sides:
        if rows in {side >> k for k in range(1, 6)}:
            return side
    raise AssertionError(f"a conv_silu launch with {rows} output rows fits no TTA scale")


def tta_detect(dev, width=1.0, img=IMG, what="entry (a) TTA Detector"):
    """Phase 12 (a): phase 5's model and images through the bf16 Detector
    with augment=True, which keeps the serving rewrites on the card: the
    fused stem (K2) and the 8 fused spans (K3) at each of the three TTA
    scales (640, 544, 448 px inputs; the stem's phase-folded maps 320, 272,
    224 rows, the spans' 160-20, 136-17, 112-14), K1L once (4096
    candidates of 55,755 anchors an image). Each conv_silu launch of that
    run is held against the plain conv on its own slices as it runs, and
    K2 and K3 whole against their plain versions at the 544 and 448 px
    passes' shapes (`check_k2`, `check_k3`). Detections bit-equal with the
    plain keep-mask; agreement with the fp32 cuDNN TTA Detector at least
    the bf16 cuDNN TTA Detector's less MATCH_MARGIN; ms a call beside the
    Detector without TTA."""
    model, params, state, images = detect_model(dev, width, TRAIN_CFG, img)
    det = Detector(model.plan, params, state, img_size=img, dtype=torch.bfloat16,
                   augment=True, device=dev)
    n_stem, n_elan = plan_names(det)
    errs = [] if dev.type == "cuda" else None
    zero_counts()
    with recorded_launches(errs) as calls:
        got = det(images)
    counts = read_counts()
    per_scale = {side: 0 for side in TTA_SIDES}
    err_by_side = {side: 0.0 for side in TTA_SIDES}
    for ((_, _, _, y), _), err in zip(calls, errs or [0.0] * len(calls)):
        side = scale_of(y.shape[1])
        per_scale[side] += 1
        err_by_side[side] = max(err_by_side[side], err)
    del calls
    log(f"{what}: {sum(len(d) for d in got)} detections; launches {counts}; conv_silu "
        f"launches by input side {per_scale}, each held against the plain conv on its "
        f"own slices: max abs err by side {err_by_side}")
    want = {kid: 0 for kid in COUNTED} | {"K1L": 1, "K2": 3 * n_stem, "K3": 3 * n_elan}
    if dev.type == "cuda":
        if (n_stem, n_elan) != (1, 8) or counts != want:
            raise AssertionError(f"{what}: transforms {n_stem}, {n_elan}; launches {counts}, "
                                 f"want {want}")
        if set(per_scale.values()) != {3 * n_stem + 6 * n_elan}:
            raise AssertionError(f"{what}: conv_silu launches by scale {per_scale}")
    with plain_nms():
        plain = det(images)
        refs = {dt: Detector(model.plan, params, state, img_size=img, dtype=dt, augment=True,
                             fast_stem=False, device=dev)(images)
                for dt in (torch.float32, torch.bfloat16)}
    for i, (a, b) in enumerate(zip(got, plain)):
        if not np.array_equal(a, b):
            raise AssertionError(f"{what} image {i}: detections differ between K1L and the "
                                 "plain keep-mask")
    want32 = rows_out(refs[torch.float32])
    agree = agreement(what, rows_out(got), want32)
    agree_bf16 = agreement(f"{what} cuDNN bf16", rows_out(refs[torch.bfloat16]), want32)
    if not agree >= agree_bf16 - MATCH_MARGIN:
        raise AssertionError(f"{what}: agreement {agree:.3f}, cuDNN bf16 {agree_bf16:.3f}")
    ms = plain_ms = None
    fused = {}
    if dev.type == "cuda":
        ms = cuda_ms(lambda: det(images), iters=5, warmup=1)
        lone = Detector(model.plan, params, state, img_size=img, dtype=torch.bfloat16,
                        device=dev)
        plain_ms = cuda_ms(lambda: lone(images), iters=5, warmup=1)
        # K2 and K3 whole, against their plain versions, at the shapes the
        # smaller TTA passes give them (batch of the images, random weights)
        for side in TTA_SIDES[1:]:
            check_k2(dev, fused, side, len(images), key=f"K2_tta{side}", stages_alone=False)
            check_k3(dev, fused, tta_spans(side), len(images), key=f"K3_tta{side}",
                     stages_alone=False)
    log(f"{what}: bit-equal with the plain keep-mask; agree {agree:.3f} with the fp32 cuDNN "
        f"TTA Detector (cuDNN bf16 {agree_bf16:.3f}); one call on {len(images)} images "
        f"{ms} ms with TTA, {plain_ms} ms without")
    return {"launches": counts, "conv_silu_by_side": per_scale,
            "conv_silu_max_abs_err_by_side": err_by_side, "fused_at_tta_shapes": fused,
            "agreement": agree, "agreement_cudnn_bf16": agree_bf16,
            "detections": sum(len(d) for d in got), "ms": ms, "ms_without_tta": plain_ms}


def tta_evaluation(dev, m, batch=BATCH, n_images=16, what="entry (b) TTA evaluate"):
    """Phase 12 (b): `evaluate(augment=True)` in fp32 over phase 6's
    batches: K1L once a batch (8192 candidates); map50 / map / mp / mr
    equal with the plain keep-mask and with the global TF32 on;
    inference and NMS ms an image (of the second run: the first warms
    cuDNN up)."""
    batches = eval_batches(m, batch, n_images)
    # the plain keep-mask's run first: it also warms cuDNN up to the TTA
    # passes' new shapes, so the timed run below does not pay for that
    with plain_nms():
        plain = evaluate(m.plan, m.params, m.state, batches, augment=True, device=dev)
    zero_counts()
    got = evaluate(m.plan, m.params, m.state, batches, augment=True, device=dev)
    counts = read_counts()
    want = {kid: 0 for kid in COUNTED} | {"K1L": len(batches)}
    if dev.type == "cuda" and counts != want:
        raise AssertionError(f"{what}: launch counts {counts}, want {want}")
    with global_tf32(True):
        tf32 = evaluate(m.plan, m.params, m.state, batches, augment=True, device=dev)
    for key in ("map50", "map", "mp", "mr"):
        if not got[key] == plain[key] == tf32[key]:
            raise AssertionError(f"{what}: {key} {got[key]}, plain keep-mask {plain[key]}, "
                                 f"TF32 on {tf32[key]}")
    if not 0.0 < got["map50"] < 1.0:
        raise AssertionError(f"{what}: map50 {got['map50']}")
    log(f"{what}: map50 {got['map50']:.6f}, map {got['map']:.6f}, equal with the plain "
        f"keep-mask and with TF32 on; per image: inference "
        f"{got['speed_ms']['inference']:.3f} ms, NMS {got['speed_ms']['nms']:.3f} ms; "
        f"launches {counts}")
    return {"launches": counts, "map50": got["map50"], "map": got["map"],
            "speed_ms": got["speed_ms"], "plain_nms_ms": plain["speed_ms"]["nms"]}


def pt2_check(pt2, ckpt, batch=BATCH, img=IMG):
    """Run in a fresh process: load the `torch.export` program `pt2`
    (the K4 op registered by importing `ops/int8_mm` first), run it on
    noise frames on the card, and hold its `pred` against the eager
    forward of the exported checkpoint `ckpt` (`cli/export.Program`),
    under cuDNN's deterministic algorithms. Prints one JSON line: K4
    launches a forward of the loaded program, equality, ms of both."""
    from yolo_series_tpu_torch.cli.export import Program

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    dev = torch.device("cuda")
    prog = torch.export.load(str(pt2)).module()
    plan, params, state = load_checkpoint_any(str(ckpt))
    eager = Program(plan, params, state, dev)
    x = torch.from_numpy(np.random.default_rng(12).integers(
        0, 256, (batch, img, img, 3), np.uint8)).to(dev)
    with torch.no_grad():
        int8_mm.int8_matmul_dequant.launches = 0
        got = prog(x)
        torch.cuda.synchronize()
        k4 = int8_mm.int8_matmul_dequant.launches
        want = eager(x)
        out = {"k4_launches_a_forward": k4, "equal": bool(torch.equal(got, want)),
               "max_abs_err": float((got.float() - want.float()).abs().max()),
               "finite": bool(torch.isfinite(got).all()), "shape": list(got.shape),
               "ms_loaded": cuda_ms(lambda: prog(x), iters=5),
               "ms_eager": cuda_ms(lambda: eager(x), iters=5)}
    print(json.dumps(out))


def k4_op_host_ms(dev, plan, batch=BATCH, img=IMG, reps=5):
    """Host ms of the 41 K4 calls of one int8 forward through the
    registered op (`int8_matmul_dequant`) and through the launch alone
    (`_launch_k4`), each call enqueued without waiting (median of `reps`
    passes, the card drained between them): their difference is what the
    op adds to an eager int8 forward. A CUDA graph replays neither."""
    gen = torch.Generator().manual_seed(4)
    args = []
    for m, k, n in k4_shapes(plan, batch, img):
        args.append((_int8(gen, (m, k), dev), _int8(gen, (n, k), dev).t(),
                     (torch.rand(n, generator=gen) * 1e-2).to(dev),
                     torch.randn(n, generator=gen).to(dev)))
    out = {}
    for name, fn in (("op", int8_mm.int8_matmul_dequant),
                     ("launch", lambda *a: int8_mm._launch_k4(*a, None))):
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for a in args:
                fn(*a)
            times.append((time.perf_counter() - t) * 1e3)
        out[name] = statistics.median(times[1:])
    out["added"] = out["op"] - out["launch"]
    out["calls"] = len(args)
    return out


def export_cli(dev, src, calib, int8, batch=BATCH, img=IMG, what="entry (e) export CLI"):
    """`cli/export.py` on `src` (--int8 --calib-images `calib` or the
    plain deploy form), with --pt2 and --bench; then the program loaded in
    a fresh process (`pt2_check`): finite, its `pred` bit-equal with the
    eager forward, and under int8 K4 launched once a 1x1 conv (41) a
    forward. Returns the CLI's bench and the check's line."""
    kind = "int8" if int8 else "deploy"
    pt2 = ENTRY_RUNS / f"{kind}.pt2"
    argv = ["--weights", str(src), "--img-size", str(img), "--batch-size", str(batch),
            "--pt2", str(pt2), "--bench"] + (["--int8", "--calib-images", str(calib)]
                                              if int8 else [])
    if dev.type == "cpu":
        argv += ["--device", "cpu"]
    t = time.perf_counter()
    res = cli_export.main(argv)
    export_s = time.perf_counter() - t
    check = None
    if dev.type == "cuda":
        code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke as cs; "
                f"cs.pt2_check({str(pt2)!r}, {res['deploy']!r}, {batch}, {img})")
        p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                           text=True, timeout=600)
        if p.returncode != 0:
            raise AssertionError(f"{what} {kind}: the .pt2 check failed:\n{p.stderr[-4000:]}")
        check = json.loads(p.stdout.strip().splitlines()[-1])
        want_k4 = 41 if int8 else 0
        if (check["k4_launches_a_forward"] != want_k4 or not check["equal"]
                or not check["finite"]):
            raise AssertionError(f"{what} {kind}: {check}, want {want_k4} K4 launches and "
                                 "a pred equal to the eager forward's")
    log(f"{what} {kind}: {res}; export {export_s:.1f} s (trace included); the .pt2 in a "
        f"fresh process: {check}")
    return {"bench": res["bench"], "pt2": check, "export_s": export_s,
            "pt2_bytes": pt2.stat().st_size}


def device_aug_agreement(dev, img=IMG, batch=BATCH):
    """make_device_augment (mosaic form, separable and gather) on the card
    against the same call on the CPU, on tiles and parameters of a
    device-tail batch of phase 8's set: within two levels (a warp value
    within an ulp of .5 rounding the other way, then the HSV gains), and at
    most 1% of the values more than 1e-5 apart. ms of the separable
    batch on the card."""
    ds = DetectionDataset(str(SMOKE_DATA / "train" / "images"), img_size=img, augment=True,
                          hyp=trainer.load_hyp(None), device_tail=True, seed=0)
    b = next(iter(create_loader(ds, batch_size=batch, hold=2)))
    out = {}
    for separable in (True, False):
        fn = make_device_augment(img, 2 * img, separable=separable, mosaic=True)
        host = [torch.from_numpy(np.array(b[k])) for k in MOSAIC_KEYS]
        want = fn(*host)
        got = fn(*(t.to(dev) for t in host)).cpu()
        d = (got - want).abs()
        share = float((d > 1e-5).float().mean())
        out["separable" if separable else "gather"] = {"max_abs_err": float(d.max()),
                                                       "share_above_1e-5": share}
        if float(d.max()) > 2 / 255 + 1e-6 or share > 0.01:
            raise AssertionError(f"device aug (separable={separable}) card against CPU: "
                                 f"{out}")
        if separable and dev.type == "cuda":
            args = [t.to(dev) for t in host]
            out["ms_batch"] = cuda_ms(lambda: fn(*args), iters=5)
    log(f"entry (f) device aug on the card against the CPU, batch {batch} at {img} px: {out}")
    return out


def device_loader_img_s(dev, data_dir, img, batch, workers):
    """img/s of one epoch of the device-tail loader and the device program
    after it (upload, compose, warp, HSV, flips, mixup), no step."""
    ds = DetectionDataset(str(data_dir), img_size=img, batch_size=batch, augment=True,
                          hyp=trainer.load_hyp(None), device_tail=True, seed=0)
    fn = make_device_augment(img, 2 * img, separable=True, mosaic=True)
    upload = trainer.BatchUpload(dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    n = 0
    for b in create_loader(ds, batch_size=batch, workers=workers, hold=2):
        n += len(fn(*(upload([b[k]]) for k in MOSAIC_KEYS)))
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t)


def entry_points(dev, m, host_tail, width=1.0, img=IMG, batch=BATCH):
    """Phase 12, the entry points phases 1-11 left out: (a) the TTA
    Detector, (b) `evaluate(augment=True)`, (c) `cli/test.py --augment`,
    (d) `hub.yolov7()` and `hub.yolov7_tiny()`, (e) `cli/export.py` with
    and without --int8 (--pt2, --bench) and the K4 op's host cost, (f)
    the device-augment tail: card against CPU, the loader's img/s, and
    `cli/train.py --device-aug` for one epoch on phase 8's set beside
    phase 8's host-tail epochs (`host_tail`)."""
    from yolo_series_tpu_torch import hub

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    on_cpu = [] if cuda else ["--device", "cpu"]
    shutil.rmtree(ENTRY_RUNS, ignore_errors=True)
    ENTRY_RUNS.mkdir(parents=True)
    launches = {kid: 0 for kid in COUNTED}

    def add(counts):
        for kid, n in counts.items():
            launches[kid] += n

    det = tta_detect(dev, width, img)
    add(det["launches"])
    ev = tta_evaluation(dev, m, batch)
    add(ev["launches"])

    # (e) first: it writes the deploy checkpoint (c) tests
    src = ENTRY_RUNS / "w.ckpt"
    shutil.copy(SMOKE_DATA / "livened.ckpt", src)
    calib = SMOKE_DATA / "val" / "images"
    zero_counts()
    exports = {kind: export_cli(dev, src, calib, kind == "int8", batch, img)
               for kind in ("deploy", "int8")}
    add(read_counts())   # the benches' engines: warm-up and capture
    op_ms = None
    if cuda:
        plan, _, _ = load_checkpoint_any(str(ENTRY_RUNS / "w.int8.ckpt"))
        op_ms = k4_op_host_ms(dev, plan, batch, img)
        log(f"entry (e) K4 op: host ms of the {op_ms['calls']} K4 calls of one eager int8 "
            f"forward: {op_ms['op']:.3f} through the op, {op_ms['launch']:.3f} launched "
            f"directly; the op adds {op_ms['added']:.3f} ms")

    # (c) the test CLI with --augment on the exported deploy checkpoint
    def test_cli(name):
        return cli_test.main(["--weights", str(ENTRY_RUNS / "w.deploy.ckpt"), "--data",
                              str(SMOKE_DATA / "data.yaml"), "--img-size", str(img),
                              "--batch-size", str(batch), "--augment", "--project",
                              str(ENTRY_RUNS), "--name", name] + on_cpu)

    with plain_nms():   # first: it warms cuDNN up to the rect batches' TTA shapes
        test_plain = test_cli("test_tta_plain")
    zero_counts()
    test = test_cli("test_tta")
    test_counts = read_counts()
    add(test_counts)
    n_val = len(list((SMOKE_DATA / "val" / "images").glob("*.jpg")))
    want = {kid: 0 for kid in COUNTED} | {"K1L": -(-n_val // batch)}
    if cuda and test_counts != want:
        raise AssertionError(f"entry (c) test CLI --augment: launch counts {test_counts}, "
                             f"want {want}")
    for key in ("map50", "map", "mp", "mr"):
        if test[key] != test_plain[key] or not math.isfinite(test[key]):
            raise AssertionError(f"entry (c) test CLI --augment: {key} {test[key]}, plain "
                                 f"keep-mask {test_plain[key]}")
    log(f"entry (c) test CLI --augment on w.deploy.ckpt: map50 {test['map50']:.6f}, map "
        f"{test['map']:.6f}, equal with the plain keep-mask; {test['speed_ms']} ms an image; "
        f"launches {test_counts}")

    # (d) the hub's named constructors on the card
    hubs = {}
    _, _, _, images = detect_model(dev, width, TRAIN_CFG, img)
    for name, ctor, want_k in (("yolov7", hub.yolov7, {"K1L": 1, "K2": 1, "K3": 8}),
                               ("yolov7_tiny", hub.yolov7_tiny, {"K1L": 1})):
        d = ctor(device=dev.type, img_size=img)
        zero_counts()
        rows = d(images)
        counts = read_counts()
        add(counts)
        if any(r.ndim != 2 or r.shape[1] != 6 or not np.isfinite(r).all() for r in rows):
            raise AssertionError(f"entry (d) hub.{name}: rows {[r.shape for r in rows]}")
        if cuda and counts != {kid: 0 for kid in COUNTED} | want_k:
            raise AssertionError(f"entry (d) hub.{name}: launch counts {counts}")
        hubs[name] = {"launches": counts, "detections": sum(len(r) for r in rows),
                      "ms": cuda_ms(lambda: d(images), iters=5) if cuda else None}
    log(f"entry (d) hub: {hubs}")

    # (f) the device tail
    aug = device_aug_agreement(dev, img, batch)
    loader = None
    if cuda:
        data_dir = SMOKE_DATA / "train" / "images"
        loader = {f"{tail}_{w}": (device_loader_img_s(dev, data_dir, img, batch, w)
                                  if tail == "device" else loader_img_s(data_dir, img, batch, w))
                  for tail in ("device", "host") for w in LOADER_THREADS}
        log(f"entry (f) loader img/s by tail and threads: {loader}")
    zero_counts()
    out = cli_train.main(["--cfg", str(SMOKE_DATA / "model.yaml"), "--data",
                          str(SMOKE_DATA / "data.yaml"), "--weights",
                          str(SMOKE_DATA / "livened.ckpt"), "--epochs", "1", "--batch-size",
                          str(batch), "--nbs", str(CLI_NBS), "--no-warmup-accumulate",
                          "--img-size", str(img), "--workers", str(CLI_WORKERS),
                          "--device-aug", "--noval", "--project", str(ENTRY_RUNS),
                          "--name", "train_device_aug"] + on_cpu)
    train_counts = read_counts()
    add(train_counts)
    row = out["results"][0]
    items = {k: v for k, v in row.items() if k.startswith("train/")}
    if len(items) != 4 or not all(math.isfinite(v) for v in items.values()):
        raise AssertionError(f"entry (f) train CLI --device-aug: loss items {items}")
    n_train = len(list((SMOKE_DATA / "train" / "images").glob("*.jpg")))
    epoch = {"img_s": n_train / row["time_s"], "wait_share": row["wait_s"] / row["time_s"],
             "loss": items} if cuda else {"loss": items}
    log(f"entry (f) train CLI --device-aug, 1 epoch of {n_train} images: {epoch}; phase 8's "
        f"host-tail epochs {host_tail}")
    secs = time.perf_counter() - t_phase
    log(f"entry points: phase {secs:.1f} s; launches {launches}")
    return {"launches": launches, "tta_detect": det, "tta_eval": ev,
            "test_cli_augment": {k: test[k] for k in ("map50", "map", "mp", "mr", "speed_ms")},
            "hub": hubs, "export": exports, "k4_op_host_ms": op_ms, "device_aug": aug,
            "loader_img_s": loader, "train_device_aug": epoch,
            "host_tail_epochs": host_tail, "phase_s": secs}


def _cfg(width, path=CFG):
    """The port's yolov7 cfg (deploy, or `path`: a file, or a cfg dict) at
    `width` (1.0: the published one)."""
    import copy

    import yaml

    if isinstance(path, dict):
        d = copy.deepcopy(path)
    else:
        with open(path) as f:
            d = yaml.safe_load(f)
    d["width_multiple"] = width
    return d


# ------------------------------------------------------- the zoo's tail ---

# (a) the tail zoo: the long-tail cfg of tests/test_graph.py:70-89 (its
# rows marked *) with a row of every block of the JAX package's layers.py
# that no shipped cfg uses, at yolov7's published channels (64-1024), nc
# 80, yolov7's anchors on three levels; at 640 px the Swin and Transformer
# blocks see the stride-32 map, 20 x 20 (the window 8 pads it to 24, and
# the second Swin layer is shifted and masked)
TAIL_CFG = {
    "name": "tail-zoo", "nc": 80, "depth_multiple": 1.0, "width_multiple": 1.0,
    "anchors": [[12, 16, 19, 36, 40, 28], [36, 75, 76, 55, 72, 146],
                [142, 110, 192, 243, 459, 401]],
    "backbone": [
        [-1, 1, "Focus", [64, 3]],                      # 0  /2
        [-1, 1, "nn.Conv2d", [64, 3, 1, 1]],
        [-1, 1, "GhostStem", [128]],                    # 2  /8   *
        [-1, 1, "DWConv", [128, 3, 1]],
        [-1, 1, "GhostConv", [256, 3, 2]],              # 4  /16
        [-1, 1, "Ghost", [256, 3, 1]],
        [-1, 1, "GhostCSPA", [256]],
        [-1, 1, "RobustConv", [256, 7, 1]],             # *
        [-1, 1, "CrossConv", [256, 3, 1]],              # *
        [-1, 1, "MixConv2d", [256]],                    # 9  *
        [-1, 1, "Ghost", [512, 3, 2]],                  # 10 /32
        [-1, 1, "GhostCSPB", [512]],
        [-1, 2, "STCSPA", [512]],                       # *
        [-1, 1, "TransformerBlock", [512, 4, 1]],       # *
        [[-1, -2], 1, "Sum", [2]],                      # *
        [-1, 1, "GhostCSPC", [512]],
        [-1, 1, "SPPF", [512, 5]],                      # 16
        [-1, 1, "Contract", [2]],                       # 17 /64
        [-1, 1, "Expand", [2]],                         # 18 /32
        [[-1, 16], 1, "Chuncat", [1]],
        [-1, 1, "Foldcut", []],
        [-1, 1, "nn.BatchNorm2d", []],
    ],
    "head": [
        [-1, 1, "GhostSPPCSPC", [512]],                 # 22 *
        [-1, 1, "RepConv_OREPA", [1024, 3, 1]],         # 23 *
        [[3, 9, 23], 1, "IDetect", ["nc", "anchors"]],  # *
    ],
}
TAIL_REQUESTS = 4
# the fused model's fp32 forward on the card against the CPU's (TF32 off):
# relative RMS of the head inputs, and Classify's output
TAIL_CPU_RMS = 1e-4
# (b) the pose model at POSE_IMG px
POSE_IMG = 960
# (c) the IBin train steps timed
IBIN_STEPS = 3
# the ranking losses and their gradients on the card against the CPU, and
# OREPA's deploy against its train form (the JAX package's own limits,
# tests/test_zoo.py:39-49)
RANK_RTOL = 1e-4
OREPA_RTOL, OREPA_ATOL = 1e-3, 1e-4


def pose_cfg(width=1.0):
    """The pose model of upstream yolov7's cfg/yolov7-w6-pose.yaml from the
    port's yolov7-w6 training cfg: nc 1, its four aux convs and the
    IAuxDetect row replaced by IKeypoint [nc, anchors, 17] over the four
    lead convs."""
    cfg = _cfg(width, ZOO_CFGS / "training/yolov7-w6.yaml")
    f, _, kind, _ = cfg["head"][-1]
    if kind.lower() != "iauxdetect" or len(f) != 8:
        raise AssertionError(f"yolov7-w6's last row is {cfg['head'][-1]}")
    cfg["head"] = cfg["head"][:-5] + [[f[:4], 1, "IKeypoint", ["nc", "anchors", 17]]]
    return cfg | {"nc": 1, "names": ["person"], "name": "yolov7-w6-pose"}


def ibin_cfg(width=1.0):
    """yolov7's training cfg with its IDetect row an IBin head."""
    cfg = _cfg(width, TRAIN_CFG)
    if cfg["head"][-1][2].lower() != "idetect":
        raise AssertionError(f"yolov7's last row is {cfg['head'][-1]}")
    cfg["head"][-1] = [cfg["head"][-1][0], 1, "IBin", ["nc", "anchors"]]
    return cfg | {"name": "yolov7-ibin"}


def _rel_rms(got, want):
    return float((got.float().cpu() - want.float().cpu()).square().mean().sqrt()
                 / want.float().cpu().square().mean().sqrt())


def check_orepa(dev, plan):
    """RepConv_OREPA of `plan` at its input shape (batch 8): its deploy
    against its train form's eval forward, fp32, TF32 off."""
    i, spec = next((i, s) for i, s in enumerate(plan.layers)
                   if isinstance(s.block, X.RepConvOREPA))
    blk = spec.block
    gen = torch.Generator().manual_seed(13)
    p, st = blk.init(gen)
    for leaf in tree_leaves(st):   # running stats off (0, 1)
        leaf.copy_(torch.rand(leaf.shape, generator=gen) + 0.5)
    p, st = tree_map(lambda t: t.to(dev), p), tree_map(lambda t: t.to(dev), st)
    x = torch.randn((BATCH, blk.c1, 20, 20), generator=gen).to(dev)
    with torch.no_grad(), full_fp32(dev.type == "cuda"):
        y, _ = blk.apply(p, st, x, L.Ctx())
        dp, ds = blk.deploy(p, st)
        y2, _ = blk.apply(dp, ds, x, L.Ctx())
    err = float((y2 - y).abs().max())
    ok = bool(torch.allclose(y2, y, rtol=OREPA_RTOL, atol=OREPA_ATOL))
    log(f"tail (a): layer {i} RepConv_OREPA({blk.c1}, {blk.c2}) deploy against its train "
        f"form at ({BATCH}, {blk.c1}, 20, 20), fp32: max |diff| {err:.3g} (rtol "
        f"{OREPA_RTOL}, atol {OREPA_ATOL})")
    if not ok:
        raise AssertionError(f"tail (a): OREPA deploy differs from its train form by {err}")
    return err


def tail_cpu(dev, m, img):
    """The fused tail model's fp32 forward (batch 1) on the card, TF32 off,
    against the CPU's on the same frame (the head inputs' relative RMS);
    Classify(1024, 1000) on the stride-32 map's shape alone, card against
    CPU."""
    frame = torch.from_numpy(np.random.default_rng(21).integers(
        0, 256, (1, img, img, 3), np.uint8)).float() / 255.0
    cpu = {"plan": m.plan, "params": tree_map(lambda t: t.cpu(), m.params),
           "state": tree_map(lambda t: t.cpu(), m.state)}
    with torch.no_grad():
        want, _ = apply_model(cpu["plan"], cpu["params"], cpu["state"], frame,
                              return_head_inputs=True)
        with full_fp32(dev.type == "cuda"):
            got, _ = apply_model(m.plan, m.params, m.state, frame.to(dev),
                                 return_head_inputs=True)
    err = max(_rel_rms(g, w) for g, w in zip(got, want))
    blk = X.Classify(1024, 1000)
    gen = torch.Generator().manual_seed(17)
    p, _ = blk.init(gen)
    x = torch.randn((BATCH, 1024, img // 32, img // 32), generator=gen)
    with torch.no_grad():
        c_want, _ = blk.apply(p, {}, x, L.Ctx())
        with full_fp32(dev.type == "cuda"):
            c_got, _ = blk.apply(tree_map(lambda t: t.to(dev), p), {}, x.to(dev), L.Ctx())
    c_err = _rel_rms(c_got, c_want)
    log(f"tail (a): the fused model's fp32 forward, card against CPU: head inputs "
        f"{err:.3g} relative RMS; Classify(1024, 1000) {tuple(c_got.shape)} {c_err:.3g} "
        f"(limit {TAIL_CPU_RMS})")
    if not (err <= TAIL_CPU_RMS and c_err <= TAIL_CPU_RMS and c_got.shape == (BATCH, 1000)):
        raise AssertionError(f"tail (a): card against CPU {err}, Classify {c_err}")
    return {"head_inputs_rel_rms": err, "classify_rel_rms": c_err}


def tail_zoo(dev, width=1.0, img=IMG, batch=BATCH, requests=TAIL_REQUESTS):
    """(a) The tail zoo cfg: OREPA's deploy, card against CPU, then served
    by the bf16 graph engines as phase 4 serves yolov7 (no fused stem or
    span matches: every conv is cuDNN's; K1 once a forward)."""
    m = make_model(dev, width, img, TAIL_CFG)
    names = {type(s.block).__name__ for s in m.plan.layers}
    log(f"tail (a): {m.name}, {len(m.plan.layers)} layers, {m.n_params} params, blocks "
        f"{sorted(names)}")
    orepa = check_orepa(dev, m.plan)
    cpu = tail_cpu(dev, m, img)
    res = serving(dev, m, batch, requests, what="tail (a) serving", transforms=(0, 0),
                  with_ingest=False)
    return {"orepa_deploy_max_err": orepa, **cpu, **res}


def _kpt_rows(out):
    """batched_nms_kpt's tuple as the engine's output dict."""
    num, boxes, scores, classes, _ = (t.cpu().numpy() for t in out)
    return {"num_dets": num[:, None], "det_boxes": boxes, "det_scores": scores,
            "det_classes": classes}


def kpt_error(got, want, conf_thres=0.25):
    """The keypoints (x, y, visibility of each) of the anchors that the fp32
    pred `want` scores above conf_thres (the rows that can become
    detections) in `got` against `want`: (relative RMS, max abs px of x and
    y). The same anchors on both sides, so the numbers measure the head's
    decode and what feeds it, not which detections NMS kept."""
    cand = (want[..., 4] * want[..., 5]).float() > conf_thres
    g, w = got[cand][:, 6:].float().cpu(), want[cand][:, 6:].float().cpu()
    if not (torch.isfinite(g).all() and len(w)):
        raise AssertionError(f"keypoints: non-finite, or no candidate of {cand.numel()} anchors")
    xy = torch.ones(w.shape[1], dtype=torch.bool)
    xy[2::3] = False
    rel = float((g - w).square().mean().sqrt() / w.square().mean().sqrt())
    return rel, float((g - w)[:, xy].abs().max())


def pose(dev, width=1.0, img=POSE_IMG, batch=BATCH):
    """(b) The w6 pose model, livened and fused, with the serving rewrites
    (K3 on its spans), bf16, then `batched_nms_kpt` at max_nms 256 (K1).
    Each conv_silu launch of that forward is held against the plain conv on
    its own slices as it runs, and K3 whole against its plain version at
    the spans' shapes (`check_k3`); the keypoints of the candidate anchors
    against the fp32 forward's (`kpt_error`) within FEAT_RATIO of the bf16
    cuDNN forward's distance."""
    model = Model.from_yaml(pose_cfg(width), seed=0, device=dev)
    rng = np.random.default_rng(23)
    calib = torch.from_numpy(rng.integers(0, 256, (2, img, img, 3), np.uint8))
    liven(model.plan, model.params, model.state, calib.to(dev).float() / 255.0)
    params, state = fuse_model(model.plan, model.params, model.state)
    span_shapes = model_spans(SimpleNamespace(plan=model.plan, params=params, img=img))
    plan_t, params_t, state_t = serving_transforms(model.plan, params, state)
    params_t, state_t = place(params_t, state_t, dev, torch.bfloat16)
    spans = [type(s.block).__name__ for s in plan_t.layers].count("FusedELAN")
    frames = torch.from_numpy(rng.integers(0, 256, (batch, img, img, 3), np.uint8)).to(dev)

    def forward(plan, p, s, dtype):
        with torch.inference_mode():
            return apply_model(plan, p, s, frames.to(dtype) / 255.0, dtype=dtype)[0]["pred"]

    log(f"pose (b): {cfg_name(pose_cfg(width))} width {width}, {model.num_params()} params, "
        f"{img} px, batch {batch}, bf16, fused, {spans} FusedELAN; spans (H, cin, ct, cc, "
        f"cout, order) {span_shapes}")
    if dev.type == "cuda" and spans == 0:
        raise AssertionError("pose (b): no ELAN span matched")
    errs = [] if dev.type == "cuda" else None
    zero_counts()
    with recorded_launches(errs) as calls:
        pred = forward(plan_t, params_t, state_t, torch.bfloat16)
    out = batched_nms_kpt(pred)
    counts = read_counts()
    n_calls = len(calls)
    del calls
    want = {kid: 0 for kid in COUNTED} | {"K1": 1, "K3": spans}
    conv_err = max(errs) if errs else None
    log(f"pose (b): pred {tuple(pred.shape)}; {int(out[0].sum())} detections; launches "
        f"{counts}; {n_calls} conv_silu launches, each held against the plain conv on its "
        f"own slices: max abs err {conv_err}")
    if dev.type == "cuda" and (counts != want or n_calls != len(SPAN_LAUNCHES) * spans):
        raise AssertionError(f"pose (b): launch counts {counts}, want {want}; {n_calls} "
                             f"conv_silu launches")
    with plain_nms():
        plain = batched_nms_kpt(pred)
    for field, a, b in zip(("num_dets", "boxes", "scores", "classes", "keypoints"), out, plain):
        if not torch.equal(a, b):
            raise AssertionError(f"pose (b): {field} differ between K1 and the plain keep-mask")
    p16 = tree_map(lambda t: t.to(torch.bfloat16) if t.dtype == torch.float32 else t, params)
    with full_fp32(dev.type == "cuda"):
        pred32 = forward(model.plan, params, state, torch.float32)
    pred16 = forward(model.plan, p16, state, torch.bfloat16)
    with plain_nms():
        want32 = _kpt_rows(batched_nms_kpt(pred32))
        ref16 = _kpt_rows(batched_nms_kpt(pred16))
    agree = agreement("pose (b)", _kpt_rows(out), want32)
    agree_bf16 = agreement("pose (b) cuDNN bf16", ref16, want32)
    kpt_rel, kpt_px = kpt_error(pred, pred32)
    kpt_rel16, kpt_px16 = kpt_error(pred16, pred32)
    del pred16, pred32
    log(f"pose (b): NMS output bit-equal with K1 and with the plain keep-mask, keypoints "
        f"included; detections agree {agree:.3f} with the fp32 forward (cuDNN bf16 "
        f"{agree_bf16:.3f}, margin {MATCH_MARGIN}); keypoints of the fp32 forward's "
        f"candidate anchors against it: relative RMS {kpt_rel:.4g}, max abs x/y {kpt_px:.4g} "
        f"px (cuDNN bf16 {kpt_rel16:.4g}, {kpt_px16:.4g} px; limit {FEAT_RATIO} x)")
    if not agree >= agree_bf16 - MATCH_MARGIN:
        raise AssertionError(f"pose (b): agreement {agree:.3f}, cuDNN bf16 {agree_bf16:.3f}")
    if not kpt_rel <= FEAT_RATIO * kpt_rel16:
        raise AssertionError(f"pose (b): keypoints {kpt_rel:.4g} relative RMS from fp32, "
                             f"cuDNN bf16 {kpt_rel16:.4g}")
    res = {"launches": counts, "spans": spans, "detections": int(out[0].sum()),
           "agreement": agree, "agreement_cudnn_bf16": agree_bf16,
           "kpt_rel_rms_fp32": kpt_rel, "kpt_max_abs_px_fp32": kpt_px,
           "kpt_rel_rms_fp32_cudnn_bf16": kpt_rel16, "kpt_max_abs_px_fp32_cudnn_bf16": kpt_px16,
           "conv_silu_launches": n_calls, "conv_silu_max_abs_err": conv_err,
           "forward_ms": None, "nms_ms": None, "fused_at_pose_shapes": {}}
    if dev.type == "cuda":
        res["forward_ms"] = cuda_ms(lambda: forward(plan_t, params_t, state_t, torch.bfloat16),
                                    iters=5, warmup=1)
        res["nms_ms"] = cuda_ms(lambda: batched_nms_kpt(pred), iters=20, warmup=3)
        del pred, out, plain
        # K3 whole against its plain version at the 11 spans' shapes
        # (random weights, the forward's batch)
        check_k3(dev, res["fused_at_pose_shapes"], span_shapes, batch, key="K3_pose",
                 stages_alone=False)
    log(f"pose (b): ms a forward (batch {batch}, {img} px) {res['forward_ms']}, ms of "
        f"batched_nms_kpt {res['nms_ms']}; card {smi() if dev.type == 'cuda' else 'none'}")
    return res


def check_ranking(dev, n=4096):
    """The ranking losses (RankSort's identity-update gradient, AP and aLRP
    with plain gradients) and SigmoidBin's bf16 decode with tied bins, on
    the card against the CPU on the same inputs."""
    gen = torch.Generator().manual_seed(29)
    logits = torch.randn(n, generator=gen) * 2
    logits[10:40] = logits[0]
    targets = torch.zeros(n)
    fg = torch.randperm(n, generator=gen)[:n // 16]
    targets[fg] = torch.rand(len(fg), generator=gen) * 0.7 + 0.3
    valid = torch.ones(n, dtype=torch.bool)
    valid[-64:] = False
    quality = torch.rand(n, generator=gen)
    fns = {"rank_sort": lambda x, t, v, q: rank_sort_loss(x, t, v),
           "ap": lambda x, t, v, q: ap_loss(x, t, v),
           "alrp": lambda x, t, v, q: sum(alrp_loss(x, t, q, v))}
    errs = {}
    for name, fn in fns.items():
        res = []
        for where in (dev, torch.device("cpu")):
            x = logits.to(where).requires_grad_()
            with full_fp32(where.type == "cuda"):
                val = fn(x, targets.to(where), valid.to(where), quality.to(where))
            (g,) = torch.autograd.grad(val, [x])
            res.append((val.detach().cpu(), g.cpu()))
        (vc, gc), (vh, gh) = res
        errs[name] = {"value": float((vc - vh).abs() / vh.abs().clamp(min=1e-30)),
                      "grad": float((gc - gh).abs().max() / gh.abs().max().clamp(min=1e-30))}
    sb = SigmoidBin(21, 0.0, 4.0)
    pred = torch.rand((4096, sb.length), generator=gen)
    pred[:2048, 3] = pred[:2048, 9] = 1.0
    pred = pred.to(torch.bfloat16)
    same = torch.equal(sb.forward(pred.to(dev)).cpu(), sb.forward(pred))
    log(f"tail (c): ranking losses on {n} logits, card against CPU (relative; limit "
        f"{RANK_RTOL}): {errs}; SigmoidBin's decode of bf16 rows with tied bins bit-equal "
        f"{same}")
    if not same:
        raise AssertionError("tail (c): SigmoidBin's bf16 decode differs on the card")
    if not all(e <= RANK_RTOL for d in errs.values() for e in d.values()):
        raise AssertionError(f"tail (c): ranking losses differ: {errs}")
    return {"ranking_rel_err": errs, "sigmoid_bin_bf16_equal": same}


def ibin_train(dev, width=1.0, img=IMG, batch=BATCH):
    """(c) yolov7 with an IBin head: three bf16 bin-OTA steps at `img` px,
    batch `batch` (ms and host ms a step), a fp32 step at width 0.25 card
    against CPU, the livened and fused model through the bf16 Detector
    (K1L at 4096 candidates, bit-equal with the plain keep-mask), the
    ranking losses and SigmoidBin's bf16 decode."""
    cfg = ibin_cfg(width)
    model = train_model(dev, width, cfg=cfg)
    plan, opt = model.plan, train_optim.OptimConfig()
    if not isinstance(plan.head, H.IBin):
        raise AssertionError(f"tail (c): head {type(plan.head).__name__}")
    step = make_train_step(plan, make_compute_loss_bin_ota(plan.head, LossHyp()), opt,
                           compute_dtype=torch.bfloat16)
    lr, mom = lr_after_warmup(opt)
    batch_np = train_batch(np.random.default_rng(31), batch, img)
    ts = init_train_state(model.params, model.state, opt, device=dev)
    zero_counts()
    totals = []
    for _ in range(IBIN_STEPS):
        ts, metrics = step(ts, *batch_np, lr, mom)
        totals.append(float(metrics["total"]))
    counts = read_counts()
    if not all(math.isfinite(t) for t in totals):
        raise AssertionError(f"tail (c): bin-OTA losses {totals}")
    timing = {"ms_step": None, "host_ms_step": None}
    if dev.type == "cuda":
        timing = step_timing(lambda: step(ts, *batch_np, lr, mom), batch, iters=IBIN_STEPS)
    log(f"tail (c): {cfg_name(cfg)} width {width}, {img} px, batch {batch}, bf16, bin-OTA: "
        f"losses {totals}; launches {counts} (the step runs no kernel of the port); "
        f"{timing}")
    del ts
    fp32 = check_fp32_step(dev, cfg=cfg, what="tail (c) fp32 step",
                           make_loss=make_compute_loss_bin_ota)

    model = Model.from_yaml(cfg, seed=1, device=dev)
    rng = np.random.default_rng(37)
    calib = torch.from_numpy(rng.integers(0, 256, (2, img, img, 3), np.uint8))
    liven(model.plan, model.params, model.state, calib.to(dev).float() / 255.0)
    params, state = fuse_model(model.plan, model.params, model.state)
    images = [noise_image(rng, hw, img) for hw in DATA_SHAPES]
    det = Detector(model.plan, params, state, img_size=img, dtype=torch.bfloat16, device=dev)
    zero_counts()
    got = det(images)
    det_counts = read_counts()
    with plain_nms():
        plain = det(images)
    for i, (a, b) in enumerate(zip(got, plain)):
        if not np.array_equal(a, b):
            raise AssertionError(f"tail (c) image {i}: detections differ between K1L and "
                                 "the plain keep-mask")
    n_stem, n_elan = plan_names(det)
    log(f"tail (c): the IBin Detector ({n_stem} FusedStem, {n_elan} FusedELAN) on "
        f"{len(images)} images: {sum(len(d) for d in got)} detections, bit-equal with the "
        f"plain keep-mask; launches {det_counts}")
    if dev.type == "cuda" and det_counts["K1L"] != 1:
        raise AssertionError(f"tail (c): Detector launches {det_counts}")
    return {"launches": {k: counts[k] + det_counts[k] for k in counts}, "losses": totals,
            **timing, "fp32_step": fp32, "detections": sum(len(d) for d in got),
            "detector_launches": det_counts, **check_ranking(dev)}


def tail(dev, width=1.0, img=IMG, batch=BATCH, pose_img=POSE_IMG, requests=TAIL_REQUESTS):
    """Phase 13: (a) the tail zoo, (b) the pose model, (c) IBin training.
    Returns the numbers, with the launches of the counted main paths."""
    t_phase = time.perf_counter()
    zoo_res = tail_zoo(dev, width, img, batch, requests)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    pose_res = pose(dev, width, pose_img, batch)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ibin = ibin_train(dev, width, img, batch)
    launches = {kid: zoo_res["launches"].get(kid, 0) + pose_res["launches"][kid]
                + ibin["launches"][kid] for kid in COUNTED}
    secs = time.perf_counter() - t_phase
    log(f"tail: launches of its main paths {launches}; phase {secs:.1f} s; card "
        f"{smi() if dev.type == 'cuda' else 'none'}")
    keys = ("replays", "img_s", "device_ms_bs8", "replay_ms_bs8", "eager_ms_bs8",
            "p50_ms_bs8", "p50_ms_bs1", "host_ms_infer_async", "enqueue_ms_bs8", "profile",
            "feature_rms_err", "feature_rms_err_cudnn_bf16", "agreement",
            "agreement_cudnn_bf16", "orepa_deploy_max_err", "head_inputs_rel_rms",
            "classify_rel_rms")
    return {"launches": launches, "zoo": {k: zoo_res.get(k) for k in keys}, "pose": pose_res,
            "ibin": ibin, "phase_s": secs}


# ------------------------------------------ int8 across the zoo, the tools ---

# Phase 14 (a): (name, cfg, px, mixed) of the int8 engines, each calibrated
# on INT8_CAL noise batches of 2 and served at batch BATCH: w6 (ReOrg,
# DownC, a 4-level head) mixed; tiny (LeakyReLU, SP) full and mixed; x50-csp
# (32-group convs, im2col int8) and yolov3 (repeated rows) full; the tail
# zoo (RobustConv's own leaves and the deployed RepConv_OREPA pass through
# `quantize_tree`) mixed. Each is held as phase 4b holds yolov7: bit-equal
# with the plain K4, head inputs within INT8_FEAT_MAX of the bf16 engine's.
INT8_ZOO = (("yolov7-w6", P6_DEPLOY_CFG, P6_IMG, True),
            ("yolov7-tiny", TINY_DEPLOY_CFG, IMG, False),
            ("yolov7-tiny", TINY_DEPLOY_CFG, IMG, True),
            ("x50-csp", ZOO_CFGS / "baseline/x50-csp.yaml", IMG, False),
            ("yolov3", ZOO_CFGS / "baseline/yolov3.yaml", IMG, False),
            ("tail-zoo", TAIL_CFG, IMG, True))
INT8_CAL = 2
# (b) the sum of `profile_layers`' rows against the eager forward of the
# same plan, and `chip_rate` of the bf16 engine's end2end against phase 4's
# replay time: each runs the same kernels one after another, so within
# PROFILE_TOL of each other (a layer timed twice, or not at all, is 1/100
# of the sum; a chip_rate that timed the host or a fraction of the calls,
# 2x)
PROFILE_TOL = 0.25
# (c) the HTTP server: HTTP_FRAMES JPEGs of phase 5's shapes; (d) the load
# bench: LOAD_CLIENTS closed-loop clients for LOAD_SECONDS a mode
HTTP_FRAMES, LOAD_CLIENTS, LOAD_SECONDS = 5, 16, 5.0
TOOL_RUNS = ROOT / "build" / "smoke_runs" / "tools"


def _tools():
    """The port's tools and tools/client.py, imported from the checkout."""
    if str(ROOT / "tools") not in sys.path:
        sys.path.insert(0, str(ROOT / "tools"))
    import client
    import torch_bench_serving
    import torch_eval_int8
    import torch_serve_http
    return client, torch_serve_http, torch_bench_serving, torch_eval_int8


def k4_convs(plan, qparams) -> int:
    """The int8 convs of a quantized tree that run on K4: those for which
    `quant.k4_routes`, the test `quant.int8_conv` makes, holds on the
    weight, the block's stride and groups (yolov3's `[512, [1, 1]]` conv
    among them, which `pallas_1x1_eligible` declines)."""
    def walk(block, p):
        if isinstance(p, list):
            return sum(walk(block, r) for r in p)
        if not isinstance(p, dict):
            return 0
        if "wq" in p:
            return int(quant.k4_routes(p["wq"], block.s, block.g))
        kids = block.children() if isinstance(block, L.Composite) else {}
        return sum(walk(kids[k], v) for k, v in p.items() if k in kids)

    return sum(walk(spec.block, qparams["layers"][i]) for i, spec in enumerate(plan.layers)
               if not spec.is_head)


def int8_engine(dev, m, mixed, batch=BATCH, what="int8 zoo"):
    """Phase 14 (a), one model: calibrate on noise, quantize (mixed or
    full), serve by the graph engine at `batch`. Counted: K1 once a
    forward, K4 once an eligible conv, K2 / K3 where their rewrites still
    match; each replay bit-equal to eager, head inputs and detections
    bit-equal with the plain K4, head inputs within INT8_FEAT_MAX of the
    bf16 engine's (and of fp32's, printed); img/s, busy share, host ms,
    peak allocation."""
    img = m.img
    rng = np.random.default_rng(1)
    cal = [rng.uniform(0, 1, (2, img, img, 3)).astype(np.float32) for _ in range(INT8_CAL)]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    scales = quant.calibrate(m.plan, m.params, m.state, cal)
    qp, qs = quant.quantize_model(m.plan, m.params, m.state, scales, mixed=mixed)
    n_q, n_k4 = _count_wq(qp), k4_convs(m.plan, qp)
    if n_k4 == 0 or (mixed and n_q != n_k4) or n_k4 < len(k4_shapes(m.plan, 1, img)):
        raise AssertionError(f"{what}: {n_q} convs quantized, {n_k4} K4-eligible")
    engine = ServingEngine(m.plan, qp, qs, batch_size=batch, img_size=img,
                           dtype=torch.bfloat16, device=dev)
    n_stem, n_elan = plan_names(engine)
    batches = [rng.integers(0, 256, (batch, img, img, 3), np.uint8) for _ in range(2)]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    zero_counts()
    outs = [engine.infer(b) for b in batches]
    counts = read_counts()
    check_path_counts(what, counts, (engine,),
                      {"K1": 1, "K2": n_stem, "K3": n_elan, "K4": n_k4})
    graph_equals_eager(what, engine, outs, batches)
    normalized, reference = make_reference(m)
    feats = same_as_plain_k4(what, engine, normalized, batches[0])
    bf16 = ServingEngine(m.plan, m.params, m.state, batch_size=batch, img_size=img,
                         dtype=torch.bfloat16, device=dev)
    with torch.inference_mode():
        f16, _ = apply_model(bf16.plan, bf16._params, bf16._state, normalized(batches[0]),
                             dtype=torch.bfloat16, return_head_inputs=True)
        d16 = bf16.to_host(bf16.end2end(torch.from_numpy(batches[0]).to(dev)))
    del bf16
    f32, _ = reference(batches[0], torch.float32)
    err, err32 = feature_error(feats, f16), feature_error(feats, f32)
    agree = agreement(what, outs[0], d16)
    log(f"{what}: {n_q} convs quantized ({'mixed' if mixed else 'full'}; {n_k4} on K4), "
        f"plan {n_stem} FusedStem, {n_elan} FusedELAN; head inputs {err:.4f} relative RMS "
        f"from the bf16 engine's ({err32:.4f} from fp32), limit {INT8_FEAT_MAX}; "
        f"detections agree {agree:.3f} with the bf16 engine's; "
        f"{int(outs[0]['num_dets'].sum())} / {int(d16['num_dets'].sum())} detections")
    if not (err <= INT8_FEAT_MAX and all(torch.isfinite(f).all() for f in feats)):
        raise AssertionError(f"{what}: int8 head inputs {err} relative RMS from the bf16 "
                             f"engine's > {INT8_FEAT_MAX}")
    res = {"launches": counts, "quantized": n_q, "k4_convs": n_k4, "mixed": mixed,
           "feature_rms_err_bf16": err, "feature_rms_err_fp32": err32, "agreement_bf16": agree}
    if dev.type == "cuda":
        fwd_ms = cuda_ms(lambda: engine.infer_async(batches[0]), iters=10)
        host = []
        for _ in range(10):
            torch.cuda.synchronize()
            t = time.perf_counter()
            engine.infer_async(batches[0])
            host.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        prof = profile_forwards(lambda: engine.infer_async(batches[0]), f"{what} (graph)",
                                n=3)["profile"]
        got = prof and prof["launches"]
        want = {k: 0.0 for k in TRACED} | {"nms_keep_kernel": 1.0,
                                           "conv_silu_kernel": float(3 * n_stem + 6 * n_elan),
                                           "int8_mm_kernel": float(n_k4)}
        if got is not None and got != want:
            raise AssertionError(f"{what}: a replay launched {got} in the trace, want {want}")
        res.update(img_s=batch / fwd_ms * 1e3, device_ms_bs8=fwd_ms,
                   host_ms_infer_async=statistics.median(host),
                   busy_share=prof and prof["busy_share"], profile=prof,
                   peak_bytes=torch.cuda.max_memory_allocated())
        log(f"{what}: {res['img_s']:.1f} img/s (one batch-{batch} infer_async {fwd_ms:.3f} "
            f"ms between events), busy {res['busy_share']}, host "
            f"{res['host_ms_infer_async']:.3f} ms an infer_async, K4 launches {counts['K4']}, "
            f"peak {res['peak_bytes'] / 1e9:.2f} GB")
    return res


def int8_zoo(dev, width=1.0, zoo=INT8_ZOO, batch=BATCH):
    """Phase 14 (a): every model of `zoo` in int8 (`int8_engine`)."""
    out = {}
    for name, cfg, img, mixed in zoo:
        key = f"{name} {'mixed' if mixed else 'full'}"
        t = time.perf_counter()
        m = make_model(dev, width, img, cfg)
        out[key] = int8_engine(dev, m, mixed, batch, f"int8 zoo (a) {key}")
        out[key]["s"] = time.perf_counter() - t
        del m
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def profiling(dev, m, replay_ms, batch=BATCH):
    """Phase 14 (b): `profile_layers` of the fused plan at `batch` (bf16):
    one row a layer, its steady-state device time; the sum within
    PROFILE_TOL of the eager forward's device busy time (its kernels' time
    in a torch.profiler trace; its time between two events, which counts
    the host's launch gaps, printed beside it); `chip_rate` of the
    bf16 engine's end2end (a CUDA graph of N calls) within PROFILE_TOL of
    phase 4's replay time; `model_info`'s counts on the card equal to the
    CPU's."""
    from yolo_series_tpu_torch.models.model import profile_layers
    from yolo_series_tpu_torch.utils.chiprate import chip_rate
    from yolo_series_tpu_torch.utils.general import model_info

    x = torch.from_numpy(m.rng.integers(0, 256, (batch, m.img, m.img, 3), np.uint8)).to(
        dev).float() / 255.0
    rows = profile_layers(m.plan, m.params, m.state, x, iters=5, dtype=torch.bfloat16)
    total = sum(r["ms"] for r in rows)
    if len(rows) != len(m.plan.layers) or rows[-1]["module"] != "Detect" or \
            sum(r["params"] for r in rows) != sum(t.numel() for t in tree_leaves(m.params)):
        raise AssertionError("profile: the rows do not cover the plan")
    res = {"rows": len(rows), "rows_ms": total,
           "gflops": sum(r["gflops"] for r in rows),
           "top_rows": sorted(({k: r[k] for k in ("idx", "module", "ms", "gflops")}
                               for r in rows), key=lambda r: -r["ms"])[:8]}
    info_dev = model_info(m.plan, m.params, m.state, img_size=m.img)
    info_cpu = model_info(m.plan, tree_map(lambda t: t.cpu(), m.params),
                          tree_map(lambda t: t.cpu(), m.state), img_size=m.img)
    if info_dev != info_cpu:
        raise AssertionError(f"model_info on the card {info_dev}, on the CPU {info_cpu}")
    res["model_info"] = info_dev
    log(f"profile: {len(rows)} rows, {total:.3f} ms summed, {res['gflops']:.1f} GFLOPs at "
        f"batch {batch}; model_info {info_dev} on the card and the CPU")
    if dev.type != "cuda":
        return res
    def forward():
        return apply_model(m.plan, m.params, m.state, x, dtype=torch.bfloat16)

    with torch.inference_mode():
        eager = cuda_ms(forward, iters=10)
        trace = profile_forwards(forward, "profile: the eager forward", n=3)["profile"]
    if trace is None:
        raise AssertionError("profile: the trace recorded no device time for the forward")
    busy = trace["busy_ms"]
    engine = ServingEngine(m.plan, m.params, m.state, batch_size=batch, img_size=m.img,
                           dtype=torch.bfloat16, device=dev)
    engine.capture()
    rate = chip_rate(engine.end2end, engine._static_in, iters=20)
    res.update(eager_ms=eager, eager_busy_ms=busy, chip_rate_ms=rate * 1e3,
               chip_rate_mode=chip_rate.mode, replay_ms_bs8=replay_ms)
    log(f"profile: rows {total:.3f} ms against the eager forward's device busy {busy:.3f} ms "
        f"({eager:.3f} ms between events); chip_rate {rate * 1e3:.3f} ms a call "
        f"({chip_rate.mode}) against phase 4's replay {replay_ms:.3f} ms; limit "
        f"{PROFILE_TOL:.0%}")
    if not abs(total - busy) <= PROFILE_TOL * busy:
        raise AssertionError(f"profile rows {total} ms, eager forward busy {busy} ms")
    if not abs(rate * 1e3 - replay_ms) <= PROFILE_TOL * replay_ms:
        raise AssertionError(f"chip_rate {rate * 1e3} ms, replay {replay_ms} ms")
    return res


def write_deploy_ckpt(m, path):
    """m's fused deploy weights as a checkpoint in the JAX format (the
    export CLI's layout), for the tools that load one."""
    from yolo_series_tpu_torch.models.convert import to_jax_tree
    from yolo_series_tpu_torch.train.checkpoints import FORMAT, _dump

    path.parent.mkdir(parents=True, exist_ok=True)
    _dump({"format": FORMAT, "epoch": -1, "best_fitness": 0, "results": None, "hyp": None,
           "cfg": _cfg(m.width), "step": 0,
           "params": to_jax_tree(tree_map(lambda t: t.cpu(), m.params)),
           "state": to_jax_tree(tree_map(lambda t: t.cpu(), m.state)), "ema_params": None,
           "ema_state": None, "opt_state": None}, path)
    return str(path)


def http_server(dev, m, int8, batch=BATCH):
    """Phase 14 (c): tools/torch_serve_http.py on m's checkpoint (with
    `--int8`: full int8, dynamic scales), in this process on 127.0.0.1 at
    a free port; HTTP_FRAMES JPEGs through tools/client.py's `post`, each
    answer bit-equal to the engine's direct `infer` on the decoded frame,
    letterboxed and scaled back by the same functions."""
    import cv2

    client, serve, _, _ = _tools()
    ckpt = write_deploy_ckpt(m, TOOL_RUNS / "deploy.ckpt")
    what = f"http server ({'int8' if int8 else 'bf16'})"
    opt = serve.make_parser().parse_args(
        ["--weights", ckpt, "--img-size", str(m.img), "--batch-size", str(batch),
         "--device", dev.type] + (["--int8"] if int8 else []))
    plan, engine, batcher = serve.build_engine(opt)
    server = serve.make_server(batcher, opt.img_size, plan.names, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(31)
    n_dets, lat = 0, []
    try:
        for i in range(HTTP_FRAMES):
            # quality 100 without chroma subsampling: a default JPEG blurs
            # the colour noise the model was livened on, and it detects nothing
            ok, buf = cv2.imencode(".jpg", noise_image(rng, DATA_SHAPES[i % len(DATA_SHAPES)],
                                                       m.img),
                                   [cv2.IMWRITE_JPEG_QUALITY, 100, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])
            t = time.perf_counter()
            res = client.post(url, buf.tobytes())
            lat.append((time.perf_counter() - t) * 1e3)
            img0 = cv2.imdecode(buf, cv2.IMREAD_COLOR)
            img, ratio, dwdh = letterbox(img0, m.img, auto=False)
            want = engine.infer(np.ascontiguousarray(img[:, :, ::-1])[None])
            n = int(want["num_dets"][0, 0])
            boxes = scale_coords_np((m.img, m.img), want["det_boxes"][0, :n].copy(),
                                    img0.shape[:2], ((ratio[1], ratio[0]), dwdh))
            same = (res["num_dets"] == n
                    and res["det_boxes"] == json.loads(json.dumps(boxes.tolist()))
                    and res["det_scores"] == want["det_scores"][0, :n].tolist()
                    and res["det_classes"] == want["det_classes"][0, :n].tolist())
            if not same:
                raise AssertionError(f"{what}: frame {i}: the answer differs from the "
                                     "engine's")
            n_dets += n
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        batcher.close()
    log(f"{what}: {HTTP_FRAMES} JPEGs answered bit-equal to the engine's infer "
        f"({n_dets} detections); client round trip p50 {statistics.median(lat):.2f} ms")
    if n_dets == 0:
        raise AssertionError(f"{what}: no detections to compare")
    return {"frames": HTTP_FRAMES, "detections": n_dets,
            "round_trip_p50_ms": statistics.median(lat)}


def load_bench(dev, m, batch=BATCH, clients=LOAD_CLIENTS, seconds=LOAD_SECONDS):
    """Phase 14 (d): tools/torch_bench_serving.py's two modes on m's bf16
    engines (batch `batch` behind the DynamicBatcher, batch 1 behind a
    lock), `clients` closed-loop clients for `seconds` each: infer/s, p50,
    p99; every answer checked against its client's frame."""
    _, _, bench_tool, _ = _tools()
    kw = dict(img_size=m.img, conf_thres=0.25, iou_thres=0.45, max_det=100, max_nms=256,
              pack_output=True, dtype=torch.bfloat16, device=dev)
    engine = ServingEngine(m.plan, m.params, m.state, batch_size=batch, **kw)
    engine1 = ServingEngine(m.plan, m.params, m.state, batch_size=1, **kw)
    out = bench_tool.bench(engine, engine1, clients, seconds)
    log(f"load bench: {json.dumps(out)}")
    return out


@contextlib.contextmanager
def recorded_k4():
    """Inside: each K4 conv (`int8_mm.int8_conv1x1`) is also held against
    the plain K4 on its own inputs as soon as it has run; they must be
    bit-equal. Yields the list of the launches' (M, K, N)."""
    real, shapes = int8_mm.int8_conv1x1, []

    def record(xq, wq, scale, bias):
        y = real(xq, wq, scale, bias)
        b, h, w, k = xq.shape
        n = wq.shape[0]
        got = y.reshape(b * h * w, n)
        want = int8_mm.int8_matmul_dequant_plain(xq.reshape(b * h * w, k),
                                                 wq.reshape(n, k).t(), scale, bias)
        shapes.append((b * h * w, k, n))
        if not torch.equal(got, want):
            raise AssertionError(f"K4 launch {len(shapes)} (M, K, N) {shapes[-1]}: max abs "
                                 f"err {float((got - want).abs().max())} from the plain K4")
        return y

    int8_mm.int8_conv1x1 = record
    try:
        yield shapes
    finally:
        int8_mm.int8_conv1x1 = real


def int8_eval_tool(dev, img=IMG, batch=BATCH):
    """Phase 14 (e): tools/torch_eval_int8.py on phase 8's set and start
    (its 16 val JPEGs in rect batches, calibrated on 8 train images): fp32
    and int8 mAP, finite; counted K4 and K1L launches; each K4 launch
    bit-equal with the plain K4 on its own inputs (`recorded_k4`), and the
    int8 row equal with that of the plain K4 and the plain keep-mask."""
    *_, eval_tool = _tools()
    plan, params, state = load_checkpoint_any(str(SMOKE_DATA / "livened.ckpt"))
    zero_counts()
    with recorded_k4() as shapes:
        out = eval_tool.evaluate_int8(plan, params, state, SMOKE_DATA, img, batch, 8, dev,
                                      names=plan.names)
    counts = read_counts()
    fparams, fstate = fuse_model(plan, params, state)
    cal = eval_tool.calibration_frames(SMOKE_DATA / "train" / "images", img, 8)
    qp, qs = quant.quantize_model(plan, fparams, fstate,
                                  quant.calibrate(plan, fparams, fstate, cal))
    with plain_nms(), plain_k4():
        plain = eval_tool.metrics(plan, qp, qs, str(SMOKE_DATA / "val" / "images"), img,
                                  batch, dev, plan.names)
    ms = sorted({m for m, _, _ in shapes})
    log(f"int8 eval tool: {json.dumps(out)}; launches {counts}; {len(shapes)} K4 convs "
        f"bit-equal with the plain K4 on their own inputs (M {ms}); int8 with the plain "
        f"K4 and keep-mask {plain}")
    if not all(math.isfinite(v) for row in ("fp", "int8") for v in out[row].values()):
        raise AssertionError(f"int8 eval tool: non-finite metrics {out}")
    if plain != out["int8"]:
        raise AssertionError(f"int8 eval tool: int8 mAP {out['int8']}, with the plain "
                             f"K4 and keep-mask {plain}")
    if dev.type == "cuda" and (counts["K4"] == 0 or counts["K1L"] == 0
                               or counts["K4"] != len(shapes)):
        raise AssertionError(f"int8 eval tool: launches {counts}, {len(shapes)} K4 convs "
                             "recorded")
    return {**out, "launches": counts, "k4_m": ms}


def int8_and_tools(dev, m, replay_ms, width=1.0, batch=BATCH, zoo=INT8_ZOO,
                   clients=LOAD_CLIENTS, seconds=LOAD_SECONDS, eval_img=IMG):
    """Phase 14: (a) int8 across the zoo, (b) profiling, (c) the HTTP server
    bf16 and int8, (d) the load bench, (e) the int8 eval tool. Returns the
    numbers, with the launches of the counted main paths."""
    t_phase = time.perf_counter()
    zoo_res = int8_zoo(dev, width, zoo, batch)
    prof = profiling(dev, m, replay_ms, batch)
    zero_counts()
    http = {"bf16": http_server(dev, m, False, batch), "int8": http_server(dev, m, True, batch)}
    http_counts = read_counts()
    zero_counts()
    load = load_bench(dev, m, batch, clients, seconds)
    load_counts = read_counts()
    ev = int8_eval_tool(dev, eval_img, batch)
    launches = {kid: sum(r["launches"][kid] for r in zoo_res.values()) + http_counts[kid]
                + load_counts[kid] + ev["launches"][kid] for kid in COUNTED}
    secs = time.perf_counter() - t_phase
    log(f"int8 and tools: launches of its main paths {launches} (http {http_counts}, load "
        f"bench {load_counts}); phase {secs:.1f} s; card "
        f"{smi() if dev.type == 'cuda' else 'none'}")
    return {"launches": launches, "int8_zoo": zoo_res, "profile": prof, "http": http,
            "http_launches": http_counts, "load_bench": load, "load_launches": load_counts,
            "eval_int8": ev, "phase_s": secs}


# ------------------------------------- several cards, the layout passes ---

# Phase 15 (a): the sharded engine's grids on one card (two views of it).
# The tensor-parallel row runs the fused plan through cuDNN with each cut
# conv's output channels computed apart: cuDNN may pick other algorithms
# for the narrower convs, so its head inputs are held against the unsharded
# bf16 forward of the same plan within cuDNN bf16's own relative RMS from
# fp32 (a bf16 forward computed another way is no farther from the bf16
# forward than bf16 is from fp32), and its detections by the phase-4 rule.
MESH_REQUESTS = 8
# (b) the layout passes against the plain plan in fp32 (`full_fp32`): the
# same convs re-arranged, cuDNN's fp32 sums in another order: the head
# inputs within LAYOUT_REL relative RMS
LAYOUT_REL = 1e-4
LAYOUT_W6_BATCH = 2
# (e) the fp32 eval pred, card against CPU (cuDNN against oneDNN fp32):
# boxes, objectness and classes each within EVAL_CPU_REL of their largest
EVAL_CPU_REL = 1e-4
NATIVE_THREADS = (1, 4)
# (b1) The folded fp32 step, card against CPU. SPPCSPC's stride-1 pools
# route each window's gradient to its largest input; where two inputs lie
# within fp32 rounding of each other, another summation order picks the
# other one, which moves the update of every layer upstream of the pool by
# one discrete step. On the CPU (tools/torch_fold_readings.py, width 0.25,
# 320 px, batch 2, 4 and 8 threads) the folded and unfolded steps lie
# 0.0677 apart where 87 windows of the chained 5 x 5 pools route otherwise
# (their two inputs at most 7.1e-7 to 4.0e-6 apart, relative), and
# 1.27e-4 to 1.39e-4 where none does; which run reroutes turns with the
# thread count and with the fold's moments taken in one pass or two. So
# the whole update is held within phase 7's STEP_UPDATE_L2 unless windows
# route otherwise on the card, each such window's two inputs within
# FOLD_NEAR_TIE of each other; the pool-free layers, and the folded layers
# alone under one cotangent (against the CPU and the unfolded layers),
# are held in every case.
FOLD_NEAR_TIE = 1e-4


def grid_rows(dev, m, devices, n_data, n_model, batch, frames, what):
    """One grid's engine on `devices` (a (n_data, n_model) grid), driven on
    `frames` (3 full batches, a partial one, MESH_REQUESTS requests through
    a `DynamicBatcher`) with the counters zeroed just before: (engine, the
    launch counts, the full batches' outputs)."""
    grid = make_mesh(n_data, n_model, devices)
    eng = ShardedServingEngine(m.plan, m.params, m.state, grid, batch_size=batch,
                               img_size=m.img, dtype=torch.bfloat16)
    zero_counts()
    outs = [eng.infer(f) for f in frames]
    partial = eng.infer(frames[0][:3])
    batcher = DynamicBatcher(eng, max_delay_ms=20)
    try:
        res = [DynamicBatcher.wait(batcher.submit(f), timeout=300)
               for f in frames[1][:MESH_REQUESTS]]
    finally:
        batcher.close()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    counts = read_counts()
    if any(r is None for r in res):
        raise AssertionError(f"{what}: a batcher request got no result")
    for k in partial:
        if not np.array_equal(partial[k], outs[0][k][:3]):
            raise AssertionError(f"{what}: the partial batch's {k} differ from the full one's")
    return eng, counts, outs


def grid_speed(eng, frames):
    """img/s of `infer_async` between events (both rows' uploads, replays or
    eager forwards and clones) and host-to-host `infer` p50."""
    ms = cuda_ms(lambda: eng.infer_async(frames), iters=20)
    lat = []
    for _ in range(20):
        t = time.perf_counter()
        eng.infer(frames)
        lat.append((time.perf_counter() - t) * 1e3)
    return {"img_s": eng.batch_size / ms * 1e3, "ms_batch": ms, "p50_ms": statistics.median(lat)}


def grid_traces(width, img, batch):
    """The 2 x 1 grid of `sharded` on the card in this process (it must have
    traced nothing before): the launches of TRACED in each row's replay,
    the row's graph traced alone, and in a forward's two replays."""
    dev = torch.device("cuda")
    m = make_model(dev, width, img)
    eng = ShardedServingEngine(m.plan, m.params, m.state, make_mesh(2, 1, [dev, dev]),
                               batch_size=batch, img_size=img, dtype=torch.bfloat16)
    frames = np.random.default_rng(15).integers(0, 256, (batch, img, img, 3), np.uint8)
    eng.infer(frames)
    half, rows = batch // 2, []
    for d, r in enumerate(eng.rows):
        part = frames[d * half:(d + 1) * half]
        prof = profile_forwards(lambda: r.infer_async(part), f"2x1 row {d} (graph)")["profile"]
        rows.append(prof and prof["launches"])
    prof = profile_forwards(lambda: eng.infer_async(frames), "2x1 (graphs)")["profile"]
    return {"rows": rows, "forward": prof and prof["launches"]}


def fresh_grid_traces(m, batch):
    """`grid_traces` in a child process (its last line of output)."""
    code = (f"import json, chip_smoke as cs; "
            f"print(json.dumps(cs.grid_traces({m.width!r}, {m.img}, {batch})))")
    child = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                           text=True, timeout=600)
    if child.returncode:
        raise AssertionError(f"grid traces: the child exited {child.returncode}: "
                             f"{child.stderr[-3000:]}")
    return json.loads([line for line in child.stdout.splitlines() if line.startswith("{")][-1])


def sharded(dev, m, devices=None, batch=BATCH, what="mesh (a)", phase4=None):
    """Phase 15 (a): the sharded engine on full-width yolov7 deploy, bf16.
    A 2 x 1 data grid: each row a batch-B/2 `ServingEngine` (its CUDA graph,
    K2's 3 and K3's 48 conv_silu launches and K1's one a replay, each
    replay's kernels in the trace of a fresh process), each half of its output bit-equal with
    a batch-B/2 engine's on that half, with the row's eager forward (each
    of its conv_silu launches held against the plain conv) and with the
    row's forward on the plain keep-mask. A
    1 x 2 tensor-parallel grid: its cut convs on both devices, K1 on the
    first, eager; head inputs and detections against the references. img/s
    and p50 beside (and beside phase 4's engine, `phase4`: its serving
    numbers). `devices`: the grid's devices ([dev, dev]: one card twice,
    unless given)."""
    devices = [dev, dev] if devices is None else devices
    rng = np.random.default_rng(15)
    frames = [rng.integers(0, 256, (batch, m.img, m.img, 3), np.uint8) for _ in range(3)]
    half = batch // 2
    normalized, reference = make_reference(m)

    # ---- the data grid ----
    eng, counts, outs = grid_rows(dev, m, devices, 2, 1, batch, frames, f"{what} 2x1")
    n_stem, n_elan = plan_names(eng.rows[0])
    per_forward = {"K1": 1, "K2": n_stem, "K3": n_elan}
    want = {kid: 2 * 2 * per_forward.get(kid, 0) for kid in COUNTED}   # 2 rows x (warm-up, capture)
    log(f"{what} 2x1: {len(eng.rows)} rows of batch {half} on {[str(r.device) for r in eng.rows]}, "
        f"{n_stem} FusedStem, {n_elan} FusedELAN a row; {eng.batches} forwards, {eng.replays} "
        f"replays; host launch counts {counts}")
    if dev.type == "cuda":
        if counts != want or eng.replays != eng.batches:
            raise AssertionError(f"{what} 2x1: launches {counts} (want {want}), {eng.replays} "
                                 f"replays of {eng.batches} forwards")
    single = ServingEngine(m.plan, m.params, m.state, batch_size=half, img_size=m.img,
                           dtype=torch.bfloat16, device=dev)
    for j, f in enumerate(frames):
        for d in range(2):
            want_d = single.infer(f[d * half:(d + 1) * half])
            for k in want_d:
                if not np.array_equal(outs[j][k][d * half:(d + 1) * half], want_d[k]):
                    raise AssertionError(f"{what} 2x1: batch {j} row {d}: {k} differ from a "
                                         f"batch-{half} engine's on its frames")
    log(f"{what} 2x1: each row's half of {len(frames)} batches bit-equal with a batch-{half} "
        f"ServingEngine on its frames")
    # each row's own kernels at its shapes: the row's eager forward (what
    # its graph captured) on its half of batch 0, each conv_silu launch held
    # against the plain conv on its own slices; the graph's detections
    # bit-equal with it and with the row's forward on the plain keep-mask
    errs = [] if dev.type == "cuda" else None
    row_launches = []
    for d, r in enumerate(eng.rows):
        x_d = torch.from_numpy(frames[0][d * half:(d + 1) * half]).to(r.device)
        with recorded_launches(errs) as calls:
            eager = r.to_host(r.end2end(x_d))
        row_launches.append(len(calls))
        del calls
        with plain_nms():
            plain = r.to_host(r.end2end(x_d))
        for k in eager:
            got = outs[0][k][d * half:(d + 1) * half]
            if not (np.array_equal(got, eager[k]) and np.array_equal(got, plain[k])):
                raise AssertionError(f"{what} 2x1 row {d}: the graph's {k} differ from its "
                                     "eager forward's or from the plain keep-mask's")
    conv_err = max(errs) if errs else None
    log(f"{what} 2x1: each row's eager forward launched {row_launches} conv_silu, each held "
        f"against the plain conv on its own slices (max abs err {conv_err}); each row's "
        f"detections bit-equal with its eager forward's and with the plain keep-mask's")
    res = {"data": {"launches": counts, "replays": eng.replays,
                    "conv_silu_max_abs_err": conv_err}}
    if dev.type == "cuda":
        if row_launches != [3 * n_stem + 6 * n_elan] * 2:
            raise AssertionError(f"{what} 2x1: rows' eager conv_silu launches {row_launches}")
        res["data"].update(grid_speed(eng, frames[0]))
        # the forward's two replays traced here (a reading), and again in a
        # fresh process, with each row's graph alone (checked): late in this
        # script such traces have lacked 2-3 conv_silu records a replay,
        # every record that came holding device time, while the same graphs
        # traced in a process that had traced nothing before read each
        # kernel of the replay
        res["data"]["profile"] = profile_forwards(
            lambda: eng.infer_async(frames[0]), f"{what} 2x1 (graphs)")["profile"]
        fresh = fresh_grid_traces(m, batch)
        per_row = {k: 0.0 for k in TRACED} | {"nms_keep_kernel": 1.0,
                                             "conv_silu_kernel": 3.0 * n_stem + 6.0 * n_elan}
        per_forward = {k: 2 * v for k, v in per_row.items()}
        res["data"]["launches_traced_fresh"] = fresh
        log(f"{what} 2x1: a fresh process's traces: each row's replay {fresh['rows']}, a "
            f"forward {fresh['forward']} (want {per_row} and {per_forward})")
        if fresh["rows"] != [per_row] * 2 or fresh["forward"] != per_forward:
            raise AssertionError(f"{what} 2x1: a fresh process traced {fresh}, want "
                                 f"{per_row} a row and {per_forward} a forward")
    del eng, single

    # ---- the tensor-parallel grid ----
    eng, counts, outs = grid_rows(dev, m, devices, 1, 2, batch, frames, f"{what} 1x2")
    row = eng.rows[0]
    n_cut = sum(isinstance(v, ShardedWeight) for v in _leaves_any(row._params))
    want = {kid: 0 for kid in COUNTED} | {"K1": eng.batches}
    log(f"{what} 1x2: one row over {[str(d) for d in row.devices]}, {n_cut} cut conv "
        f"weights, eager; {eng.batches} forwards; launch counts {counts}")
    if dev.type == "cuda" and counts != want:
        raise AssertionError(f"{what} 1x2: launches {counts}, want {want}")
    with torch.inference_mode():
        x16 = normalized(frames[0])
        feats, _ = apply_model(row.plan, row._params, row._state, x16, dtype=torch.bfloat16,
                               return_head_inputs=True)
        f32, want32 = reference(frames[0], torch.float32)
        f16, _ = reference(frames[0], torch.bfloat16)
    err_tp, err_bf16 = feature_error(feats, f16), feature_error(f16, f32)
    agree_tp = statistics.mean(agreement(f"{what} 1x2 batch {j}", outs[j],
                                         reference(f, torch.float32)[1])
                               for j, f in enumerate(frames))
    agree_bf16 = statistics.mean(agreement(f"cuDNN bf16 batch {j}",
                                           reference(f, torch.bfloat16)[1],
                                           reference(f, torch.float32)[1])
                                 for j, f in enumerate(frames))
    log(f"{what} 1x2: head inputs {err_tp:.5f} relative RMS from the unsharded bf16 forward "
        f"(limit: cuDNN bf16's {err_bf16:.5f} from fp32); detections agree {agree_tp:.3f} with "
        f"fp32 (cuDNN bf16 {agree_bf16:.3f})")
    if not err_tp <= err_bf16:
        raise AssertionError(f"{what} 1x2: head inputs {err_tp} from the unsharded forward")
    if not agree_tp >= agree_bf16 - MATCH_MARGIN:
        raise AssertionError(f"{what} 1x2: detections agree {agree_tp}, cuDNN bf16 {agree_bf16}")
    res["tensor"] = {"launches": counts, "cut_weights": n_cut, "feature_rms_err": err_tp,
                     "feature_rms_err_cudnn_bf16": err_bf16, "agreement": agree_tp,
                     "agreement_cudnn_bf16": agree_bf16}
    if dev.type == "cuda":
        res["tensor"].update(grid_speed(eng, frames[0]))
        p4 = phase4 or {}
        log(f"{what}: img/s and p50 at batch {batch}: 2x1 {res['data']['img_s']:.1f} img/s, "
            f"p50 {res['data']['p50_ms']:.3f} ms; 1x2 {res['tensor']['img_s']:.1f} img/s, "
            f"p50 {res['tensor']['p50_ms']:.3f} ms; phase 4's batch-{batch} engine "
            f"{p4.get('img_s')} img/s, p50 {p4.get('p50_ms_bs8')} ms")
    res["launches"] = {kid: res["data"]["launches"][kid] + counts[kid] for kid in COUNTED}
    return res


def _leaves_any(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves_any(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves_any(v)]
    return [tree]


def _rel_parts(got, want):
    """max |got - want| over the largest |want|."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@contextlib.contextmanager
def recorded_pools():
    """Inside: each `layers.max_pool` call appends a host copy of its input
    and its (k, stride, padding) to the list yielded."""
    real, rec = L.max_pool, []

    def record(x, k, s, padding):
        rec.append((x.detach().cpu().clone(), k, s, padding))
        return real(x, k, s, padding)

    L.max_pool = record
    try:
        yield rec
    finally:
        L.max_pool = real


def pool_routes(pools_a, pools_b):
    """Two runs' max pools (`recorded_pools`): the windows whose maximum is
    another input in b than in a, and the largest gap between the two
    inputs of such a window in a's values, relative to a's maximum."""
    n, gap = 0, 0.0
    for (xa, k, s, pad), (xb, *_) in zip(pools_a, pools_b):
        _, ia = torch.nn.functional.max_pool2d(xa, k, s, pad, return_indices=True)
        _, ib = torch.nn.functional.max_pool2d(xb, k, s, pad, return_indices=True)
        moved = (ia != ib).flatten(2)
        if moved.any():
            flat = xa.flatten(2)
            va = flat.gather(2, ia.flatten(2))[moved]
            vb = flat.gather(2, ib.flatten(2))[moved]
            n += int(moved.sum())
            gap = max(gap, float(((va - vb).abs() / va.abs().clamp_min(1e-30)).max()))
    return n, gap


def prefix_grads(plan, params, state, x, k, dev, seed=15):
    """Layers 0..k-1 of `plan` (a chain) in fp32 training on `dev` from the
    NHWC batch x: their output, new BN state and the grads of their params
    under a cotangent on the output drawn from `seed`."""
    ctx = L.Ctx(dtype=torch.float32, training=True)
    lp = [tree_map(lambda t: t.detach().to(dev).requires_grad_(), params["layers"][i])
          for i in range(k)]
    y = x.to(dev).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    states = []
    with full_fp32(dev.type == "cuda"):
        for i in range(k):
            y, s_i = _run_layer(ctx, plan.layers[i], lp[i],
                                tree_map(lambda t: t.to(dev), state["layers"][i]), y, i)
            states.append(s_i)
        cot = torch.randn(y.shape, generator=torch.Generator().manual_seed(seed))
        grads = torch.autograd.grad(y, tree_leaves(lp), cot.to(dev, y.dtype))
    return y.detach(), states, list(grads)


def check_fold_step(dev, width=0.25, img=320, batch=2, what="layout (b) fast stem"):
    """One fp32 step (OTA, SGD) of yolov7's training form at `width` with
    `make_train_fast_stem`, card against CPU from the same state, by phase
    7 (b)'s rule where the pools allow it (FOLD_NEAR_TIE): the update
    within STEP_UPDATE_L2, unless the max pools route some window to
    another input on the card than on the CPU, each such window a near-tie;
    then the pool-free layers' update within PAR_POOL_FREE_L2. Loss items
    within PAR_ITEM_RTOL, BN state within STEP_STATE_REL. The folded layers
    themselves are held directly under one cotangent, card against CPU and
    against the unfolded layers on the card: their output within
    PAR_ITEM_RTOL (fp32 sums in another order), BN state within
    STEP_STATE_REL, param grads within STEP_UPDATE_L2."""
    model = train_model(torch.device("cpu"), width, seed=3)
    opt = train_optim.OptimConfig()
    lr, mom = lr_after_warmup(opt)
    batch_np = train_batch(np.random.default_rng(5), batch, img)
    loss_fn = make_compute_loss_ota(model.plan.head, LossHyp())
    folded = make_train_fast_stem(model.plan)
    res, pools = {}, {}
    for where in (dev, torch.device("cpu")):
        ts = init_train_state(model.params, model.state, opt, device=where)
        step = make_train_step(folded, loss_fn, opt, compute_dtype=torch.float32)
        with full_fp32(where.type == "cuda"), recorded_pools() as rec:
            new, metrics = step(ts, *batch_np, lr, mom)
        res[where.type] = (ts, new, {k: float(v) for k, v in metrics.items()})
        pools[where.type] = rec
    (ts_h, new_h, m_h), new_c = res["cpu"], res[dev.type][1]
    card = update_readings(model.plan, new_c.params, new_h.params, ts_h.params)
    moved, gap = pool_routes(pools["cpu"], pools[dev.type])
    del pools
    items = max(abs(res[dev.type][2][k] - m_h[k]) / abs(m_h[k]) for k in m_h)
    state = tree_rel_l2(new_c.state, new_h.state)
    log(f"{what}: one fp32 step of yolov7 with the fold, width {width}, {img} px, batch "
        f"{batch}, card against CPU: update {card['rel_l2']:.3g} in all (limit "
        f"{STEP_UPDATE_L2} unless the pools route otherwise), pool-free layers "
        f"{card['pool_free_rel_l2']:.3g} (limit {PAR_POOL_FREE_L2}), the others "
        f"{card['pooled_rel_l2']:.3g} ({card['pooled_share']:.4f} of the squared distance; "
        f"top layers {card['top_layers']}); {moved} max-pool windows route to another input "
        f"on the card, their two inputs at most {gap:.3g} apart (limit {FOLD_NEAR_TIE}); "
        f"loss items {items:.3g} (limit {PAR_ITEM_RTOL}), BN state {state:.3g} (limit "
        f"{STEP_STATE_REL})")
    whole = card["rel_l2"] <= STEP_UPDATE_L2 or (moved > 0 and gap <= FOLD_NEAR_TIE)
    if not (whole and card["pool_free_rel_l2"] <= PAR_POOL_FREE_L2
            and items <= PAR_ITEM_RTOL and state <= STEP_STATE_REL):
        raise AssertionError(f"{what}: update {card['rel_l2']} ({moved} pool windows "
                             f"rerouted, gap {gap}), pool-free {card['pool_free_rel_l2']}, "
                             f"loss items {items}, BN state {state}")
    # the folded layers alone, under one cotangent
    k = next(i for i, spec in enumerate(folded.layers)
             if not isinstance(spec.block, (TrainPhasedConvA, TrainPhasedConvB)))
    x = torch.from_numpy(batch_np[0]).float() / 255.0
    card_f, cpu_f, card_u = (prefix_grads(plan, model.params, model.state, x, k, where)
                             for plan, where in ((folded, dev), (folded, torch.device("cpu")),
                                                 (model.plan, dev)))
    prefix = {f"{label}_{part}": tree_rel_l2(got[j], want[j])
              for label, got, want in (("card_vs_cpu", card_f, cpu_f),
                                       ("fold_vs_unfolded", card_f, card_u))
              for j, part in enumerate(("out", "bn_state", "grads"))}
    names = ", ".join(type(spec.block).__name__ for spec in folded.layers[:k])
    log(f"{what}: the {k} folded layers ({names}) alone under one cotangent, card against "
        f"CPU: output {prefix['card_vs_cpu_out']:.3g}, BN state "
        f"{prefix['card_vs_cpu_bn_state']:.3g}, param grads {prefix['card_vs_cpu_grads']:.3g}; "
        f"against the unfolded layers on the card: {prefix['fold_vs_unfolded_out']:.3g}, "
        f"{prefix['fold_vs_unfolded_bn_state']:.3g}, {prefix['fold_vs_unfolded_grads']:.3g} "
        f"(limits: output {PAR_ITEM_RTOL}, BN state {STEP_STATE_REL}, grads {STEP_UPDATE_L2})")
    for label in ("card_vs_cpu", "fold_vs_unfolded"):
        if not (prefix[f"{label}_out"] <= PAR_ITEM_RTOL
                and prefix[f"{label}_bn_state"] <= STEP_STATE_REL
                and prefix[f"{label}_grads"] <= STEP_UPDATE_L2):
            raise AssertionError(f"{what}: the folded layers {label}: {prefix}")
    return {"card": card, "pool_windows_rerouted": moved, "rerouted_gap": gap,
            "item_rel_err": items, "bn_state_rel_err": state, "folded_layers": prefix}


def step_pair(dev, plan_a, plan_b, batch_np, width, what, **kw):
    """One bf16 step of phase 7's yolov7 from the same state with plan_a
    and plan_b (each `make_train_step(**kw)`): their new TrainStates and
    step timings (ms a step, peak bytes)."""
    model = train_model(dev, width)
    opt = train_optim.OptimConfig()
    loss_fn = make_compute_loss_ota(model.plan.head, LossHyp())
    lr, mom = lr_after_warmup(opt)
    ts = init_train_state(model.params, model.state, opt, device=dev)
    out = {}
    for name, plan, extra in (("a", plan_a(model.plan), kw.get("a", {})),
                              ("b", plan_b(model.plan), kw.get("b", {}))):
        step = make_train_step(plan, loss_fn, opt, compute_dtype=torch.bfloat16, **extra)
        new = step(ts, *batch_np, lr, mom)
        again = step(ts, *batch_np, lr, mom)
        timing = (step_timing(lambda: step(ts, *batch_np, lr, mom), len(batch_np[0]), iters=5,
                              warmup=1, host_reps=2) if dev.type == "cuda" else {})
        out[name] = (new, again, timing)
    del model, ts
    return out


def layouts(dev, m, width=1.0, img=IMG, batch=BATCH, p6_img=IMG, what="layout (b)"):
    """Phase 15 (b) and (c): the layout passes at full width. (b1) phase 7's
    step with `make_train_fast_stem`: an fp32 step card against CPU by
    phase 7's rule where the pools allow it (`check_fold_step`), and the
    bf16 step's ms with and without the fold; (b2) the `split_concat` bf16
    engine against the plain engine (head inputs by the phase-4 rule,
    img/s beside); (b3) `make_lane_align` and
    `TrainReorgConv` on yolov7-w6 training at `p6_img` px, batch 2: the eval
    forward against the plain plan in fp32. (c) `remat_prefix=4` on phase
    7's bf16 step: params bit-equal with cuDNN deterministic (the step
    without it twice is the control), peak bytes and ms with and without."""
    res = {}
    fold = check_fold_step(dev, what=f"{what} fast stem")
    batch_np = train_batch(np.random.default_rng(7), batch, img)
    bench = step_pair(dev, lambda p: p, make_train_fast_stem, batch_np, width,
                      f"{what} fast stem")
    res["fast_stem"] = {"fp32_card_cpu": fold, "ms_plain": bench["a"][2].get("ms_step"),
                        "ms_fold": bench["b"][2].get("ms_step"),
                        "peak_plain": bench["a"][2].get("peak_bytes"),
                        "peak_fold": bench["b"][2].get("peak_bytes")}
    fin = all(bool(torch.isfinite(t).all()) for t in tree_leaves(bench["b"][0][0].params))
    log(f"{what} fast stem: the bf16 step (batch {batch}, {img} px) {res['fast_stem']['ms_plain']} "
        f"ms without the fold, {res['fast_stem']['ms_fold']} ms with it; peak "
        f"{res['fast_stem']['peak_plain']} / {res['fast_stem']['peak_fold']} bytes; finite {fin}")
    if not fin:
        raise AssertionError(f"{what}: the folded step's params are not finite")
    del bench

    # (b2) split_concat in the serving engine. On yolov7 the fused ELAN
    # spans (K3) absorb every concat whose readers are all 1x1 convs, so
    # the rewrite finds nothing there after the serving transforms (as in
    # the JAX engine, which applies it after its Pallas ELAN); yolov7-tiny,
    # where K3 declines, gives it its work
    on_v7 = ServingEngine(m.plan, m.params, m.state, batch_size=batch, img_size=m.img,
                          dtype=torch.bfloat16, device=dev, split_concat=True)
    n_v7 = sum(isinstance(s.block, SplitConcatConv) for s in on_v7.plan.layers)
    del on_v7
    tiny = make_model(dev, width, m.img, TINY_DEPLOY_CFG)
    rng = np.random.default_rng(16)
    frames = rng.integers(0, 256, (batch, tiny.img, tiny.img, 3), np.uint8)
    plain = ServingEngine(tiny.plan, tiny.params, tiny.state, batch_size=batch,
                          img_size=tiny.img, dtype=torch.bfloat16, device=dev)
    split = ServingEngine(tiny.plan, tiny.params, tiny.state, batch_size=batch,
                          img_size=tiny.img, dtype=torch.bfloat16, device=dev, split_concat=True)
    n_split = sum(isinstance(s.block, SplitConcatConv) for s in split.plan.layers)
    if n_split == 0:
        raise AssertionError(f"{what} split_concat: no conv of yolov7-tiny was rewritten")
    zero_counts()
    got_split = split.infer(frames)
    counts = read_counts()
    normalized, reference = make_reference(tiny)
    with torch.inference_mode():
        fs_, _ = apply_model(split.plan, split._params, split._state, normalized(frames),
                             dtype=torch.bfloat16, return_head_inputs=True)
        fp_, _ = apply_model(plain.plan, plain._params, plain._state, normalized(frames),
                             dtype=torch.bfloat16, return_head_inputs=True)
        f32, want32 = reference(frames, torch.float32)
        f16, want16 = reference(frames, torch.bfloat16)
    err_split, err_bf16 = feature_error(fs_, f32), feature_error(f16, f32)
    agree_s, agree_bf16 = agreement("split_concat", got_split, want32), agreement(
        "cuDNN bf16", want16, want32)
    speeds = {}
    if dev.type == "cuda":
        for name, e in (("plain", plain), ("split", split), ("plain_again", plain),
                        ("split_again", split)):
            speeds[name] = batch / cuda_ms(lambda e=e: e.infer_async(frames), iters=20) * 1e3
    log(f"{what} split_concat: yolov7 {n_v7} SplitConcatConv after the serving transforms; "
        f"yolov7-tiny {n_split}: head inputs {err_split:.5f} relative RMS from fp32 (the "
        f"plain engine {feature_error(fp_, f32):.5f}, cuDNN bf16 {err_bf16:.5f}; apart "
        f"{feature_error(fs_, fp_):.5f}); detections agree {agree_s:.3f} (cuDNN bf16 "
        f"{agree_bf16:.3f}); launches {counts}; img/s at batch {batch} {speeds}")
    if not err_split <= FEAT_RATIO * err_bf16 or not agree_s >= agree_bf16 - MATCH_MARGIN:
        raise AssertionError(f"{what} split_concat: head inputs {err_split}, agreement {agree_s}")
    res["split_concat"] = {"convs_yolov7": n_v7, "convs_tiny": n_split,
                           "feature_rms_err": err_split, "agreement": agree_s,
                           "img_s": speeds, "launches": counts}
    del plain, split, tiny

    # (b3) lane alignment and the ReOrg fold on w6 training, fp32
    w6 = train_model(dev, width, seed=4, cfg=P6_TRAIN_CFG)
    x = torch.from_numpy(np.random.default_rng(17).integers(
        0, 256, (LAYOUT_W6_BATCH, p6_img, p6_img, 3), np.uint8)).to(dev).float() / 255.0
    lane, folded = make_lane_align(w6.plan), make_train_fast_stem(w6.plan)
    n_lane = sum(isinstance(s.block, LaneAlignedConv) for s in lane.layers)
    with torch.inference_mode(), full_fp32():
        def feats(plan):
            return apply_model(plan, w6.params, w6.state, x, return_head_inputs=True)[0]

        want = feats(w6.plan)
        errs = {name: feature_error(feats(plan), want)
                for name, plan in (("lane_align", lane), ("reorg_fold", folded))}
    log(f"{what} w6 ({p6_img} px, batch {LAYOUT_W6_BATCH}, fp32): {n_lane} LaneAlignedConv, "
        f"layer 1 {type(folded.layers[1].block).__name__}; eval head inputs' relative RMS from "
        f"the plain plan's {errs} (limit {LAYOUT_REL})")
    if n_lane == 0 or type(folded.layers[1].block).__name__ != "TrainReorgConv" or \
            not max(errs.values()) <= LAYOUT_REL:
        raise AssertionError(f"{what} w6: {n_lane} lane-aligned convs, errors {errs}")
    res["w6"] = {"lane_aligned_convs": n_lane, "pred_rel_err": errs}
    del w6, x

    # (c) remat_prefix
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        bench = step_pair(dev, lambda p: p, lambda p: p, batch_np, width, "remat (c)",
                          b={"remat_prefix": 4})
    finally:
        torch.backends.cudnn.deterministic = det
    (a, a2, ta), (b, _, tb) = bench["a"], bench["b"]
    control, equal = same_step(a, a2), same_step(a, b)
    res["remat"] = {"control_equal": control, "equal": equal, "ms_plain": ta.get("ms_step"),
                    "ms_remat": tb.get("ms_step"), "peak_plain": ta.get("peak_bytes"),
                    "peak_remat": tb.get("peak_bytes")}
    log(f"remat (c): the bf16 step with remat_prefix 4 bit-equal with the step without it "
        f"{equal} (the step without it twice: {control}); ms a step {ta.get('ms_step')} without, "
        f"{tb.get('ms_step')} with; peak {ta.get('peak_bytes')} / {tb.get('peak_bytes')} bytes")
    if not control or not equal:
        raise AssertionError(f"remat (c): bit-equal {equal}, control {control}")
    return res


def native(dev, img=IMG, data=SMOKE_DATA, what="native (d)"):
    """Phase 15 (d): the native loader on phase 8's training JPEGs: built
    from the port's source (a failed build fails the phase where OpenCV's
    headers exist; where they do not, it says so and skips); each image
    bit-equal with the Python letterbox (RGB) and its metas; img/s at 1
    and 4 threads beside the Python letterbox's."""
    import cv2

    paths = sorted(str(p) for p in (data / "train" / "images").glob("*.jpg"))
    status = native_loader.native_status()
    headers = (native_loader.OPENCV_INCLUDE / "opencv2" / "core.hpp").exists()
    log(f"{what}: library {status}; OpenCV headers under {native_loader.OPENCV_INCLUDE}: "
        f"{headers}; {len(paths)} JPEGs")
    if not native_loader.native_available():
        if headers and shutil.which("g++"):
            raise AssertionError(f"{what}: the native loader did not build: {status}")
        log(f"{what}: skipped: no toolchain to build it ({status})")
        return {"built": False, "status": status}
    t = time.perf_counter()
    py = []
    for p in paths:
        im, r, (dw, dh) = letterbox(cv2.imread(p), img, auto=False, scaleup=False)
        py.append((im[:, :, ::-1], r[0], dw, dh))
    py_s = len(paths) / (time.perf_counter() - t)
    rates = {}
    for n in NATIVE_THREADS:
        native_loader.load_letterbox_batch(paths[:4], img, n_threads=n)
        t = time.perf_counter()
        out, metas = native_loader.load_letterbox_batch(paths, img, n_threads=n)
        rates[n] = len(paths) / (time.perf_counter() - t)
        for i, (im, r, dw, dh) in enumerate(py):
            if not np.array_equal(out[i], im) or not np.allclose(metas[i, :3], [r, dw, dh],
                                                                 atol=1e-5):
                raise AssertionError(f"{what}: {paths[i]} differs from the Python letterbox "
                                     f"({n} threads)")
    log(f"{what}: {len(paths)} images bit-equal with the Python letterbox; img/s native "
        f"{rates} (threads), Python letterbox {py_s:.1f} (one thread, cv2.imread + letterbox)")
    return {"built": True, "status": status, "img_s": rates, "python_img_s": py_s}


def eval_fp32_card_cpu(dev, img=IMG, what="eval fp32 (e)"):
    """Phase 15 (e): the fp32 pred of `evaluate`'s forward (yolov7 training
    form, full width, one frame, `device.full_fp32`) on the card against
    the same forward on the CPU, same weights and frame."""
    model = train_model(torch.device("cpu"), 1.0, seed=5)
    frame = np.random.default_rng(18).integers(0, 256, (1, img, img, 3), np.uint8)
    preds = {}
    for where in (dev, torch.device("cpu")):
        p = tree_map(lambda t: t.to(where), model.params)
        s = tree_map(lambda t: t.to(where), model.state)
        with torch.inference_mode(), full_fp32():
            x = torch.from_numpy(frame).to(where).float() / 255.0
            preds[where.type] = apply_model(model.plan, p, s, x)[0]["pred"].cpu()
    got, want = preds[dev.type], preds["cpu"]
    errs = {name: _rel_parts(got[..., sl], want[..., sl])
            for name, sl in (("boxes", slice(0, 4)), ("obj", slice(4, 5)),
                             ("cls", slice(5, None)))}
    log(f"{what}: card against CPU, one {img} px frame: {errs} of each part's largest |value| "
        f"(limit {EVAL_CPU_REL})")
    if not max(errs.values()) <= EVAL_CPU_REL:
        raise AssertionError(f"{what}: the card's fp32 pred is {errs} from the CPU's")
    return errs


def mesh_and_layout(dev, m, width=1.0, img=IMG, batch=BATCH, p6_img=IMG, phase4=None):
    """Phase 15: (a) the sharded engine, (b)-(c) the layout passes and
    remat_prefix, (d) the native loader, (e) the fp32 eval pred card
    against CPU. Returns the numbers, with the launches of (a)'s and (b)'s
    counted main paths."""
    t_phase = time.perf_counter()
    res = {"sharded": sharded(dev, m, batch=batch, phase4=phase4)}
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    res["layout"] = layouts(dev, m, width, img, batch, p6_img)
    res["native"] = native(dev, img)
    res["eval_fp32_card_cpu"] = eval_fp32_card_cpu(dev, img)
    res["launches"] = {kid: res["sharded"]["launches"][kid]
                       + res["layout"]["split_concat"]["launches"][kid] for kid in COUNTED}
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"mesh and layout: launches of its main paths {res['launches']}; phase "
        f"{res['phase_s']:.1f} s")
    return res


# ------------------------------------------------------------ main ---

KERNELS = (
    ("K1", "nms_keep_mask", "yolo_series_tpu_torch/csrc/nms_keep.cu",
     "yolo_series_tpu/ops/pallas_nms.py:24"),
    # the counterpart of an XLA function, not of a pallas_call: the tiled
    # keep-mask the JAX package's _nms_tail takes above 1024 candidates
    ("K1L", "nms_keep_mask_large", "yolo_series_tpu_torch/csrc/nms_keep.cu",
     "yolo_series_tpu/ops/nms.py:87"),
    ("K2", "fused_stem", "yolo_series_tpu_torch/csrc/conv_silu.cu",
     "yolo_series_tpu/ops/pallas_stem.py:78"),
    ("K3", "fused_elan", "yolo_series_tpu_torch/csrc/conv_silu.cu",
     "yolo_series_tpu/ops/pallas_elan.py:80"),
    ("K4", "int8_matmul_dequant", "yolo_series_tpu_torch/csrc/int8_mm.cu",
     "yolo_series_tpu/ops/pallas_int8.py:32"),
    ("K4b", "int8_mm.matmul", "yolo_series_tpu_torch/csrc/int8_mm.cu",
     "tools/bench_int8_pallas.py:65"),
)
# each kernel's wrapper, whose `launches` counts its launches
COUNTED = {"K1": nms_keep.nms_keep_mask, "K1L": nms_keep.nms_keep_mask_large,
           "K2": fused_stem.fused_stem,
           "K3": fused_elan.fused_elan, "K4": int8_mm.int8_matmul_dequant,
           "K4b": int8_mm.matmul}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    # fp32 comparisons run in full fp32, not TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = smi()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; card: {card}")

    secs = _build.build()
    log(f"build: {len(_build.SOURCES)} kernel sources in {secs:.1f} s")
    for src in _build.SOURCES:
        report = _build.LOGS.get(src)
        for line in (report or "built earlier: no ptxas report").splitlines():
            if report is None or "ptxas info" in line or "bytes stack frame" in line:
                log(f"{src}.cu {line.strip()}")

    m = make_model(dev)
    rows = {}
    check_k1(dev, rows)
    check_k1l(dev, rows, m)
    check_k2(dev, rows)
    check_k3(dev, rows)
    check_k4(dev, rows, m.plan)
    check_k4b(dev, rows)
    srv = serving(dev, m)
    srv8 = int8_serving(dev, m)
    full = full_int8(dev, m)
    det = detect(dev)
    ev = evaluation(dev, m)
    tr = train(dev)
    cli = train_and_test(dev)
    six = p6(dev, rows)
    par = ranks(dev)
    rest = zoo(dev)
    entry = entry_points(dev, m, cli["epochs"])
    tail_res = tail(dev)
    torch.cuda.empty_cache()
    tools = int8_and_tools(dev, m, srv["replay_ms_bs8"])
    torch.cuda.empty_cache()
    mesh = mesh_and_layout(dev, m, phase4=srv)

    # host-side counts of each kernel's main path: K1-K3 as the bf16
    # engines launched them (warm-up and capture; what the replays launch
    # is in the graph profiles' traces), K4 (and K4b: none) as the int8
    # engines did, K1L as detect, eval and the train and test CLIs did;
    # with the P6 phase's K1, K3 and K1L
    launches = {**srv["launches"], "K4": srv8["launches"]["K4"],
                "K4b": srv8["launches"]["K4b"],
                "K1L": det["launches"]["K1L"] + ev["launches"]["K1L"]
                + cli["launches_train"]["K1L"] + cli["launches_test"]["K1L"]}
    for kid, n in six["launches"].items():
        launches[kid] += n
    launches["K1L"] += par["launches"]["K1L"]
    for kid, n in rest["launches"].items():
        launches[kid] += n
    for kid, n in entry["launches"].items():
        launches[kid] += n
    for kid, n in tail_res["launches"].items():
        launches[kid] += n
    for kid, n in tools["launches"].items():
        launches[kid] += n
    for kid, n in mesh["launches"].items():
        launches[kid] += n
    for kid in COUNTED:
        if kid != "K4b" and launches[kid] == 0:
            raise AssertionError(f"{kid} was launched no time on its main path")
    kernels = []
    for kid, name, src, rep in KERNELS:
        r = rows[kid]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[kid],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        if kid in ("K1", "K1L"):   # one call above; the same call by graph replay
            kernels[-1]["graph_ms"] = r["graph_ms"]
        if kid == "K1L":   # measured: one call's peak allocation
            kernels[-1]["peak_bytes"] = r["peak_bytes"]
    keys = ("replays", "img_s", "device_ms_bs8", "replay_ms_bs8", "eager_ms_bs8", "p50_ms_bs8",
            "p50_ms_bs1", "host_ms_infer_async", "enqueue_ms_bs8", "profile",
            "profile_eager", "feature_rms_err", "feature_rms_err_cudnn_bf16",
            "agreement", "agreement_cudnn_bf16")
    log(json.dumps({"serving": {k: srv[k] for k in keys + ("ingest",)},
                    "int8_serving": {k: srv8[k] for k in keys + ("calibrate_s",)},
                    "full_int8": full, "detect": det, "eval": ev, "train": tr,
                    "train_test_cli": cli, "p6": six, "ranks": par, "zoo": rest,
                    "entry_points": entry, "tail": tail_res, "int8_and_tools": tools,
                    "mesh_and_layout": mesh,
                    "fused": {"K2": rows["K2"], "K3": rows["K3"]},
                    "k1l_runs": rows["k1l_runs"],
                    "stages": rows["stages"], "k4_convs": rows["k4_convs"],
                    "card": card}))
    log(json.dumps({"kernels": kernels}))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, train phase "
        f"{tr['phase_s']:.1f} s, train and test CLIs {cli['phase_s']:.1f} s, P6 "
        f"{six['phase_s']:.1f} s, ranks {par['phase_s']:.1f} s, zoo {rest['phase_s']:.1f} s, "
        f"entry points {entry['phase_s']:.1f} s, tail {tail_res['phase_s']:.1f} s, int8 and "
        f"tools {tools['phase_s']:.1f} s, mesh and layout {mesh['phase_s']:.1f} s")
    log(smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
