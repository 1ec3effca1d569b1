"""The boundary to the program under test, `yolo_series_tpu_torch`: the
only harness module that imports it. The program gets what a user would
give it: a cfg and a flat state dict in the upstream checkpoint's layout,
through its own `.pt` import and re-parameterization."""

from __future__ import annotations

import copy

import torch

from benchmark.harness import common


def _plan_and_params(cfg_dict, sd):
    from yolo_series_tpu_torch.models.graph import compile_graph
    from yolo_series_tpu_torch.models.torch_import import import_state_dict
    plan = compile_graph(copy.deepcopy(cfg_dict))
    params, state = import_state_dict(plan, sd)
    return plan, params, state


def engine(cfg: dict, sd, batch: int, int8: bool = False):
    """A bf16 `ServingEngine` of the configuration's deploy cfg on the card:
    `models/torch_import`, `models/reparam.fuse_model`, the engine's
    serving transforms and CUDA graph, its NMS settings the configuration's.
    int8: the program's full int8 path (`infer/quant.quantize_model`), the
    lower-precision control."""
    from yolo_series_tpu_torch.infer.serving import ServingEngine
    from yolo_series_tpu_torch.models.reparam import fuse_model
    plan, params, state = _plan_and_params(cfg["cfg_deploy"], sd)
    params, state = fuse_model(plan, params, state)
    if int8:
        from yolo_series_tpu_torch.infer.quant import quantize_model
        params, state = quantize_model(plan, params, state)
    nms = cfg["nms"]
    return ServingEngine(plan, params, state, batch_size=batch, img_size=cfg["img"],
                         dtype=torch.bfloat16, device=common.DEVICE,
                         conf_thres=nms["conf_thres"], iou_thres=nms["iou_thres"],
                         max_det=nms["max_det"], max_nms=nms["max_nms"])


def trainer(cfg: dict, sd, hyp: dict):
    """(plan, train step, its TrainState, (lr_groups, momentum), BatchUpload) of the
    configuration's training cfg: `train/step.make_train_step` with the OTA
    loss (`losses/ota.make_compute_loss_ota`, LossHyp's defaults:
    hyp.scratch.p5), SGD nesterov (`train/optim.OptimConfig`), bf16
    compute, EMA; the learning rates past warm-up from
    `train/schedules.warmup_factors`."""
    from yolo_series_tpu_torch.losses.ota import make_compute_loss_ota
    from yolo_series_tpu_torch.losses.yolo_loss import LossHyp
    from yolo_series_tpu_torch.train.optim import OptimConfig
    from yolo_series_tpu_torch.train.schedules import warmup_factors
    from yolo_series_tpu_torch.train.step import init_train_state, make_train_step
    from yolo_series_tpu_torch.train.trainer import BatchUpload
    plan, params, state = _plan_and_params(cfg["cfg_training"], sd)
    opt = OptimConfig(lr0=hyp["lr0"], momentum=hyp["momentum"],
                      weight_decay=hyp["weight_decay"], nesterov=True)
    loss_fn = make_compute_loss_ota(plan.head, LossHyp())
    step = make_train_step(plan, loss_fn, opt, compute_dtype=torch.bfloat16,
                           ema_base=hyp["ema_decay"])
    ts = init_train_state(params, state, opt, device=common.DEVICE)
    lr, mom = warmup_factors(hyp["warmup_steps"], hyp["warmup_steps"], 0.0, hyp["epochs"],
                             hyp["lr0"], hyp["lrf"], hyp["warmup_bias_lr"],
                             hyp["warmup_momentum"], hyp["momentum"])
    return plan, step, ts, (lr, mom), BatchUpload(torch.device(common.DEVICE))


def exported(plan, params, state) -> dict:
    """A params-shaped tree of the program's (params, the EMA's, the
    optimizer's momentum buffer) and a BN state tree, in the upstream
    checkpoint's layout, by the program's own `.pt` export
    (`models/torch_export.export_state_dict`): fp32 numpy arrays."""
    from yolo_series_tpu_torch.models.torch_export import export_state_dict
    return export_state_dict(plan, params, state)


def counters(engine_) -> dict:
    """The program's own counts: forwards run, CUDA-graph replays."""
    return {"batches": engine_.batches, "replays": engine_.replays}
