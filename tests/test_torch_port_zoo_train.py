"""Training the rest of the zoo in the port against the JAX package on the
CPU: one `make_train_step` from JAX's state on yolov7-tiny (IDetect, the
OTA loss, LeakyReLU, MP and SP pools), yolov3 (Detect, the plain YOLO
loss, Bottleneck rows of 2-8 repeats through the three optimizer groups
and the EMA) and yolor-p6 (a four-level IDetect with the OTA loss,
BottleneckCSPA/B), and the trainer's first step on yolov7-tiny with the
tiny hyp. Same numpy inputs and weights on both sides, fp32, width 0.25,
128 px, batch 2, 3 classes."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests._torch_port_util import assert_trees_close, port_drawn_model
from tests.test_torch_port_p6_train import BS, IMG, NC, _blocky_batch
from tests.test_torch_port_train import STEP_STATE_REL, STEP_UPDATE_L2, _to_port_state, \
    _update_l2
from tests.test_torch_port_trainer import _snapshot, _tree_rel_l2, _write_set
from tests.test_torch_port_zoo_cfgs import zoo_dict
from yolo_series_tpu.losses import LossHyp as JHyp
from yolo_series_tpu.losses import make_compute_loss as jloss
from yolo_series_tpu.losses import make_compute_loss_ota as jloss_ota
from yolo_series_tpu.train import checkpoints as jck
from yolo_series_tpu.train import optim as joptim
from yolo_series_tpu.train import step as jstep
from yolo_series_tpu.train import trainer as jtrainer
from yolo_series_tpu_torch.losses import LossHyp, make_compute_loss, make_compute_loss_ota
from yolo_series_tpu_torch.models import heads as TH
from yolo_series_tpu_torch.train import checkpoints as ck
from yolo_series_tpu_torch.train import optim, trainer
from yolo_series_tpu_torch.train.step import make_train_step

torch.set_num_threads(2)

WIDTH = 0.25
# (cfg, loss, head, the update's limit): the loss each step takes, and how
# far its update may lie from JAX's (below)
STEPS = {"yolov7-tiny": ("training/yolov7-tiny", "ota", TH.IDetect, 5e-2),
         "yolov3": ("baseline/yolov3", "plain", TH.Detect, 1e-2),
         "yolor-p6": ("baseline/yolor-p6", "ota", TH.IDetect, 1e-2)}
# The step against JAX's from the same state, on noise frames (seed 4).
# Measured: the loss items within 4.8e-5 relative (yolor-p6; yolov3 2.0e-7,
# tiny 1.0e-5), the BN state within 3.6e-5 of a leaf's largest value, and
# the updates of the params, the momentum slot and the EMA params, by
# relative L2: yolov3 2.4e-5, yolor-p6 1.2e-3, tiny 3.4e-2. Tiny's is the
# step's own discontinuity, not the port's: LeakyReLU's slope jumps from 1
# to 0.1 at 0, a BN-centred pre-activation within fp32 rounding of 0 takes
# the other slope in another summation order, and BN's backward spreads
# that over its channel. JAX's step against itself, its params moved by
# 1e-7 relative, lies 3.42e-2 from itself on this batch (2.6e-5 with the
# opposite sign), the OTA assignment the same column for column; with SiLU
# in LeakyReLU's place a 1e-7 nudge moves the port's gradient by 1.5e-5 to
# 2.9e-5 only (width 0.5, 320 px). So the update within each model's limit
# above: a wrong loss, head or BN moves the items by 1% or more and the
# update by 10-100%. Blocky frames (constant squares) put the deep BN
# layers of yolor-p6 on near-constant maps, where their renormalization
# amplifies rounding to 2e-3 of the box loss; the tied pools they exercise
# are held block by block in tests/test_torch_port_zoo.py.
STEP_LOSS_RTOL, ZOO_STATE_REL = 5e-4, 1e-4


def _noise_batch(seed):
    """uint8 noise frames (BS, IMG, IMG, 3) and the labels and mask of
    `_blocky_batch` for the same seed."""
    _, labels, mask = _blocky_batch(np.random.default_rng(seed))
    images = np.random.default_rng(seed).integers(0, 256, (BS, IMG, IMG, 3)).astype(np.uint8)
    return images, labels, mask


@pytest.mark.parametrize("name", sorted(STEPS))
def test_train_step_matches_jax(name):
    """One SGD step (fp32) of each model from the same state: the losses
    within STEP_LOSS_RTOL, the BN state and its EMA within ZOO_STATE_REL,
    the updates within the model's limit (see above). Every param group
    moves: the last repeat of yolov3's first 8-repeat row too."""
    cfg, loss, head, update_l2 = STEPS[name]
    jplan, params, state, tplan, _, _ = port_drawn_model(zoo_dict(cfg, WIDTH, nc=NC), seed=0,
                                                         stats_seed=1)
    assert type(tplan.head) is head
    jlf = (jloss_ota if loss == "ota" else jloss)(jplan.head, JHyp())
    tlf = (make_compute_loss_ota if loss == "ota" else make_compute_loss)(tplan.head,
                                                                          LossHyp())
    jfn = jstep.make_train_step(jplan, jlf, joptim.OptimConfig(), compute_dtype=jnp.float32)
    tfn = make_train_step(tplan, tlf, optim.OptimConfig(), compute_dtype=torch.float32)
    jts = jstep.init_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                                 jax.tree_util.tree_map(jnp.asarray, state),
                                 joptim.OptimConfig())
    images, labels, mask = _noise_batch(4)
    lr = np.asarray([0.01, 0.01, 0.05], np.float32)
    mom = np.float32(0.85)
    before = jax.tree_util.tree_map(np.asarray, jts._asdict())
    ts = _to_port_state(tplan, jstep.TrainState(**before))
    jts, jm = jfn(jts, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(mask),
                  jnp.asarray(lr), jnp.asarray(mom))
    ts, tm = tfn(ts, images, labels, mask, lr, mom)
    for k in ("box", "obj", "cls", "total"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=STEP_LOSS_RTOL)
    assert_trees_close(ts.state, jts.state, ZOO_STATE_REL, "state")
    assert_trees_close(ts.ema_state, jts.ema_state, ZOO_STATE_REL, "ema_state")
    for what, got, want, b in (("params", ts.params, jts.params, before["params"]),
                               ("v", ts.opt_state["v"], jts.opt_state["v"],
                                before["opt_state"]["v"]),
                               ("ema_params", ts.ema_params, jts.ema_params,
                                before["ema_params"])):
        err = _update_l2(got, want, b)
        assert err <= update_l2, (what, err)
    if name == "yolov3":
        row = next(i for i, s in enumerate(tplan.layers) if s.n_seq == 8)
        w0 = before["params"]["layers"][row][7]["cv2"]["w"]
        got_w = ck.to_jax_tree(ts.params)["layers"][row][7]["cv2"]["w"]
        assert not np.allclose(got_w, w0)


# The first step's loss items through the two trainers, as
# tests/test_torch_port_p6_trainer.py holds them.
LOSS_RTOL = 1e-4


def test_trainer_first_step_matches_jax(tmp_path):
    """Both trainers, one epoch (one optimizer step) from one checkpoint of
    yolov7-tiny's training form on a two-image set at 128 px, batch 2,
    fp32, with the tiny hyp (hyp.scratch.tiny.yaml: its loss weights and
    its lighter augmentation), autoanchor on, no val: the OTA loss in both.
    The losses within LOSS_RTOL, the BN state and its EMA within
    STEP_STATE_REL (relative L2 of the tree), the updates of the params,
    the momentum slot and the EMA params within STEP_UPDATE_L2; the
    checkpoints' cfg equal."""
    cfg_path = tmp_path / "tiny.yaml"
    cfg = zoo_dict("training/yolov7-tiny", WIDTH, nc=NC)
    cfg_path.write_text(yaml.dump(cfg, sort_keys=False, default_flow_style=None))
    _, params, state, _, _, _ = port_drawn_model(cfg, seed=0, stats_seed=1)
    _write_set(tmp_path / "train", 2, 7, ((96, 128), (128, 112)))
    data = tmp_path / "data.yaml"
    data.write_text(yaml.dump({"train": str(tmp_path / "train" / "images"),
                               "val": str(tmp_path / "train" / "images"),
                               "nc": NC, "names": ["a", "b", "c"]}))
    weights = tmp_path / "init.ckpt"
    jts = jstep.init_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                                 jax.tree_util.tree_map(jnp.asarray, state),
                                 joptim.OptimConfig())
    jck.save_checkpoint(str(weights), jts, cfg)
    common = dict(cfg=str(cfg_path), data=str(data), epochs=1, batch_size=BS,
                  nominal_batch_size=BS, weights=str(weights),
                  hyp="data/hyp.scratch.tiny.yaml", max_labels=16, noval=True, seed=0,
                  img_size=IMG)
    jsnaps, psnaps = [], []
    random.seed(0)
    np.random.seed(0)
    jout = jtrainer.train(jtrainer.TrainConfig(
        save_dir=str(tmp_path / "jrun"), compute_dtype=jnp.float32, fast_stem=False, **common),
        callbacks={"on_epoch_end": lambda e, r, s: jsnaps.append(_snapshot(s))})
    calls = []
    real = trainer.make_compute_loss_ota
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "make_compute_loss_ota",
                   lambda *a, **kw: calls.append(a) or real(*a, **kw))
        pout = trainer.train(trainer.TrainConfig(
            save_dir=str(tmp_path / "prun"), compute_dtype=torch.float32, device="cpu",
            **common),
            callbacks={"on_epoch_end": lambda e, r, s: psnaps.append(_snapshot(s))})
    assert len(calls) == 1          # the OTA loss, once
    blob = jck.load_checkpoint(str(weights))
    got, want = psnaps[0], jsnaps[0]
    for k in ("box", "obj", "cls", "total"):
        np.testing.assert_allclose(pout["results"][0][f"train/{k}"],
                                   jout["results"][0][f"train/{k}"], rtol=LOSS_RTOL)
    assert got["step"] == int(want["step"]) == 1
    for k in ("state", "ema_state"):
        assert _tree_rel_l2(got[k], want[k]) <= STEP_STATE_REL, k
    f32 = lambda t: jax.tree_util.tree_map(lambda a: a.astype(np.float32), t)  # noqa: E731
    for what, g, w, b in (("params", got["params"], want["params"], f32(blob["params"])),
                          ("v", got["opt_state"]["v"], want["opt_state"]["v"],
                           blob["opt_state"]["v"]),
                          ("ema_params", got["ema_params"], want["ema_params"],
                           f32(blob["ema_params"]))):
        err = _update_l2(ck.from_jax_tree(g), w, b)
        assert err <= STEP_UPDATE_L2, (what, err)
    cfgs = [jck.load_checkpoint(f"{o['save_dir']}/weights/last.ckpt")["cfg"]
            for o in (jout, pout)]
    assert cfgs[0] == cfgs[1]
