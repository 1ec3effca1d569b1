"""The port's trainer on a small P6 model (ReOrg stem, DownC, Shortcut,
IAuxDetect at nl 4; `tests/test_torch_port_p6_train.p6lite_cfg`) against
the JAX trainer on the CPU: one epoch (one optimizer step) of each from
one checkpoint, held as tests/test_torch_port_trainer.py holds yolov7's
first step."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests._torch_port_util import port_drawn_model
from tests.test_torch_port_p6_train import IMG, NC, p6lite_cfg
from tests.test_torch_port_train import STEP_STATE_REL, STEP_UPDATE_L2, _update_l2
from tests.test_torch_port_trainer import _snapshot, _tree_rel_l2, _write_set
from yolo_series_tpu.train import checkpoints as jck
from yolo_series_tpu.train import optim as joptim
from yolo_series_tpu.train import step as jstep
from yolo_series_tpu.train import trainer as jtrainer
from yolo_series_tpu_torch.train import checkpoints as ck
from yolo_series_tpu_torch.train import trainer

torch.set_num_threads(2)


# The first step's loss items against JAX's through the two trainers (as
# tests/test_torch_port_trainer.py holds yolov7's): the step differs from
# JAX's by fp32 sums in another order, up to 3.0e-5 relative on random
# batches; a wrong batch, hyp scaling, loss or dispatch moves them by 1%.
LOSS_RTOL = 1e-4


def test_trainer_first_step_matches_jax(tmp_path):
    """Both trainers, one epoch (one optimizer step) from one checkpoint on
    a two-image shapes set at 128 px, batch 2, fp32, the P6 hyp
    (hyp.scratch.p6.yaml), autoanchor on at nl 4, no val: the IAuxDetect
    head takes the aux OTA loss in both. The losses within LOSS_RTOL, the
    BN state and its EMA within STEP_STATE_REL (relative L2 of the tree),
    the updates of the params, the momentum slot and the EMA params within
    STEP_UPDATE_L2; the checkpoints' cfg (with autoanchor's anchors)
    equal. An image size that is not a multiple of the largest stride (64)
    is rounded up to one."""
    cfg = str(tmp_path / "p6lite.yaml")
    _, params, state, _, _, _ = port_drawn_model(p6lite_cfg(tmp_path / "p6lite.yaml"),
                                                 seed=0, stats_seed=1)
    _write_set(tmp_path / "train", 2, 7, ((96, 128), (128, 112)))
    data = tmp_path / "data.yaml"
    data.write_text(yaml.dump({"train": str(tmp_path / "train" / "images"),
                               "val": str(tmp_path / "train" / "images"),
                               "nc": NC, "names": ["a", "b", "c"]}))
    weights = tmp_path / "init.ckpt"
    jts = jstep.init_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                                 jax.tree_util.tree_map(jnp.asarray, state),
                                 joptim.OptimConfig())
    jck.save_checkpoint(str(weights), jts, yaml.safe_load(open(cfg)))
    common = dict(cfg=cfg, data=str(data), epochs=1, batch_size=2, nominal_batch_size=2,
                  weights=str(weights), hyp="data/hyp.scratch.p6.yaml", max_labels=16,
                  noval=True, seed=0)
    jsnaps, psnaps = [], []
    random.seed(0)
    np.random.seed(0)
    jout = jtrainer.train(jtrainer.TrainConfig(
        img_size=IMG, save_dir=str(tmp_path / "jrun"), compute_dtype=jnp.float32,
        fast_stem=False, **common),
        callbacks={"on_epoch_end": lambda e, r, s: jsnaps.append(_snapshot(s))})
    calls = []
    real = trainer.make_compute_loss_aux_ota
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "make_compute_loss_aux_ota",
                   lambda *a, **kw: calls.append(a) or real(*a, **kw))
        pout = trainer.train(trainer.TrainConfig(
            img_size=IMG - 32, save_dir=str(tmp_path / "prun"), compute_dtype=torch.float32,
            device="cpu", **common),
            callbacks={"on_epoch_end": lambda e, r, s: psnaps.append(_snapshot(s))})
    assert len(calls) == 1          # the aux loss, once
    blob = jck.load_checkpoint(str(weights))
    got, want = psnaps[0], jsnaps[0]
    for k in ("box", "obj", "cls", "total"):
        np.testing.assert_allclose(pout["results"][0][f"train/{k}"],
                                   jout["results"][0][f"train/{k}"], rtol=LOSS_RTOL)
    assert got["step"] == int(want["step"]) == 1
    for k in ("state", "ema_state"):
        assert _tree_rel_l2(got[k], want[k]) <= STEP_STATE_REL, k
    f32 = lambda t: jax.tree_util.tree_map(lambda a: a.astype(np.float32), t)  # noqa: E731
    for name, g, w, b in (("params", got["params"], want["params"], f32(blob["params"])),
                          ("v", got["opt_state"]["v"], want["opt_state"]["v"],
                           blob["opt_state"]["v"]),
                          ("ema_params", got["ema_params"], want["ema_params"],
                           f32(blob["ema_params"]))):
        err = _update_l2(ck.from_jax_tree(g), w, b)
        assert err <= STEP_UPDATE_L2, (name, err)
    cfgs = [jck.load_checkpoint(f"{o['save_dir']}/weights/last.ckpt")["cfg"]
            for o in (jout, pout)]
    assert cfgs[0] == cfgs[1]
