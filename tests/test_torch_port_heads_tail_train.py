"""An IBin model's training in the port against the JAX package on the
CPU: one `make_train_step` with the bin-OTA loss from JAX's state, and
both trainers' first step on an IBin cfg (which each dispatches to the
bin-OTA loss, whatever `loss_ota` says). Same numpy inputs and weights on
both sides, fp32, width 0.25, 128 px, batch 2, 3 classes."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests._torch_port_util import assert_trees_close, port_drawn_model
from tests.test_torch_port_heads_tail import _ibin_tiny
from tests.test_torch_port_p6_train import BS, IMG, NC
from tests.test_torch_port_train import STEP_UPDATE_L2, _to_port_state, _update_l2
from tests.test_torch_port_trainer import _snapshot, _tree_rel_l2, _write_set
from tests.test_torch_port_zoo_train import STEP_LOSS_RTOL, ZOO_STATE_REL, _noise_batch
from yolo_series_tpu.losses import LossHyp as JHyp
from yolo_series_tpu.losses.bin_ota import make_compute_loss_bin_ota as jbin_ota
from yolo_series_tpu.train import checkpoints as jck
from yolo_series_tpu.train import optim as joptim
from yolo_series_tpu.train import step as jstep
from yolo_series_tpu.train import trainer as jtrainer
from yolo_series_tpu_torch.losses import LossHyp, make_compute_loss_bin_ota
from yolo_series_tpu_torch.models import heads as TH
from yolo_series_tpu_torch.train import checkpoints as ck
from yolo_series_tpu_torch.train import optim, trainer
from yolo_series_tpu_torch.train.step import make_train_step

torch.set_num_threads(2)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# The IBin model of the training tests is tiny with SiLU in LeakyReLU's
# place: LeakyReLU's slope jump at 0 makes tiny's step discontinuous
# (tests/test_torch_port_zoo_train.py), SiLU's does not, so the updates
# are held at STEP_UPDATE_L2.


def test_ibin_train_step_matches_jax():
    """One fp32 SGD step of the IBin model from JAX's state with the
    bin-OTA loss: the items within STEP_LOSS_RTOL, the BN state and its EMA
    within ZOO_STATE_REL, the updates of the params and the momentum slot
    within STEP_UPDATE_L2."""
    jplan, params, state, tplan, _, _ = port_drawn_model(_ibin_tiny(act="silu"), seed=0,
                                                         stats_seed=1)
    jfn = jstep.make_train_step(jplan, jbin_ota(jplan.head, JHyp()), joptim.OptimConfig(),
                                compute_dtype=jnp.float32)
    tfn = make_train_step(tplan, make_compute_loss_bin_ota(tplan.head, LossHyp()),
                          optim.OptimConfig(), compute_dtype=torch.float32)
    jts = jstep.init_train_state(_jax(params), _jax(state), joptim.OptimConfig())
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
                                before["opt_state"]["v"])):
        err = _update_l2(got, want, b)
        assert err <= STEP_UPDATE_L2, (what, err)


def test_ibin_trainer_first_step_matches_jax(tmp_path, capsys):
    """Both trainers, one epoch (one step) from one checkpoint of the IBin
    model with the tiny hyp and loss_ota 0: each takes the bin-OTA loss and
    says that loss_ota=0 is ignored; the loss items within 1e-4, the BN
    state and the params' update within STEP_UPDATE_L2."""
    cfg = _ibin_tiny(act="silu")
    cfg_path = tmp_path / "ibin.yaml"
    cfg_path.write_text(yaml.dump(cfg, sort_keys=False, default_flow_style=None))
    _, params, state, _, _, _ = port_drawn_model(cfg, seed=0, stats_seed=1)
    _write_set(tmp_path / "train", 2, 7, ((96, 128), (128, 112)))
    data = tmp_path / "data.yaml"
    data.write_text(yaml.dump({"train": str(tmp_path / "train" / "images"),
                               "val": str(tmp_path / "train" / "images"),
                               "nc": NC, "names": ["a", "b", "c"]}))
    hyp = yaml.safe_load(open("data/hyp.scratch.tiny.yaml"))
    hyp["loss_ota"] = 0
    hyp_path = tmp_path / "hyp.yaml"
    hyp_path.write_text(yaml.dump(hyp))
    weights = tmp_path / "init.ckpt"
    jts = jstep.init_train_state(_jax(params), _jax(state), joptim.OptimConfig())
    jck.save_checkpoint(str(weights), jts, cfg)
    common = dict(cfg=str(cfg_path), data=str(data), epochs=1, batch_size=BS,
                  nominal_batch_size=BS, weights=str(weights), hyp=str(hyp_path),
                  max_labels=16, noval=True, seed=0, img_size=IMG)
    jsnaps, psnaps = [], []
    random.seed(0)
    np.random.seed(0)
    jout = jtrainer.train(jtrainer.TrainConfig(
        save_dir=str(tmp_path / "jrun"), compute_dtype=jnp.float32, fast_stem=False, **common),
        callbacks={"on_epoch_end": lambda e, r, s: jsnaps.append(_snapshot(s))})
    assert capsys.readouterr().out.count("loss_ota=0 ignored") == 1
    calls = []
    real = trainer.make_compute_loss_bin_ota
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "make_compute_loss_bin_ota",
                   lambda *a, **kw: calls.append(a) or real(*a, **kw))
        pout = trainer.train(trainer.TrainConfig(
            save_dir=str(tmp_path / "prun"), compute_dtype=torch.float32, device="cpu",
            **common),
            callbacks={"on_epoch_end": lambda e, r, s: psnaps.append(_snapshot(s))})
    assert len(calls) == 1 and isinstance(calls[0][0], TH.IBin)
    assert capsys.readouterr().out.count("loss_ota=0 ignored") == 1
    blob = jck.load_checkpoint(str(weights))
    got, want = psnaps[0], jsnaps[0]
    for k in ("box", "obj", "cls", "total"):
        np.testing.assert_allclose(pout["results"][0][f"train/{k}"],
                                   jout["results"][0][f"train/{k}"], rtol=1e-4)
    assert got["step"] == int(want["step"]) == 1
    assert _tree_rel_l2(got["state"], want["state"]) <= STEP_UPDATE_L2
    f32 = lambda t: jax.tree_util.tree_map(lambda a: a.astype(np.float32), t)  # noqa: E731
    err = _update_l2(ck.from_jax_tree(got["params"]), want["params"], f32(blob["params"]))
    assert err <= STEP_UPDATE_L2, err
