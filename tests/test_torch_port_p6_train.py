"""Training the P6 family in the port against the JAX package on the CPU:
the aux OTA loss (both assignments from the lead maps, 3-positive top-20
for the lead and 5-positive top-20 for the aux, aux terms at 0.25) at nl 3
and nl 4, and one `make_train_step` of a small P6 model with the
IAuxDetect head, DownC and Shortcut on images whose DownC pools tie (the
trainer's first step on it: tests/test_torch_port_p6_trainer.py). Same
numpy inputs and weights on both sides, fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests._torch_port_util import assert_trees_close, port_drawn_model
from tests.test_torch_port_train import _to_port_state, _update_l2
from tools.train_accuracy_compare import write_auxlite_cfg
from yolo_series_tpu.losses import LossHyp as JHyp
from yolo_series_tpu.losses.aux_ota import make_compute_loss_aux_ota as jloss_aux
from yolo_series_tpu.losses.ota import ota_assign_batch as jassign
from yolo_series_tpu.models.graph import compile_graph as jcompile
from yolo_series_tpu.models.heads import IAuxDetect as JIAuxDetect
from yolo_series_tpu.train import optim as joptim
from yolo_series_tpu.train import step as jstep
from yolo_series_tpu_torch.losses import LossHyp, make_compute_loss_aux_ota
from yolo_series_tpu_torch.losses.ota import ota_assign_batch
from yolo_series_tpu_torch.models import layers as TL
from yolo_series_tpu_torch.models.graph import compile_graph
from yolo_series_tpu_torch.models.heads import IAuxDetect
from yolo_series_tpu_torch.train import checkpoints as ck
from yolo_series_tpu_torch.train import optim
from yolo_series_tpu_torch.train.step import make_train_step

torch.set_num_threads(2)

IMG, BS, M, NC = 128, 2, 24, 3


def _t(a):
    return torch.from_numpy(np.asarray(a))


def p6lite_cfg(path, nc=NC):
    """The JAX tests' small 4-level ReOrg + IAuxDetect cfg
    (`tools/train_accuracy_compare.write_auxlite_cfg`) with the P6 blocks
    it lacks: its /8 and /16 downsample convs become DownC (as in e6, e6e)
    and the first top-down concat a Shortcut (as in e6e). Written to
    `path`; returns the dict."""
    write_auxlite_cfg(path, nc=nc)
    d = yaml.safe_load(path.read_text())
    bb, head = d["backbone"], d["head"]
    assert bb[9][2:] == ["Conv", [64, 3, 2]] and bb[16][2:] == ["Conv", [128, 3, 2]]
    bb[9] = [-1, 1, "DownC", [64]]
    bb[16] = [-1, 1, "DownC", [128]]
    assert len(bb) == 37 and head[41 - 37] == [[-1, -2], 1, "Concat", [1]]
    head[41 - 37] = [[-1, -2], 1, "Shortcut", [1]]
    path.write_text(yaml.dump(d, sort_keys=False, default_flow_style=None))
    return d


# ---------------------------------------------------------------- aux loss ---

ANCHORS3 = ((12, 16, 19, 36, 40, 28), (36, 75, 76, 55, 72, 146),
            (142, 110, 192, 243, 459, 401))


def _aux_heads(nl, tmp_path):
    """(JAX head, port head) of nl levels: at nl 3 an IAuxDetect on
    yolov7's anchors and strides, at nl 4 the auxlite cfg's head."""
    if nl == 3:
        strides = (8.0, 16.0, 32.0)
        an = tuple(tuple(a / s for a in row) for row, s in zip(ANCHORS3, strides))
        kw = dict(nc=NC, anchors=an, ch=(32, 64, 128) * 2, strides=strides)
        return JIAuxDetect(**kw), IAuxDetect(**kw)
    cfg = tmp_path / "auxlite.yaml"
    write_auxlite_cfg(cfg, nc=NC)
    return jcompile(str(cfg)).head, compile_graph(str(cfg)).head


def _aux_case(seed, head):
    """Lead and aux raw maps (N(0, 1.5) logits) and up to 14 labels an
    image padded to M rows, rows 0 and 1 of an image sharing a centre."""
    rng = np.random.default_rng(seed)
    shapes = [(BS, 3, IMG // int(s), IMG // int(s), NC + 5) for s in head.strides]
    raw = [rng.normal(0, 1.5, s).astype(np.float32) for s in shapes * 2]
    labels = np.zeros((BS, M, 5), np.float32)
    mask = np.zeros((BS, M), bool)
    for b in range(BS):
        k = int(rng.integers(3, 15))
        xy = rng.uniform(0.05, 0.95, (k, 2))
        wh = rng.uniform(0.02, 0.6, (k, 2))
        xy[1], wh[1] = xy[0], wh[0] * 1.05
        labels[b, :k] = np.concatenate([rng.integers(0, NC, (k, 1)), xy, wh], 1)
        mask[b, :k] = True
        labels[b, k:] = rng.uniform(0, 1, (M - k, 5)) * [0, 1, 1, 1, 1]
    return raw, labels, mask


@pytest.mark.parametrize("nl,seed", [(3, 0), (3, 1), (4, 0), (4, 1)])
def test_aux_ota_loss_matches_jax(nl, seed, tmp_path):
    """`make_compute_loss_aux_ota` with `balance_for(nl)`: both assignments
    (g 0.5 and g 1.0, top-20, from the lead maps) equal to JAX's on every
    candidate column, the loss items and total within 1e-5 relative, and
    the grads of the 2 x nl raw maps within 1e-5 of each map's largest
    |grad| (the lead and the aux maps both get one)."""
    jhead, thead = _aux_heads(nl, tmp_path)
    assert thead.nl == nl and len(thead.ch) == 2 * nl
    raw, labels, mask = _aux_case(seed, thead)
    anchors = np.asarray(thead.anchors, np.float32).reshape(nl, 3, 2)
    strides = np.asarray(thead.strides, np.float32)
    for g in (0.5, 1.0):
        jfg, jmg, joffs = jassign([jnp.asarray(r) for r in raw[:nl]], jnp.asarray(labels),
                                  jnp.asarray(mask), anchors, strides, JHyp(), g, 20)
        fg, mg, offs = ota_assign_batch([_t(r) for r in raw[:nl]], _t(labels), _t(mask),
                                        anchors, strides, LossHyp(), g, 20)
        np.testing.assert_array_equal(fg.numpy(), np.asarray(jfg))
        np.testing.assert_array_equal(mg.numpy(), np.asarray(jmg))
        np.testing.assert_array_equal(offs, joffs)
        assert fg.any()
    jf = jloss_aux(jhead, JHyp())
    (want, witems), want_g = jax.value_and_grad(
        lambda r: jf(r, jnp.asarray(labels), jnp.asarray(mask)), has_aux=True)(
        [jnp.asarray(r) for r in raw])
    rt = [_t(r).requires_grad_() for r in raw]
    got, items = make_compute_loss_aux_ota(thead, LossHyp())(rt, _t(labels), _t(mask))
    got_g = torch.autograd.grad(got, rt)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert set(items) == set(witems) == {"box", "obj", "cls"}
    for k in items:
        np.testing.assert_allclose(float(items[k].detach()), float(witems[k]), rtol=1e-5,
                                   atol=1e-7)
    assert len(got_g) == 2 * nl
    for g, w in zip(got_g, want_g):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
    with pytest.raises(ValueError, match="aux loss needs"):
        make_compute_loss_aux_ota(thead, LossHyp())(rt[:nl], _t(labels), _t(mask))


# -------------------------------------------------------------- train step ---

@pytest.fixture(scope="module")
def p6lite(tmp_path_factory):
    path = tmp_path_factory.mktemp("p6lite") / "p6lite.yaml"
    cfg = p6lite_cfg(path)
    return (str(path),) + port_drawn_model(cfg, seed=0, stats_seed=1)


def _blocky_batch(rng):
    """uint8 images of constant 64 x 64 blocks (inside a block, away from
    its edges, every conv output is constant, so the first DownC's max
    pool ties across whole windows) and 3-8 labels an image, padded to
    16."""
    cells = rng.integers(0, 256, (BS, IMG // 64, IMG // 64, 3), dtype=np.uint8)
    images = np.repeat(np.repeat(cells, 64, 1), 64, 2)
    labels = np.zeros((BS, 16, 5), np.float32)
    mask = np.zeros((BS, 16), bool)
    for b in range(BS):
        k = int(rng.integers(3, 9))
        labels[b, :k] = np.concatenate([rng.integers(0, NC, (k, 1)),
                                        rng.uniform(0.15, 0.85, (k, 2)),
                                        rng.uniform(0.05, 0.5, (k, 2))], 1)
        mask[b, :k] = True
    return images, labels, mask


# The step against JAX's from the same state. This model's convs are 16-32
# channels wide and its train-mode BN renormalizes each one with the
# batch's moments, so the two libraries' fp32 rounding grows through its
# ~100 layers, as in tests/test_torch_port_p6.py: the loss items lie up to
# 1.5e-4 relative apart over four label seeds (yolov7 at width 0.25:
# 3.0e-5, tests/torch_port_train_noise.py), the new BN state up to 1.3e-5
# of a leaf's largest value, and the updates of the params, the momentum
# slot and the EMA params 2.1e-3 to 1.36e-2 by relative L2 (the max-pool
# near-ties of tests/test_torch_port_train.py, on top). A wrong loss, head,
# pool gradient or BN moves the items by 1% or more and the update by
# 10-100%.
STEP_LOSS_RTOL, P6_STATE_REL, P6_UPDATE_L2 = 5e-4, 1e-4, 3e-2


def test_train_step_matches_jax(p6lite, monkeypatch):
    """One SGD step (aux OTA loss, fp32) of the small P6 model from the same
    state on blocky uint8 images: the losses within STEP_LOSS_RTOL, the BN
    state and its EMA within P6_STATE_REL, the updates of the params, the
    momentum slot and the EMA params within P6_UPDATE_L2 (see there). The
    first DownC's pool sees windows whose four inputs tie (12288 of them
    inside the blocks): the port's pool must go through `MaxPoolTiled`,
    whose gradient splits each tie as JAX's does."""
    _, jplan, params, state, tplan, _, _ = p6lite
    assert sum(isinstance(s.block, TL.DownC) for s in tplan.layers) == 2
    assert sum(isinstance(s.block, TL.Shortcut) for s in tplan.layers) == 1
    ties = []
    real = TL.MaxPoolTiled.apply

    def spy(x, k):   # windows of each tiled pool with two or more maxima
        n, c, h, w = x.shape
        xr = x.detach().reshape(n, c, h // k, k, w // k, k)
        top = xr.amax((3, 5), keepdim=True)
        ties.append(int(((xr == top).sum((3, 5)) > 1).sum()))
        return real(x, k)

    monkeypatch.setattr(TL.MaxPoolTiled, "apply", staticmethod(spy))
    jfn = jstep.make_train_step(jplan, jloss_aux(jplan.head, JHyp()), joptim.OptimConfig(),
                                compute_dtype=jnp.float32)
    tfn = make_train_step(tplan, make_compute_loss_aux_ota(tplan.head, LossHyp()),
                          optim.OptimConfig(), compute_dtype=torch.float32)
    jts = jstep.init_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                                 jax.tree_util.tree_map(jnp.asarray, state),
                                 joptim.OptimConfig())
    images, labels, mask = _blocky_batch(np.random.default_rng(3))
    lr = np.asarray([0.01, 0.01, 0.05], np.float32)
    mom = np.float32(0.85)
    before = jax.tree_util.tree_map(np.asarray, jts._asdict())
    ts = _to_port_state(tplan, jstep.TrainState(**before))
    jts, jm = jfn(jts, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(mask),
                  jnp.asarray(lr), jnp.asarray(mom))
    ts, tm = tfn(ts, images, labels, mask, lr, mom)
    assert len(ties) >= 2 and ties[0] > 0, ties   # the DownC pools; the first's windows tie
    for k in ("box", "obj", "cls", "total"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=STEP_LOSS_RTOL)
    assert_trees_close(ts.state, jts.state, P6_STATE_REL, "state")
    assert_trees_close(ts.ema_state, jts.ema_state, P6_STATE_REL, "ema_state")
    for name, got, want, b in (("params", ts.params, jts.params, before["params"]),
                               ("v", ts.opt_state["v"], jts.opt_state["v"],
                                before["opt_state"]["v"]),
                               ("ema_params", ts.ema_params, jts.ema_params,
                                before["ema_params"])):
        err = _update_l2(got, want, b)
        assert err <= P6_UPDATE_L2, (name, err)
    # the aux convs learn: their params moved
    assert not np.allclose(ck.to_jax_tree(ts.params["layers"][-1]["m2"][0]["w"]),
                           before["params"]["layers"][-1]["m2"][0]["w"])
