"""The port's train step against the JAX package on the CPU: `param_groups`,
SGD (nesterov) and Adam, the schedules, `warmup_accumulate`, the EMA, and
`make_train_step` on yolov7's training form (width 0.25, 128 px, batch 2,
fp32) with accumulation, freeze, loss_scale, uint8 ingest and resize.
Same numpy inputs and weights on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_util import (assert_trees_close, jax_training_model, to_jax_tree,
                                    to_numpy)
from yolo_series_tpu.losses import LossHyp as JHyp
from yolo_series_tpu.losses import make_compute_loss as jloss
from yolo_series_tpu.losses import make_compute_loss_ota as jloss_ota
from yolo_series_tpu.train import ema as jema
from yolo_series_tpu.train import optim as joptim
from yolo_series_tpu.train import schedules as jsched
from yolo_series_tpu.train import step as jstep
from yolo_series_tpu_torch.losses import LossHyp, make_compute_loss, make_compute_loss_ota
from yolo_series_tpu_torch.models.convert import from_jax_params
from yolo_series_tpu_torch.train import ema, optim, schedules
from yolo_series_tpu_torch.train.step import TrainState, init_train_state, make_train_step
from yolo_series_tpu_torch.models.model import tree_leaves as leaves

torch.set_num_threads(2)

SIZE, M = 128, 16


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def model():
    return jax_training_model(0.25, seed=0, stats_seed=1)


def _small_tree(rng):
    """A param tree with every kind of leaf the groups tell apart."""
    def a(*s):
        return rng.normal(0, 1, s).astype(np.float32)
    return {"layers": [{"w": a(3, 3, 4, 8), "bn": {"scale": a(8), "bias": a(8)}},
                       {"m": [{"w": a(1, 1, 8, 6), "b": a(6)}], "ia": [{"v": a(8)}],
                        "im": [{"v": a(6)}]},
                       [{"w": a(1, 1, 8, 8), "bn": {"scale": a(8), "bias": a(8)}}]]}


def _port(tree):
    """A JAX-form numpy tree as the port holds it (HWIO -> OIHW)."""
    def conv(x, key=None):
        if isinstance(x, dict):
            return {k: conv(v, k) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v, key) for v in x]
        t = torch.from_numpy(np.array(x))
        return t.permute(3, 2, 0, 1).contiguous() if key == "w" and t.ndim == 4 else t
    return conv(tree)


def test_param_groups_match_jax(model):
    """The group of every leaf, on a tree with each kind of leaf and on
    yolov7's training form, equals JAX's group tree."""
    _, params, _, _, tp, _ = model
    for tree in (_small_tree(np.random.default_rng(0)), params):
        assert optim.param_groups(_port(tree)) == joptim.param_groups(tree)
    assert optim.param_groups(tp) == joptim.param_groups(params)
    assert min(np.bincount(jax.tree_util.tree_leaves(joptim.param_groups(params)))) > 0


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_optimizer_three_updates_match_jax(kind):
    """Three updates with seeded grads and warmup-like changing group lrs and
    momentum: params and every optimizer slot within 1e-6 relative of
    JAX's (the same fp32 operations in the same order)."""
    rng = np.random.default_rng(1)
    params = _small_tree(rng)
    cfg_kw = dict(kind=kind, weight_decay=0.01)
    jinit, jupd = joptim.make_optimizer(joptim.OptimConfig(**cfg_kw), params)
    tinit, tupd = optim.make_optimizer(optim.OptimConfig(**cfg_kw), _port(params))
    jp, tp = _jax(params), _port(params)
    js, ts = jinit(jp), tinit(tp)
    for i in range(3):
        grads = jax.tree_util.tree_map(lambda x: rng.normal(0, 1, x.shape).astype(np.float32),
                                       params)
        lr = np.asarray([0.01 * (i + 1), 0.02, 0.1 / (i + 1)], np.float32)
        mom = np.float32(0.8 + 0.05 * i)
        jp, js = jupd(js, jp, _jax(grads), jnp.asarray(lr), jnp.asarray(mom))
        tp, ts = tupd(ts, tp, _port(grads), lr, mom)
        assert_trees_close(tp, jp, 1e-6, "params")
        for slot in ("m", "v") if kind == "adam" else ("v",):
            assert_trees_close(ts[slot], js[slot], 1e-6, slot)
    if kind == "adam":
        assert ts["t"] == int(js["t"]) == 3


def test_schedules_match_jax():
    """one_cycle_lr, linear_lr and warmup_factors (in and after warmup,
    both schedules) equal JAX's fp32 values; warmup_accumulate equal."""
    for e in (0, 0.5, 7.25, 299):
        assert float(schedules.one_cycle_lr(e, 300, 0.1)) == float(jsched.one_cycle_lr(e, 300, 0.1))
        assert float(schedules.linear_lr(e, 300, 0.1)) == pytest.approx(
            float(jsched.linear_lr(e, 300, 0.1)), rel=1e-7)
    for step, cosine in ((0, True), (37, True), (999, False), (1000, True), (5000, False)):
        args = (step, 1000, step / 500, 300, 0.01, 0.1, 0.1, 0.8, 0.937)
        lr, mom = schedules.warmup_factors(*args, cosine=cosine)
        jlr, jmom = jsched.warmup_factors(*args, cosine=cosine)
        np.testing.assert_allclose(lr.numpy(), np.asarray(jlr), rtol=1e-7)
        np.testing.assert_allclose(float(mom), float(jmom), rtol=1e-7)
    for ni in (0, 1, 250, 499, 500, 501, 1000, 4000):
        assert schedules.warmup_accumulate(ni, 1000, 4.0) == jsched.warmup_accumulate(ni, 1000, 4.0)


def test_ema_matches_jax():
    """ema_decay and ema_update on float leaves (params and BN stats) and
    an int leaf (copied), within 1e-7 relative of JAX's."""
    rng = np.random.default_rng(2)
    old = {"a": rng.normal(0, 1, (5, 3)).astype(np.float32), "n": np.arange(4, dtype=np.int32)}
    new = {"a": rng.normal(0, 1, (5, 3)).astype(np.float32), "n": np.arange(4, dtype=np.int32) + 7}
    for updates in (1, 3, 2000, 10 ** 6):
        assert float(ema.ema_decay(updates)) == float(jema.ema_decay(jnp.float32(updates)))
        want = jema.ema_update(_jax(old), _jax(new), jnp.float32(updates))
        got = ema.ema_update({k: torch.from_numpy(v) for k, v in old.items()},
                             {k: torch.from_numpy(v) for k, v in new.items()}, updates)
        np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]), rtol=1e-7)
        np.testing.assert_array_equal(got["n"].numpy(), np.asarray(want["n"]))
        assert got["n"].dtype == torch.int32


def test_init_train_state_needs_a_card(model, monkeypatch):
    """With no card visible, init_train_state() raises, and asked for the
    CPU it makes independent copies (writing the state leaves the caller's
    trees and the EMA alone)."""
    _, _, _, _, tp, ts = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(tp, ts, optim.OptimConfig())
    st = init_train_state(tp, ts, optim.OptimConfig(), device="cpu")
    leaves(st.params)[0].add_(1.0)
    leaves(st.state)[0].add_(1.0)
    assert not torch.equal(leaves(st.params)[0], leaves(tp)[0])
    assert torch.equal(leaves(st.ema_params)[0], leaves(tp)[0])
    assert torch.equal(leaves(st.ema_state)[0], leaves(ts)[0])
    assert st.step == 0 and all(not t.any() for t in leaves(st.opt_state["v"]))
    with pytest.raises(TypeError, match="process group"):
        make_train_step(None, None, optim.OptimConfig(), mesh=object())
    with pytest.raises(NotImplementedError, match="item 21"):
        make_train_step(None, None, optim.OptimConfig(), remat_prefix=3)


# ------------------------------------------------------------ train step ---

def _batch(rng, lead=(), uint8=False):
    shape = lead + (2, SIZE, SIZE, 3)
    images = (rng.integers(0, 256, shape, dtype=np.uint8) if uint8
              else rng.uniform(0, 1, shape).astype(np.float32))
    labels = np.zeros(lead + (2, M, 5), np.float32)
    mask = np.zeros(lead + (2, M), bool)
    for idx in np.ndindex(*lead, 2):
        k = int(rng.integers(3, 9))
        labels[idx][:k] = np.concatenate([rng.integers(0, 80, (k, 1)),
                                          rng.uniform(0.15, 0.85, (k, 2)),
                                          rng.uniform(0.05, 0.5, (k, 2))], 1)
        mask[idx][:k] = True
    return images, labels, mask


def _to_port_state(tplan, jts):
    """A JAX TrainState (numpy trees) as the port's TrainState."""
    def pair(p, s):
        return from_jax_params(tplan, p, s)
    params, state = pair(jts.params, jts.state)
    ema_p, ema_s = pair(jts.ema_params, jts.ema_state)
    opt = {k: pair(v, jts.state)[0] for k, v in jts.opt_state.items() if k != "t"}
    if "t" in jts.opt_state:
        opt["t"] = int(jts.opt_state["t"])
    return TrainState(params, state, opt, ema_p, ema_s, int(jts.step))


def _update_l2(got, want, before):
    """Relative L2 distance of two updates of one tree: |(got - before) -
    (want - before)| / |want - before| over all leaves."""
    g = jax.tree_util.tree_leaves(to_jax_tree(got))
    w = jax.tree_util.tree_leaves(to_numpy(want))
    b = jax.tree_util.tree_leaves(to_numpy(before))
    num = sum(float(np.square(x - y).sum()) for x, y in zip(g, w))
    den = sum(float(np.square(y - z).sum()) for y, z in zip(w, b))
    return (num / den) ** 0.5


def _check_adam_params(ts, before, lr, mom, freeze):
    """Adam's first steps move each weight by about lr x sign(grad), so
    where a grad is nearly 0 its sign is the two libraries' rounding noise
    and JAX's params are no reference. The port's new params must instead
    be the Adam update of its own new m and v (held against JAX above) in
    fp32, within 1e-6 of each leaf's largest update plus largest |param|
    (the subtraction rounds to the param's ulp); the frozen layers' params
    unchanged."""
    old = to_numpy(before["params"])
    m, v = to_jax_tree(ts.opt_state["m"]), to_jax_tree(ts.opt_state["v"])
    t = np.float32(ts.opt_state["t"])
    bc1 = np.float32(1) - np.float32(mom) ** t
    bc2 = np.float32(1) - np.float32(0.999) ** t
    groups = joptim.param_groups(old)
    new = to_jax_tree(ts.params)
    for li in range(len(old["layers"])):
        for path, p0 in jax.tree_util.tree_leaves_with_path(old["layers"][li]):
            get = lambda tree: _at(tree["layers"][li], path)  # noqa: E731
            gid = _at(groups["layers"][li], path)
            want = p0 if li < freeze else (
                p0 - lr[gid] * (get(m) / bc1) / (np.sqrt(get(v) / bc2) + np.float32(1e-8)))
            tol = 1e-6 * (np.abs(want - p0).max() + np.abs(p0).max())
            assert np.abs(get(new) - want).max() <= tol, (li, jax.tree_util.keystr(path))


def _check_ema(ts, before):
    """The EMA params equal e d + (1 - d) p of the port's new params, with
    d = ema_decay(step), within 1e-6 relative."""
    d = np.float32(0.9999) * (np.float32(1) - np.exp(-np.float32(ts.step) / np.float32(2000)))
    want = jax.tree_util.tree_map(lambda e, p: e * d + (np.float32(1) - d) * p,
                                  to_numpy(before["ema_params"]), to_jax_tree(ts.params))
    assert_trees_close(ts.ema_params, want, 1e-6, "ema_params")


def _at(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


# Each case: (loss, optimizer kind, make_train_step options, steps, uint8
# images, accumulate). Every step of the port starts from the JAX step's
# state before it (weights, BN state, optimizer slots, EMA and step count).
STEP_CASES = {
    "sgd_3_steps": ("plain", "sgd", {}, 3, False, 1),
    "ota_accumulate2_loss_scale4_uint8_down96": (
        "ota", "sgd", {"accumulate": 2, "loss_scale": 4.0, "resize_to": 96}, 1, True, 2),
    "adam_freeze2_uint8_up160": ("plain", "adam", {"freeze": 2, "resize_to": 160}, 2, True, 1),
}
# The step's numbers against JAX's, from the same state: the losses within
# 1e-5 relative, the new BN state and the EMA's BN state within 1e-5 of each
# leaf's largest value (forward only). The updates of the params, the EMA
# params and the optimizer slots by their relative L2 distance, within
# 1e-2: the gradient is a discontinuous function of the weights wherever two
# inputs of a max-pool window nearly tie, and a near-tie that the two
# libraries' fp32 roundings route to different inputs moves up to ~0.6% of
# the update (tests/torch_port_train_noise.py: JAX against itself with its
# input perturbed by 1e-7 relative moves 8.0e-5 and 4.2e-3, the port lies
# 1.8e-4 and 3.9e-4 from JAX; several steps in a row part by 20-50%). A
# wrong optimizer formula, accumulation, loss scale, freeze or EMA moves it
# by 10-100%.
STEP_LOSS_RTOL, STEP_STATE_REL, STEP_UPDATE_L2 = 1e-5, 1e-5, 1e-2


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax(model, case):
    loss, kind, opts, steps, uint8, acc = STEP_CASES[case]
    jplan, params, state, tplan, _, _ = model
    rng = np.random.default_rng(len(case))
    jlf = (jloss_ota if loss == "ota" else jloss)(jplan.head, JHyp())
    tlf = (make_compute_loss_ota if loss == "ota" else make_compute_loss)(tplan.head, LossHyp())
    jcfg, tcfg = joptim.OptimConfig(kind=kind), optim.OptimConfig(kind=kind)
    jfn = jstep.make_train_step(jplan, jlf, jcfg, compute_dtype=jnp.float32, **opts)
    tfn = make_train_step(tplan, tlf, tcfg, compute_dtype=torch.float32, **opts)
    jts = jstep.init_train_state(_jax(params), _jax(state), jcfg)
    for i in range(steps):
        images, labels, mask = _batch(rng, (acc,) if acc > 1 else (), uint8)
        lr = np.asarray([0.01, 0.01, 0.05 * (1 - i / 4)], np.float32)
        mom = np.float32(0.8 + 0.05 * i)
        before = jax.tree_util.tree_map(np.asarray, jts._asdict())
        ts = _to_port_state(tplan, jstep.TrainState(**before))
        jts, jm = jfn(jts, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(mask),
                      jnp.asarray(lr), jnp.asarray(mom))
        ts, tm = tfn(ts, images, labels, mask, lr, mom)
        assert set(tm) == set(jm) == {"box", "obj", "cls", "total"}
        for k in tm:
            assert tm[k].ndim == 0
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=STEP_LOSS_RTOL)
        assert ts.step == int(jts.step) == i + 1
        assert_trees_close(ts.state, jts.state, STEP_STATE_REL, "state")
        assert_trees_close(ts.ema_state, jts.ema_state, STEP_STATE_REL, "ema_state")
        for slot in ("m", "v") if kind == "adam" else ("v",):
            err = _update_l2(ts.opt_state[slot], jts.opt_state[slot], before["opt_state"][slot])
            assert err <= STEP_UPDATE_L2, (case, i, slot, err)
        if kind == "adam":
            _check_adam_params(ts, before, lr, mom, opts.get("freeze", 0))
        else:
            err = _update_l2(ts.params, jts.params, before["params"])
            assert err <= STEP_UPDATE_L2, (case, i, "params", err)
        err = _update_l2(ts.ema_params, jts.ema_params, before["ema_params"])
        assert err <= STEP_UPDATE_L2 or kind == "adam", (case, i, "ema_params", err)
        _check_ema(ts, before)
        if opts.get("freeze"):
            # the first layers' params and "v" slot as they were, bit for bit
            b = _to_port_state(tplan, jstep.TrainState(**before))
            for li in range(opts["freeze"]):
                for x, y in zip(leaves(ts.params["layers"][li]), leaves(b.params["layers"][li])):
                    assert torch.equal(x, y)
                for x, y in zip(leaves(ts.opt_state["v"]["layers"][li]),
                                leaves(b.opt_state["v"]["layers"][li])):
                    assert torch.equal(x, y)
                if kind == "adam":   # Adam's "m" of a frozen layer moves, as in JAX
                    assert any(t.any() for t in leaves(ts.opt_state["m"]["layers"][li]))
