"""The port's train-mode model against the JAX package on the CPU: BN with
batch moments (both moment forms, per-replica BN) and its custom gradient,
the tiled max pool's gradient on tied inputs, SPPCSPC's stride-1 pool
pyramid on tied inputs, and the whole yolov7 training form: raw maps, new
BN state and the grads of every param. Same numpy inputs and weights on
both sides, fp32, width 0.25, 96 px, batch 2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_util import assert_trees_close, jax_training_model, to_numpy
from yolo_series_tpu.models import layers as JL
from yolo_series_tpu.models.model import apply_model as japply
from yolo_series_tpu_torch.models import layers as TL
from yolo_series_tpu_torch.models.model import apply_model
from yolo_series_tpu_torch.models.model import tree_leaves as leaves
from yolo_series_tpu_torch.models.model import tree_rebuild as rebuild

torch.set_num_threads(2)

SIZE = 96


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def model():
    """yolov7 training form at width 0.25 with running stats off zero, and
    a batch of two 96 px images in [0, 1]."""
    x = np.random.default_rng(0).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    return jax_training_model(0.25, seed=0, stats_seed=1) + (x,)


@pytest.mark.parametrize("bn_shards", [1, 2])
def test_train_forward_matches_jax(model, bn_shards):
    """Raw maps within 2e-4 of each map's largest |value| (fp32 sums in
    another order, carried through ~100 layers and BN over 2 x 12 x 12
    values a channel at the coarsest level: 3.8e-5 measured), the new BN
    state within 1e-5 relative of each leaf's largest value. The training
    head returns the raw maps only."""
    jplan, params, state, tplan, tp, ts, x = model
    want, want_state = japply(jplan, _jax(params), _jax(state), jnp.asarray(x),
                              training=True, bn_shards=bn_shards)
    got, got_state = apply_model(tplan, tp, ts, torch.from_numpy(x), training=True,
                                 bn_shards=bn_shards)
    assert set(got) == {"raw"} == set(want)
    for g, w in zip(got["raw"], want["raw"]):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=2e-4 * np.abs(w).max())
    assert_trees_close(got_state, want_state, 1e-5, "BN state")
    # the running stats moved, and the input trees were not written
    assert not torch.equal(got_state["layers"][0]["bn"]["mean"], ts["layers"][0]["bn"]["mean"])
    np.testing.assert_array_equal(ts["layers"][0]["bn"]["mean"].numpy(),
                                  state["layers"][0]["bn"]["mean"])


def test_train_param_grads_match_jax(model):
    """The grads of every param of a fixed random projection of the raw
    maps, against `jax.grad` of the same projection: each leaf within 2e-3
    of its largest |grad| (4.1e-4 measured: the forward's fp32 rounding,
    carried back through the BN backward)."""
    jplan, params, state, tplan, tp, ts, x = model
    rng = np.random.default_rng(2)
    shapes = [(2, 3, SIZE // s, SIZE // s, 85) for s in (8, 16, 32)]
    proj = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]

    def jloss(p):
        out, _ = japply(jplan, p, _jax(state), jnp.asarray(x), training=True)
        return sum(jnp.sum(r * jnp.asarray(c)) for r, c in zip(out["raw"], proj))

    want = jax.jit(jax.grad(jloss))(_jax(params))
    ps = [t.detach().requires_grad_() for t in leaves(tp)]
    out, _ = apply_model(tplan, rebuild(tp, ps), ts, torch.from_numpy(x), training=True)
    loss = sum((r * torch.from_numpy(c)).sum() for r, c in zip(out["raw"], proj))
    got = rebuild(tp, list(torch.autograd.grad(loss, ps)))
    assert len(ps) == len(jax.tree_util.tree_leaves(want)) > 250
    assert_trees_close(got, want, 2e-3, "param grads")


@pytest.mark.parametrize("c,bn_shards", [(32, 1), (64, 1), (32, 2), (64, 2)])
def test_conv_bn_train_matches_jax(c, bn_shards):
    """ConvBnAct in training: the two-pass moments (C 32) and the shifted
    one-pass form (C 64, centred on a running mean off zero), per-replica
    BN (bn_shards 2), each against JAX: output, new state, and the grads
    of x, w and the BN affine through a random projection, within 1e-5 of
    each tensor's largest value (3x3 conv over 16 channels, fp32)."""
    rng = np.random.default_rng(c + bn_shards)
    blk_j, blk_t = JL.ConvBnAct(16, c, 3, 1), TL.ConvBnAct(16, c, 3, 1)
    x = rng.normal(0.3, 1, (4, 10, 12, 16)).astype(np.float32)
    w = rng.normal(0, 0.1, (3, 3, 16, c)).astype(np.float32)
    bn = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
          "bias": rng.normal(0, 0.1, c).astype(np.float32)}
    st = {"bn": {"mean": rng.normal(0.5, 0.3, c).astype(np.float32),
                 "var": rng.uniform(0.5, 2, c).astype(np.float32)}}
    proj = rng.normal(0, 1, (4, 10, 12, c)).astype(np.float32)
    jctx = JL.Ctx(training=True, bn_shards=bn_shards)

    def jf(x_, w_, s_, b_):
        y, ns = blk_j.apply({"w": w_, "bn": {"scale": s_, "bias": b_}}, _jax(st), x_, jctx)
        return jnp.sum(y * proj), (y, ns)

    (_, (want_y, want_st)), want_g = jax.value_and_grad(jf, (0, 1, 2, 3), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bn["scale"]), jnp.asarray(bn["bias"]))

    xt = _nchw(x).requires_grad_()
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_()
    st_, bt = (torch.from_numpy(bn[k]).requires_grad_() for k in ("scale", "bias"))
    tst = {"bn": {k: torch.from_numpy(v) for k, v in st["bn"].items()}}
    y, got_st = blk_t.apply({"w": wt, "bn": {"scale": st_, "bias": bt}}, tst, xt,
                            TL.Ctx(training=True, bn_shards=bn_shards))
    gx, gw, gs, gb = torch.autograd.grad((y * _nchw(proj)).sum(), (xt, wt, st_, bt))

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())

    close(_nhwc(y), want_y)
    for k in ("mean", "var"):
        close(got_st["bn"][k].numpy(), want_st["bn"][k])
    close(_nhwc(gx), want_g[0])
    close(gw.detach().numpy().transpose(2, 3, 1, 0), want_g[1])
    close(gs.numpy(), want_g[2])
    close(gb.numpy(), want_g[3])


def test_bn_train_core_mean_var_cotangents_match_jax():
    """BnTrainCore's backward with cotangents on all three outputs (y, mean
    and var), as `_bn_train_core`'s, within 1e-5 of the largest value."""
    rng = np.random.default_rng(5)
    for c in (32, 64):
        x = rng.normal(0.2, 1, (2, 6, 7, c)).astype(np.float32)
        scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
        bias = rng.normal(0, 0.1, c).astype(np.float32)
        m0 = rng.normal(0, 0.3, c).astype(np.float32)
        gy = rng.normal(0, 1, x.shape).astype(np.float32)
        gm, gv = (rng.normal(0, 1, c).astype(np.float32) for _ in range(2))
        outs, vjp = jax.vjp(lambda a, s, b: JL._bn_train_core(None, a, s, b, jnp.asarray(m0)),
                            jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
        want = vjp((jnp.asarray(gy), jnp.asarray(gm), jnp.asarray(gv)))
        xt = _nchw(x).requires_grad_()
        st, bt = torch.from_numpy(scale).requires_grad_(), torch.from_numpy(bias).requires_grad_()
        y, mean, var = TL.BnTrainCore.apply(xt, st, bt, torch.from_numpy(m0))
        got = torch.autograd.grad((y, mean, var), (xt, st, bt),
                                  (_nchw(gy), torch.from_numpy(gm), torch.from_numpy(gv)))
        for g, w in zip([_nhwc(got[0]), got[1].numpy(), got[2].numpy()], want):
            w = np.asarray(w)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())
        for g, w in zip((y, mean, var), outs):
            g = _nhwc(g) if g.ndim == 4 else g.detach().numpy()
            w = np.asarray(w)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_max_pool_ties_match_jax(dtype):
    """MP (2x2/2) on values from {0, 1/2, 1}, where most windows
    tie: the output and the gradient equal JAX's exactly (a window's
    gradient split equally among its tied maxima, g / count rounded once in
    the dtype on both sides)."""
    rng = np.random.default_rng(3)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    x = (rng.integers(0, 3, (2, 12, 16, 24)) / 2).astype(np.float32)     # NHWC
    g = rng.normal(0, 1, (2, 6, 8, 24)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: JL.MP(24).apply({}, {}, a, JL.Ctx())[0],
                        jnp.asarray(x, jdt))
    want_g, = vjp(jnp.asarray(g, jdt))
    xt = _nchw(x).to(tdt).requires_grad_()
    got, _ = TL.MP(24).apply({}, {}, xt, TL.Ctx())
    got_g, = torch.autograd.grad(got, xt, _nchw(g).to(tdt))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want, np.float32))
    np.testing.assert_array_equal(_nhwc(got_g), np.asarray(want_g, np.float32))
    xr = x.reshape(2, 6, 2, 8, 2, 24)
    ties = (xr == xr.max((2, 4), keepdims=True)).sum((2, 4)) > 1
    assert ties.mean() > 0.5      # the inputs do tie


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sppcspc_pool_pyramid_ties_match_jax(dtype):
    """SPPCSPC's stride-1 SAME pools (5, 9, 13, chained as three 5x5) on
    values from {0, 1/2, 1}: the pooled maps and the gradient of a random
    projection of them equal JAX's exactly (both route a tied window's
    gradient to its first maximum in row-major order)."""
    rng = np.random.default_rng(4)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    x = (rng.integers(0, 3, (2, 14, 14, 8)) / 2).astype(np.float32)
    proj = [rng.normal(0, 1, x.shape).astype(np.float32) for _ in range(3)]

    def jf(a):
        outs = JL.max_pool_pyramid(a, (5, 9, 13))
        return sum(jnp.sum(o.astype(jnp.float32) * p) for o, p in zip(outs, proj)), outs

    (_, want), want_g = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(x, jdt))
    xt = _nchw(x).to(tdt).requires_grad_()
    outs = TL.max_pool_pyramid(xt, (5, 9, 13))
    got_g, = torch.autograd.grad(sum((o.float() * _nchw(p)).sum() for o, p in zip(outs, proj)),
                                 xt)
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(_nhwc(o), np.asarray(w, np.float32))
    np.testing.assert_array_equal(_nhwc(got_g), np.asarray(want_g, np.float32))


def test_sppcspc_and_repconv_return_new_bn_state():
    """In training SPPCSPC returns the new state of its seven convs and
    RepConv that of its dense, 1x1 and identity BNs, equal to JAX's within
    1e-5 relative; in inference both hand back the state as it was."""
    rng = np.random.default_rng(6)
    gen = torch.Generator().manual_seed(0)
    x = rng.normal(0, 1, (2, 8, 8, 16)).astype(np.float32)
    for jb, tb in ((JL.SPPCSPC(16, 16), TL.SPPCSPC(16, 16)),
                   (JL.RepConv(16, 16), TL.RepConv(16, 16))):
        tp, ts = tb.init(gen)
        jp, js = jax.tree_util.tree_map(lambda t: t.numpy(), (tp, ts))
        jp = jax.tree_util.tree_map_with_path(
            lambda p, a: a.transpose(2, 3, 1, 0) if a.ndim == 4 else a, jp)
        _, want = jb.apply(_jax(jp), _jax(js), jnp.asarray(x), JL.Ctx(training=True))
        _, got = tb.apply(tp, ts, _nchw(x), TL.Ctx(training=True))
        assert_trees_close(got, want, 1e-5, type(tb).__name__)
        assert jax.tree_util.tree_structure(to_numpy(want)) == \
            jax.tree_util.tree_structure(to_numpy(js))
        _, same = tb.apply(tp, ts, _nchw(x), TL.Ctx())
        for a, b in zip(leaves(same), leaves(ts)):
            assert a is b
