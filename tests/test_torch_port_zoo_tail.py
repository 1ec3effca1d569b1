"""The long tail of the zoo in the port against the JAX package on the CPU:
the blocks no shipped cfg uses (PlainConv as a layer, DWConv, Focus,
Contract / Expand, Chuncat / Foldcut, GhostConv, Ghost, GhostCSPA/B/C,
SPPF, BatchNorm2d), those of `models/extra.py` and `models/attention.py`,
each in eval and in training (outputs, BN state, param and input grads);
OREPA's deploy, the registry, int8 quantization of a Focus plan, Swin
v2's k bias and its padded windows (whole models:
tests/test_torch_port_zoo_tail_cfgs.py). Same numbers on both sides (the
port draws them, `to_jax_tree` hands them to JAX), fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_util import assert_trees_close, to_numpy
from yolo_series_tpu.models import attention as JATT
from yolo_series_tpu.models import extra as JX
from yolo_series_tpu.models import graph as jgraph
from yolo_series_tpu.models import layers as JL
from yolo_series_tpu.models.layers import Ctx as JCtx
from yolo_series_tpu_torch.models import attention as TATT
from yolo_series_tpu_torch.models import extra as TX
from yolo_series_tpu_torch.models import graph as tgraph
from yolo_series_tpu_torch.models import layers as TL
from yolo_series_tpu_torch.models.convert import to_jax_tree
from yolo_series_tpu_torch.models.model import tree_leaves as leaves
from yolo_series_tpu_torch.models.model import tree_rebuild as rebuild

torch.set_num_threads(2)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    t = t.detach().float()
    return (t.permute(0, 2, 3, 1) if t.ndim == 4 else t).numpy()


def _close(got, want, rel, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _bn_stats(tree, gen):
    """Every BN running mean N(0, 0.2), every running var U(0.5, 1.5), in
    place."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "mean" and isinstance(v, torch.Tensor):
                v.normal_(0.0, 0.2, generator=gen)
            elif k == "var" and isinstance(v, torch.Tensor):
                v.uniform_(0.5, 1.5, generator=gen)
            else:
                _bn_stats(v, gen)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _bn_stats(v, gen)


def _grads_close(got, want, rel, what="", floor=1e-2, loose=None):
    """The port's grads (a tree) against JAX's, leaf by leaf: max |got -
    want| within rel of the larger of the leaf's largest |value| and
    `floor` of the whole tree's. A bias that a training BN follows has a
    zero gradient, which both packages give as rounding noise: such a leaf
    is held against the floor. Where JAX's gradient is NaN (Swin v2's norm
    at a zero-padded token, ROADMAP queue 3) the port's must be finite.
    loose: {leaf path prefix: rel} for leaves held at another limit."""
    g = jax.tree_util.tree_leaves_with_path(to_jax_tree(got))
    w = jax.tree_util.tree_leaves_with_path(to_numpy(want))
    assert [p for p, _ in g] == [p for p, _ in w], what
    top = max(np.nanmax(np.abs(np.asarray(b, np.float64)), initial=0.0) for _, b in w)
    for (path, a), (_, b) in zip(g, w):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        key = jax.tree_util.keystr(path)
        assert a.shape == b.shape and np.isfinite(a).all(), (what, key)
        ok = np.isfinite(b)
        r = next((v for k, v in (loose or {}).items() if key.startswith(k)), rel)
        scale = max(np.abs(b[ok]).max(initial=0.0), floor * top)
        err = np.abs(a - b)[ok].max(initial=0.0)
        assert err <= r * scale, (what, key, err, scale)


def _jit_apply(block, training):
    return jax.jit(lambda p, s, x: block.apply(p, s, x, JCtx(training=training)))


# ---------------------------------------------------------------- blocks ---

def _pair(name, *args, **kw):
    """(JAX block, port block) of the class `name`, from whichever module
    of each package holds it."""
    def pick(*mods):
        for mod in mods:
            if hasattr(mod, name):
                return getattr(mod, name)(*args, **kw)
        raise AttributeError(name)
    return pick(JL, JX, JATT), pick(TL, TX, TATT)


# (id, (JAX block, port block), input channels (a tuple: several inputs),
# input side, tied input). A tied input is made of constant 4 x 4 squares,
# so SPPF's stride-1 pools see windows whose inputs tie. The Swin inputs'
# sides are no multiple of their window: padded bottom-right, and the odd
# layers shifted and masked.
BLOCKS = [
    ("conv2d", _pair("PlainConv", 8, 16, 3, 1, 1), 8, 8, False),
    ("DWConv", _pair("DWConv", 16, 32, 3, 2), 16, 8, False),
    ("DWConvAct", _pair("DWConv", 16, 16, 5, 1, "leaky_relu:0.1"), 16, 8, False),
    ("Focus", _pair("Focus", 3, 16, 3), 3, 16, False),
    ("Contract", _pair("Contract", 4), 4, 8, False),
    ("Contract4", _pair("Contract", 3, 4), 3, 8, False),
    ("Expand", _pair("Expand", 16), 16, 4, False),
    ("Chuncat", _pair("Chuncat", (8, 6, 4)), (8, 6, 4), 4, False),
    ("Foldcut", _pair("Foldcut", 16), 16, 4, False),
    ("GhostConv", _pair("GhostConv", 16, 32, 3, 2), 16, 8, False),
    ("SPPF", _pair("SPPF", 16, 32), 16, 16, True),
    ("Ghost", _pair("Ghost", 16, 16), 16, 8, False),
    ("GhostS2", _pair("Ghost", 16, 32, 3, 2), 16, 8, False),
    ("GhostCSPA", _pair("GhostCSPA", 16, 32, 2), 16, 8, False),
    ("GhostCSPB", _pair("GhostCSPB", 16, 32, 2), 16, 8, False),
    ("GhostCSPC", _pair("GhostCSPC", 16, 32, 2), 16, 8, False),
    ("BatchNorm2d", _pair("BatchNorm2d", 16), 16, 4, False),
    ("FReLU", _pair("FReLU", 16), 16, 8, False),
    ("Sum", _pair("Sum", (8, 8, 8)), (8, 8, 8), 4, False),
    ("SumWeighted", _pair("Sum", (8, 8, 8), True), (8, 8, 8), 4, False),
    ("CrossConv", _pair("CrossConv", 16, 16, 3, 1, shortcut=True), 16, 8, False),
    ("CrossConvS2", _pair("CrossConv", 16, 32, 3, 2), 16, 8, False),
    ("MixConv2d", _pair("MixConv2d", 16, 16), 16, 8, False),
    ("MixConv2d3", _pair("MixConv2d", 16, 16, (1, 3, 5)), 16, 8, False),
    ("RobustConv", _pair("RobustConv", 16, 32, 7, 1), 16, 8, False),
    ("RobustConv2", _pair("RobustConv2", 16, 32, 7, 4), 16, 16, False),
    ("GhostSPPCSPC", _pair("GhostSPPCSPC", 32, 32), 32, 16, True),
    ("GhostStem", _pair("GhostStem", 3, 32), 3, 32, True),
    ("Classify", _pair("Classify", 16, 10), 16, 4, False),
    ("OREPA3x3", _pair("OREPA3x3", 16, 16), 16, 8, False),
    ("OREPA3x3S2", _pair("OREPA3x3", 16, 32, 3, 2), 16, 8, False),
    ("RepConvOREPA", _pair("RepConvOREPA", 16, 16), 16, 8, False),
    ("RepConvOREPAS2", _pair("RepConvOREPA", 16, 32, 3, 2), 16, 8, False),
    ("Swin", _pair("SwinTransformerBlock", 32, 32, 2, 2, window_size=4), 32, 10, False),
    ("Swin2Conv", _pair("SwinTransformerBlock", 16, 32, 2, 2, window_size=4, v2=True), 16, 10,
     False),
    ("STCSPA", _pair("STCSPA", 32, 64, 2), 32, 12, False),
    ("STCSPB", _pair("STCSPB", 32, 64, 1), 32, 12, False),
    ("STCSPC", _pair("STCSPC", 32, 64, 2), 32, 12, False),
    ("ST2CSPA", _pair("ST2CSPA", 32, 64, 2), 32, 12, False),
    ("ST2CSPB", _pair("ST2CSPB", 32, 64, 2), 32, 12, False),
    ("ST2CSPC", _pair("ST2CSPC", 32, 64, 1), 32, 12, False),
    ("Transformer", _pair("TransformerBlock", 32, 32, 4, 2), 32, 6, False),
    ("TransformerConv", _pair("TransformerBlock", 16, 32, 4, 1), 16, 6, False),
]
BLOCK_REL = 1e-5     # outputs and BN state, eval and training
GRAD_REL = 1e-4      # param and input grads


def _block_input(rng, c, side, tied):
    if isinstance(c, tuple):
        return [rng.normal(0, 1, (2, side, side, ci)).astype(np.float32) for ci in c]
    if tied:
        cells = rng.normal(0, 1, (2, side // 4, side // 4, c))
        return np.repeat(np.repeat(cells, 4, 1), 4, 2).astype(np.float32)
    return rng.normal(0, 1, (2, side, side, c)).astype(np.float32)


def _jin(x):
    return [jnp.asarray(a) for a in x] if isinstance(x, list) else jnp.asarray(x)


def _tin(x, grad=False):
    if isinstance(x, list):
        return [_nchw(a).requires_grad_(grad) for a in x]
    return _nchw(x).requires_grad_(grad)


@pytest.mark.parametrize("case", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_block_matches_jax(case):
    """The block's config (repr, width, stride, children), then in eval the
    output, and in training the output, the new BN state and the grads of
    every param and of the input(s) of a random projection, each within
    its limit of the largest |value|."""
    name, (jblock, tblock), c, side, tied = case
    assert repr(jblock) == repr(tblock)
    assert (jblock.cout, jblock.stride_factor) == (tblock.cout, tblock.stride_factor)
    if isinstance(jblock, JL.Composite):
        assert {k: repr(v) for k, v in jblock.children().items()} == \
            {k: repr(v) for k, v in tblock.children().items()}
    rng = np.random.default_rng(len(name))
    tp, ts = tblock.init(torch.Generator().manual_seed(0))
    _bn_stats(ts, torch.Generator().manual_seed(1))
    params, state = to_jax_tree(tp), to_jax_tree(ts)
    x = _block_input(rng, c, side, tied)

    want, _ = _jit_apply(jblock, False)(_jax(params), _jax(state), _jin(x))
    got, got_s = tblock.apply(tp, ts, _tin(x), TL.Ctx())
    _close(_nhwc(got), want, BLOCK_REL, f"{name} eval")
    assert all(a is b for a, b in zip(leaves(got_s), leaves(ts)))   # eval: state as it was
    proj = rng.normal(0, 1, np.asarray(want).shape).astype(np.float32)
    tproj = _nchw(proj) if proj.ndim == 4 else torch.from_numpy(proj)

    def jf(p, xx):
        y, s = jblock.apply(p, _jax(state), xx, JCtx(training=True))
        return jnp.sum(y * proj), (y, s)

    (_, (want, want_s)), (gp, gx) = jax.jit(jax.value_and_grad(jf, (0, 1), has_aux=True))(
        _jax(params), _jin(x))
    ps = [t.clone().requires_grad_() for t in leaves(tp)]
    xt = _tin(x, grad=True)
    xs = xt if isinstance(xt, list) else [xt]
    got, got_s = tblock.apply(rebuild(tp, ps), ts, xt, TL.Ctx(training=True))
    _close(_nhwc(got), want, BLOCK_REL, f"{name} train")
    grads = torch.autograd.grad((got * tproj).sum(), ps + xs)
    assert_trees_close({"layers": [got_s]}, {"layers": [to_numpy(want_s)]}, BLOCK_REL,
                       f"{name} state")
    if ps:
        _grads_close(rebuild(tp, list(grads[:len(ps)])), gp, GRAD_REL, f"{name} param grads")
    for g_t, g_j in zip(grads[len(ps):], gx if isinstance(gx, list) else [gx]):
        _close(_nhwc(g_t), g_j, GRAD_REL, f"{name} input grad")


def test_sppf_ties_go_to_the_first_maximum():
    """SPPF's chained stride-1 pools on a map of tied 4 x 4 squares: the
    input gradient lands on the first maximum of each window in both
    libraries (the same gradient to the last bit), not split as
    `MaxPoolTiled` splits it."""
    jblock, tblock = _pair("SPPF", 8, 8)
    tp, ts = tblock.init(torch.Generator().manual_seed(0))
    x = _block_input(np.random.default_rng(3), 8, 16, True)
    gx = jax.grad(lambda xx: jnp.sum(jblock.apply(_jax(to_jax_tree(tp)), _jax(to_jax_tree(ts)),
                                                  xx, JCtx())[0] ** 2))(jnp.asarray(x))
    xt = _nchw(x).requires_grad_()
    (tblock.apply(tp, ts, xt, TL.Ctx())[0] ** 2).sum().backward()
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx), rtol=1e-5, atol=1e-6)
    inner = TL.ConvBnAct(8, 4, 1, 1)
    y = inner.apply(tp["cv1"], ts["cv1"], xt.detach(), TL.Ctx())[0].requires_grad_()
    TL.max_pool(y, 5, 1, 2).sum().backward()
    assert set(np.unique(y.grad.numpy())) - {0.0} and (y.grad.numpy() > 1).any()


def test_channel_order_matches_jax_nhwc():
    """Focus, Contract, Expand and Chuncat on an index ramp: the port's
    channel c at pixel (i, j) holds the value JAX's NHWC block puts at
    (i, j, c), the order a wrong permute would still give the right shape
    for. Expand inverts Contract."""
    x = np.arange(2 * 8 * 8 * 3, dtype=np.float32).reshape(2, 8, 8, 3)
    for jb, tb in (_pair("Contract", 3), _pair("Contract", 3, 4)):
        want, _ = jb.apply({}, {}, jnp.asarray(x), JCtx())
        got, _ = tb.apply({}, {}, _nchw(x), TL.Ctx())
        np.testing.assert_array_equal(_nhwc(got), np.asarray(want))
        back, _ = TL.Expand(got.shape[1], tb.gain).apply({}, {}, got, TL.Ctx())
        np.testing.assert_array_equal(_nhwc(back), x)
    jfocus = JL.Focus(3, 4)
    want = jnp.concatenate([x[:, ::2, ::2], x[:, 1::2, ::2], x[:, ::2, 1::2], x[:, 1::2, 1::2]],
                           -1)
    np.testing.assert_array_equal(_nhwc(TL._space_to_depth(_nchw(x))), np.asarray(want))
    assert jfocus._conv().c1 == TL.Focus(3, 4)._conv().c1 == 12
    xs = [x, x[..., :2] + 1000]
    want, _ = JL.Chuncat((3, 2)).apply({}, {}, [jnp.asarray(a) for a in xs], JCtx())
    got, _ = TL.Chuncat((3, 2)).apply({}, {}, [_nchw(a) for a in xs], TL.Ctx())
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


# ------------------------------------------------------------------ OREPA ---

@pytest.mark.parametrize("c1,c2,s", [(16, 16, 1), (16, 32, 2)])
def test_orepa_deploy_equivalence(c1, c2, s):
    """`deploy` of OREPA3x3 and RepConvOREPA gives the eval output of the
    train form (JAX's own tolerance, tests/test_zoo.py:39-49), and the same
    {w, b} as JAX's deploy; the phantom identity row of `vector` is kept
    (c1 == c2, s == 1) and unread."""
    for name in ("OREPA3x3", "RepConvOREPA"):
        jb, tb = _pair(name, c1, c2, 3, s)
        tp, ts = tb.init(torch.Generator().manual_seed(0))
        _bn_stats(ts, torch.Generator().manual_seed(1))
        x = torch.randn((2, c1, 16, 16), generator=torch.Generator().manual_seed(2))
        y, _ = tb.apply(tp, ts, x, TL.Ctx())
        dp, ds = tb.deploy(tp, ts)
        y2, _ = tb.apply(dp, ds, x, TL.Ctx())
        np.testing.assert_allclose(y2.numpy(), y.numpy(), rtol=1e-3, atol=1e-4)
        jdp, _ = jb.deploy(_jax(to_jax_tree(tp)), _jax(to_jax_tree(ts)))
        assert_trees_close({"layers": [dp]}, {"layers": [to_numpy(jdp)]}, 1e-5, name)
        vec = (tp if name == "OREPA3x3" else tp["rbr_dense"])["vector"]
        assert vec.shape[0] == 5 + (c1 == c2 and s == 1)


# --------------------------------------------------------------- registry ---

def test_registry_accepts_every_jax_name():
    """Every module name of the JAX compiler's `_REF_NAMES` normalizes to
    the same canonical name in the port and compiles there (a block, a
    head or a routing layer); the v2 Swin block takes window 7."""
    routing = {"concat", "chuncat", "shortcut", "sum", "upsample"}
    for ref, canon in jgraph._REF_NAMES.items():
        assert tgraph._norm_module(ref) == canon
        assert (canon in tgraph._BLOCK_CLASSES or canon in tgraph._HEAD_CLASSES
                or canon in routing), ref
        assert (canon in tgraph._CONV_FAMILY) == (canon in jgraph._CONV_FAMILY), canon
        assert (canon in tgraph._TAKES_N) == (canon in jgraph._TAKES_N), canon
    b = tgraph._BLOCK_CLASSES["swintransformer2block"](32, 64, 2, 2)
    assert b == TATT.SwinTransformerBlock(32, 64, 2, 2, window_size=7, v2=True)
    assert repr(b) == repr(jgraph._BLOCK_CLASSES["swintransformer2block"](32, 64, 2, 2))


def test_v2_k_bias_is_zeroed_and_refused_by_export():
    """Swin v2: a nonzero k third of the qkv bias changes nothing in the
    forward (zeroed at every call, its gradient zero), and the exporter
    refuses it, as the JAX exporter does."""
    blk = TATT.SwinTransformerBlock(16, 16, 2, 2, window_size=4, v2=True)
    tp, ts = blk.init(torch.Generator().manual_seed(0))
    x = torch.randn((1, 16, 8, 8), generator=torch.Generator().manual_seed(1))
    y0, _ = blk.apply(tp, ts, x, TL.Ctx())
    b = tp["m0"]["attn"]["qkv"]["b"]
    b.requires_grad_()
    with torch.no_grad():
        b[16:32] = 0.5
    y1, _ = blk.apply(tp, ts, x, TL.Ctx())
    torch.testing.assert_close(y1, y0, rtol=0, atol=0)
    (g,) = torch.autograd.grad(y1.sum(), [b])
    assert (g[16:32] == 0).all() and (g[:16] != 0).any()
    plan = tgraph.compile_graph({"nc": 1, "anchors": [[10, 13, 16, 30, 33, 23]],
                                 "backbone": [[-1, 1, "SwinTransformer2Block", [16, 2, 2]]],
                                 "head": [[[0], 1, "Detect", ["nc", "anchors"]]]})
    with pytest.raises(ValueError, match="k-bias"):
        from yolo_series_tpu_torch.models.torch_export import export_block
        export_block(blk, {}, "model.0", {**tp, "m0": {**tp["m0"], "attn": {
            **tp["m0"]["attn"], "qkv": {"w": tp["m0"]["attn"]["qkv"]["w"], "b": b.detach()}}}},
            ts)
    assert plan.layers[0].block.window_size == 7


def test_swin_v2_padded_window_grads_stay_finite():
    """ROADMAP queue 3: at init (zero q / k biases) a Swin v2 window that
    holds zero-padded tokens has q = k = 0 there, and JAX's gradient of
    their norm is NaN, which reaches the qkv weight and bias; the port's
    `vector_norm` gives 0 there. Where JAX's grads are finite the two
    agree (GRAD_REL); the port's are finite everywhere."""
    jblock, tblock = _pair("SwinTransformerBlock", 16, 16, 2, 2, window_size=4, v2=True)
    tp, ts = tblock.init(torch.Generator().manual_seed(0))
    x = _block_input(np.random.default_rng(2), 16, 6, False)   # padded to 8

    def jf(p):
        return jnp.sum(jblock.apply(p, _jax(to_jax_tree(ts)), jnp.asarray(x),
                                    JCtx(training=True))[0])

    jg = to_numpy(jax.jit(jax.grad(jf))(_jax(to_jax_tree(tp))))
    assert not np.isfinite(jg["m0"]["attn"]["qkv"]["w"]).all()
    ps = [t.clone().requires_grad_() for t in leaves(tp)]
    y, _ = tblock.apply(rebuild(tp, ps), ts, _nchw(x), TL.Ctx(training=True))
    grads = torch.autograd.grad(y.sum(), ps)
    _grads_close({"layers": [rebuild(tp, list(grads))]}, {"layers": [jg]}, GRAD_REL,
                 "v2 padded")
