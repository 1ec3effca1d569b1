"""The rest of the zoo's blocks in the port against the JAX package on the
CPU: every activation spec, each new block (SP, SPP, Stem, Bottleneck,
Res, ResX and the BottleneckCSP / ResCSP / ResXCSP A/B/C wrappers) in eval
and in training (outputs, BN state, param and input grads), `nms_padded`,
the grouped int8 conv and `quantize_model` on x50-csp. Same numpy inputs
and weights on both sides (the port draws them, `to_jax_tree` hands them
to JAX), fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import clustered_boxes, feature_error
from tests._torch_port_util import (assert_trees_close, nms_chain, port_drawn_model,
                                    to_numpy, zoo_cfg)
from yolo_series_tpu.infer import quant as jquant
from yolo_series_tpu.models import layers as JL
from yolo_series_tpu.models import reparam as jreparam
from yolo_series_tpu.models.layers import Ctx as JCtx
from yolo_series_tpu.models.model import apply_model as japply
from yolo_series_tpu.ops import nms as jnms
from yolo_series_tpu_torch.infer import quant as tquant
from yolo_series_tpu_torch.models import layers as TL
from yolo_series_tpu_torch.models import reparam as treparam
from yolo_series_tpu_torch.models.convert import from_jax_params, to_jax_tree
from yolo_series_tpu_torch.models.model import apply_model
from yolo_series_tpu_torch.models.model import tree_leaves as leaves
from yolo_series_tpu_torch.models.model import tree_rebuild as rebuild
from yolo_series_tpu_torch.ops import nms as tnms
from yolo_series_tpu_torch.ops import nms_keep

torch.set_num_threads(2)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _close(got, want, rel, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


# ---------------------------------------------------------- activations ---

SPECS = [True, False, None, "silu", "relu", "relu6", "hardswish", "mish", "sigmoid",
         "identity", "leaky_relu", "leaky_relu:0.1", "leaky_relu:0.2", "nn.SiLU()",
         "nn.SiLU", "nn.ReLU()", "nn.ReLU6()", "nn.Hardswish()", "nn.Mish()",
         "nn.Identity()", "nn.LeakyReLU(0.1)", "nn.LeakyReLU()", " leaky_relu:0.1 "]


@pytest.mark.parametrize("spec", SPECS, ids=[repr(s) for s in SPECS])
def test_activation_matches_jax(spec):
    """`get_activation` gives JAX's canonical name (the string that
    `repr(block)` holds on both sides) and the same function: values and
    gradients on [-8, 8] (the kinks of relu6 and hardswish included)
    within 1e-6."""
    jname, jfn = JL.get_activation(spec)
    tname, tfn = TL.get_activation(spec)
    assert tname == jname
    x = np.concatenate([np.linspace(-8, 8, 1001), [-3.0, 0.0, 3.0, 6.0]]).astype(np.float32)
    jgrad = jax.grad(lambda v: jnp.sum(jfn(v) * jnp.arange(v.shape[0])))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = tfn(xt)
    (got * torch.arange(x.shape[0])).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jfn(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("spec", ["gelu", "nn.GELU()", "swish", "leaky_relu:x"])
def test_unknown_activation_raises_like_jax(spec):
    with pytest.raises(ValueError):
        JL.get_activation(spec)
    with pytest.raises(ValueError):
        TL.get_activation(spec)


# --------------------------------------------------------------- blocks ---

# (name, JAX block, port block, input channels, input side, tied input).
# A tied input is made of constant 8 x 8 squares: SP's stride-1 windows
# and the 2 x 2 / 2 pool of Stem (after its k3 / s2 conv) see windows whose
# inputs tie. n = 2 for the CSP wrappers; ResX's 3 x 3 convs have 32
# groups.
BLOCKS = [
    ("SP5", JL.SP(8, 5), TL.SP(8, 5), 8, 16, True),
    ("SP3s2", JL.SP(8, 3, 2), TL.SP(8, 3, 2), 8, 16, True),
    ("ConvLeaky", JL.ConvBnAct(8, 16, 3, 1, None, 1, "leaky_relu:0.1"),
     TL.ConvBnAct(8, 16, 3, 1, None, 1, "leaky_relu:0.1"), 8, 8, False),
    ("SPP", JL.SPP(16, 32), TL.SPP(16, 32), 16, 16, False),
    ("Stem", JL.Stem(3, 32), TL.Stem(3, 32), 3, 32, True),
    ("Bottleneck", JL.Bottleneck(16, 16), TL.Bottleneck(16, 16), 16, 8, False),
    ("BottleneckWide", JL.Bottleneck(16, 32), TL.Bottleneck(16, 32), 16, 8, False),
    ("Res", JL.Res(16, 16), TL.Res(16, 16), 16, 8, False),
    ("ResX", JL.ResX(64, 64), TL.ResX(64, 64), 64, 8, False),
] + [(cls, getattr(JL, cls)(c, 2 * c, 2), getattr(TL, cls)(c, 2 * c, 2), c, 8, False)
     for cls, c in [("BottleneckCSPA", 16), ("BottleneckCSPB", 16), ("BottleneckCSPC", 16),
                    ("ResCSPA", 16), ("ResCSPB", 16), ("ResCSPC", 16),
                    ("ResXCSPA", 32), ("ResXCSPB", 32), ("ResXCSPC", 32)]]
# eval: fp32 rounding only. training: BN renormalizes with the batch's
# moments over 2 x 8 x 8 values a channel, which amplifies the two
# libraries' rounding a little through the chained BNs of a block.
BLOCK_EVAL_REL, BLOCK_TRAIN_REL = 1e-5, 2e-5


def _block_input(rng, c, side, tied):
    if tied:
        cells = rng.normal(0, 1, (2, side // 8, side // 8, c))
        return np.repeat(np.repeat(cells, 8, 1), 8, 2).astype(np.float32)
    return rng.normal(0, 1, (2, side, side, c)).astype(np.float32)


@pytest.mark.parametrize("case", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_block_matches_jax(case, monkeypatch):
    """The block's config (its repr, its width and stride, its children),
    then in eval the output, and in training the output, the new BN state
    and the grads of every param and of the input of a random projection,
    each within its limit of the largest |value|. Stem's pool goes through
    `MaxPoolTiled` (ties split equally, as JAX's), SP's stride-1 pool
    sends a tie to the first maximum in both libraries."""
    name, jblock, tblock, c, side, tied = case
    assert repr(jblock) == repr(tblock)
    assert (jblock.cout, jblock.stride_factor) == (tblock.cout, tblock.stride_factor)
    if isinstance(jblock, JL.Composite):
        assert {k: repr(v) for k, v in jblock.children().items()} == \
            {k: repr(v) for k, v in tblock.children().items()}
    rng = np.random.default_rng(len(name))
    tp, ts = tblock.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    for key, t in _bn_state_leaves(ts):   # running stats off (0, 1)
        if key == "mean":
            t.normal_(0, 0.2, generator=gen)
        else:
            t.uniform_(0.5, 1.5, generator=gen)
    params, state = to_jax_tree(tp), to_jax_tree(ts)
    x = _block_input(rng, c, side, tied)
    ties = []
    real = TL.MaxPoolTiled.apply

    def spy(xx, k):   # tied windows of each tiled pool
        n, cc, h, w = xx.shape
        xr = xx.detach().reshape(n, cc, h // k, k, w // k, k)
        ties.append(int(((xr == xr.amax((3, 5), keepdim=True)).sum((3, 5)) > 1).sum()))
        return real(xx, k)

    monkeypatch.setattr(TL.MaxPoolTiled, "apply", staticmethod(spy))
    want, _ = jblock.apply(_jax(params), _jax(state), jnp.asarray(x), JCtx())
    got, got_s = tblock.apply(tp, ts, _nchw(x), TL.Ctx())
    _close(_nhwc(got), want, BLOCK_EVAL_REL, f"{name} eval")
    assert all(a is b for a, b in zip(leaves(got_s), leaves(ts)))   # eval: state as it was
    proj = rng.normal(0, 1, np.asarray(want).shape).astype(np.float32)

    def jf(p, xx):
        y, s = jblock.apply(p, _jax(state), xx, JCtx(training=True))
        return jnp.sum(y * proj), (y, s)

    (_, (want, want_s)), (gp, gx) = jax.value_and_grad(jf, (0, 1), has_aux=True)(
        _jax(params), jnp.asarray(x))
    ps = [t.clone().requires_grad_() for t in leaves(tp)]
    xt = _nchw(x).requires_grad_()
    got, got_s = tblock.apply(rebuild(tp, ps), ts, xt, TL.Ctx(training=True))
    _close(_nhwc(got), want, BLOCK_TRAIN_REL, f"{name} train")
    if not ps:   # a pool: no params, no state
        (gx_t,) = torch.autograd.grad((got * _nchw(proj)).sum(), [xt])
    else:
        grads = torch.autograd.grad((got * _nchw(proj)).sum(), ps + [xt])
        gx_t = grads[-1]
        assert_trees_close({"layers": [got_s]}, {"layers": [want_s]}, BLOCK_TRAIN_REL,
                           f"{name} state")
        assert_trees_close({"layers": [rebuild(tp, list(grads[:-1]))]}, {"layers": [gp]},
                           1e-4, f"{name} param grads")
    _close(_nhwc(gx_t), gx, 1e-4, f"{name} input grad")
    if name == "Stem":
        assert len(ties) == 2 and ties[0] > 0, ties   # eval and train; windows tie
    if isinstance(tblock, TL.SP):
        k = tblock.k
        assert (x[:, :k, :k] == x[:, :1, :1]).all()   # a window with all inputs tied


def _bn_state_leaves(tree, key=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _bn_state_leaves(v, k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _bn_state_leaves(v, key)
    elif isinstance(tree, torch.Tensor):
        yield key, tree


def test_cspb_defaults_and_hidden_width():
    """The two JAX details: BottleneckCSPB's shortcut is off by default (the
    other wrappers' on), and topology B's hidden width is c2, not c2 * e."""
    b = TL.BottleneckCSPB(32, 64, 2)
    assert b.shortcut is False and TL.BottleneckCSPA(32, 64).shortcut is True
    assert b.children()["cv1"].c2 == 64 and b.children()["m1"] == TL.Bottleneck(64, 64, False,
                                                                                 1, 1.0)
    assert TL.BottleneckCSPC(32, 64).children()["cv1"].c2 == 32
    assert TL.ResXCSPB(64, 64).g == 32 and TL.ResX(64, 64).g == 32
    assert type(TL.ResX(64, 64)) is TL.Res


# ------------------------------------------------------------ nms_padded ---

def _nms_case(name):
    if name == "test_nms_400":   # tests/test_nms.py::test_nms_padded_indices
        boxes, scores = clustered_boxes(np.random.default_rng(7), 400)
        return boxes, scores, 0.5, 100
    rng = np.random.default_rng(11)
    boxes, scores = clustered_boxes(rng, 2000)
    scores[rng.integers(0, 2000, 300)] = -np.inf          # invalid rows
    scores[:400:4] = scores[1:401:4]                      # equal scores
    if name == "chain_2000":   # a chain whose fixpoint needs every pass
        boxes[:600] = nms_chain(600)
        scores[:600] = np.linspace(0.99, 0.9, 600)
    return boxes, scores, 0.45, 300


@pytest.mark.parametrize("name", ["test_nms_400", "mixed_2000", "chain_2000"])
def test_nms_padded_matches_jax(name):
    """`nms_padded` against JAX's on the same boxes: indices and count
    equal. 400 rows take the keep-mask for K <= 1024 (K1 on the card),
    2000 rows the large-K one (K1L); on the CPU both are the plain
    version. -inf rows are invalid; equal scores keep the lower index
    first (a stable sort)."""
    boxes, scores, thr, max_out = _nms_case(name)
    want_idx, want_n = jnms.nms_padded(jnp.asarray(boxes), jnp.asarray(scores), thr,
                                       max_output=max_out)
    k1, k1l = nms_keep.nms_keep_mask.launches, nms_keep.nms_keep_mask_large.launches
    idx, n = tnms.nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores), thr,
                             max_output=max_out, tile=128)
    assert (nms_keep.nms_keep_mask.launches, nms_keep.nms_keep_mask_large.launches) == (k1, k1l)
    assert idx.dtype == torch.int32 and idx.shape == (max_out,) and n.dtype == torch.int32
    assert int(n) == int(want_n) > 20
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


# ----------------------------------------------------------------- int8 ---

@pytest.mark.parametrize("k,s,pad,c,n,g,static", [
    (3, 1, 1, 64, 64, 32, True),       # ResX's 3 x 3 at the narrowest width
    (3, 2, 1, 128, 64, 32, False),
    (1, 1, 0, 256, 256, 32, True),     # grouped 1 x 1 stays off K4
    (3, 1, 1, 48, 96, 3, False),
])
def test_grouped_int8_conv_matches_jax(k, s, pad, c, n, g, static):
    """`quant.int8_conv` with groups against JAX's (XLA's int8 conv with
    `feature_group_count`): bit-equal. The int32 sums of each group are
    exact and the epilogue rounds as JAX's."""
    rng = np.random.default_rng(c + g)
    x = rng.normal(0, 1.0, (2, 10, 12, c)).astype(np.float32)
    w = rng.normal(0, 0.1, (k, k, c // g, n)).astype(np.float32)
    b = rng.normal(0, 0.1, (n,)).astype(np.float32)
    sx = np.float32(0.021) if static else None
    jwq, jsw = jquant.quantize_weight(jnp.asarray(w))
    want = jquant.int8_conv(jnp.asarray(x), jwq, jsw, jnp.asarray(b), s, pad, g,
                            None if sx is None else jnp.asarray(sx))
    twq = torch.from_numpy(np.asarray(jwq).transpose(3, 2, 0, 1).copy())
    xt = _nchw(x).contiguous(memory_format=torch.channels_last)
    got = tquant.int8_conv(xt, twq, torch.from_numpy(np.array(jsw)), torch.from_numpy(b),
                           s, pad, g, None if sx is None else torch.tensor(sx))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


def test_quantize_x50_matches_jax():
    """x50-csp (ResXCSP blocks, 32-group 3 x 3 convs; width 0.5, the
    narrowest at which every group holds a channel) fused and quantized by
    both packages from the same weights: the same leaves, wq equal, sw and
    b within 1e-7; then the full int8 forward (dynamic scales), each
    package's head inputs against its own fp32 forward, and the port's
    against JAX's within 1.5x JAX's own int8-to-fp32 distance (as
    tests/test_torch_port_int8.py holds yolov7's)."""
    jplan, params, state, tplan, tp, ts = port_drawn_model(
        zoo_cfg("x50-csp", "baseline", 0.5), seed=3, stats_seed=4)
    jp, js = jreparam.fuse_model(jplan, _jax(params), _jax(state))
    fp, fs = treparam.fuse_model(tplan, tp, ts)
    assert_trees_close(fp, jp, 1e-6, "fused")
    jq, jqs = jquant.quantize_model(jplan, jp, js)
    want = from_jax_params(tplan, to_numpy(jq), to_numpy(jqs))[0]
    got, gots = tquant.quantize_model(tplan, *from_jax_params(tplan, to_numpy(jp), to_numpy(js)))
    flat_w, flat_g = _flat(want), _flat(got)
    assert flat_w.keys() == flat_g.keys()
    # the 32-group 3 x 3s: OIHW (O, O / 32, 3, 3)
    grouped = [k for k, v in flat_g.items() if k.endswith("/wq") and v.shape[1] * 32 == v.shape[0]]
    assert len(grouped) == 24, grouped
    for key, t in flat_g.items():
        if key.endswith("/wq"):
            assert torch.equal(t, flat_w[key]), key
        else:
            np.testing.assert_allclose(t.numpy(), flat_w[key].numpy(), rtol=1e-7, err_msg=key)
    x = np.random.default_rng(8).uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    jfp, _ = japply(jplan, jp, js, jnp.asarray(x), return_head_inputs=True)
    jint8, _ = japply(jplan, jq, jqs, jnp.asarray(x), return_head_inputs=True)
    with torch.inference_mode():
        tint8, _ = apply_model(tplan, got, gots, torch.from_numpy(x), return_head_inputs=True)
    to_t = lambda fs: [torch.from_numpy(np.array(f)) for f in fs]  # noqa: E731
    err, int8_err = feature_error(tint8, to_t(jint8)), feature_error(to_t(jint8), to_t(jfp))
    assert all(torch.isfinite(t).all() for t in tint8)
    assert 0 < int8_err < 0.5 and err <= 1.5 * int8_err, (err, int8_err)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}[{i}]").items()}
    return {prefix: tree}


def test_quantize_repeated_rows_match_jax():
    """yolov3's n_seq rows (`[-1, 8, bottleneck]`): `calibrate` finds each
    repeat's conv inputs under the paths "l{i}.{r}/cv1" as JAX's does,
    with the same scales (to 1e-4: the fp32 forwards differ in summation
    order), and `quantize_model` quantizes every repeat as JAX's does."""
    jplan, params, state, tplan, tp, ts = port_drawn_model(
        zoo_cfg("yolov3", "baseline", 0.125), seed=5, stats_seed=6)
    jp, js = jreparam.fuse_model(jplan, _jax(params), _jax(state))
    fp, fs = from_jax_params(tplan, to_numpy(jp), to_numpy(js))
    cal = [np.random.default_rng(9).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)]
    want = jquant.calibrate(jplan, jp, js, cal)
    got = tquant.calibrate(tplan, fp, fs, cal)
    assert got.keys() == want.keys() and {"l8.0/cv1", "l8.7/cv2"} <= got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    jq, _ = jquant.quantize_model(jplan, jp, js, want)
    wq = _flat(from_jax_params(tplan, to_numpy(jq), to_numpy(js))[0])
    tq = _flat(tquant.quantize_model(tplan, fp, fs, want)[0])
    assert tq.keys() == wq.keys() and "/layers[8][7]/cv2/wq" in tq
    for key, t in tq.items():
        if key.endswith("/wq"):
            assert torch.equal(t, wq[key]), key
        else:
            np.testing.assert_allclose(t.numpy(), wq[key].numpy(), rtol=1e-7, err_msg=key)
