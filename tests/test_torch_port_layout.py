"""The layout passes in the port against the JAX package on the CPU:
`models/fastconcat.make_split_concat`, `models/lanealign.make_lane_align`
and the training half of `models/faststem` (`TrainPhasedConvA/B`,
`TrainReorgConv`, `make_train_fast_stem`). For each: the port's plan
transform against JAX's block for block, the transformed forward against
JAX's transformed forward (inference, and training: raw maps, new BN
state, param grads), the transformed against the untransformed plan, and
the patterns each pass declines. The fault of JAX's TrainPhasedConvA (BN
moments over the whole batch whatever `bn_shards` says) is shown, with the
port's fold equal to its unfolded step at bn_shards 2. Same numpy weights
and inputs on both sides, fp32, small widths, 32-128 px."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_util import assert_trees_close, port_drawn_model, to_numpy, zoo_cfg
from yolo_series_tpu.models import faststem as jfs
from yolo_series_tpu.models import layers as JL
from yolo_series_tpu.models.fastconcat import make_split_concat as jsplit
from yolo_series_tpu.models.graph import compile_graph as jcompile
from yolo_series_tpu.models.lanealign import make_lane_align as jlane
from yolo_series_tpu.models.model import apply_model as japply
from yolo_series_tpu_torch.models import faststem as tfs
from yolo_series_tpu_torch.models import layers as TL
from yolo_series_tpu_torch.models.convert import from_jax_tree, to_jax_tree
from yolo_series_tpu_torch.models.fastconcat import SplitConcatConv, make_split_concat
from yolo_series_tpu_torch.models.graph import compile_graph
from yolo_series_tpu_torch.models.lanealign import LaneAlignedConv, make_lane_align
from yolo_series_tpu_torch.models.model import apply_model, init_model
from yolo_series_tpu_torch.models.model import tree_leaves as leaves
from yolo_series_tpu_torch.models.model import tree_rebuild as rebuild

torch.set_num_threads(2)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _fields(block):
    """A block's dataclass fields, nested blocks by their own fields, so two
    packages' blocks compare by value."""
    out = {"type": type(block).__name__}
    for f in dataclasses.fields(block):
        v = getattr(block, f.name)
        out[f.name] = _fields(v) if dataclasses.is_dataclass(v) else v
    return out


def _same_plan(tplan, jplan):
    """The two plans agree layer by layer: block type and fields, routing,
    width, stride, and the save list."""
    assert len(tplan.layers) == len(jplan.layers)
    for t, j in zip(tplan.layers, jplan.layers):
        assert (t.frm, t.cout, t.stride, t.n_seq) == (j.frm, j.cout, j.stride, j.n_seq), t.index
        if not t.is_head:
            assert _fields(t.block) == _fields(j.block), t.index
    assert tuple(tplan.save) == tuple(jplan.save)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _raw_close(got, want, rel):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=rel * np.abs(w).max())


def _proj_loss_grads(tplan, tp, ts, jplan, params, state, x, seed):
    """The grads of every param of a random projection of the training raw
    maps, port and JAX: (port grads tree, JAX grads tree)."""
    out, _ = japply(jplan, _jax(params), _jax(state), jnp.asarray(x), training=True)
    rng = np.random.default_rng(seed)
    proj = [rng.normal(0, 1, r.shape).astype(np.float32) for r in out["raw"]]

    def jloss(p):
        o, _ = japply(jplan, p, _jax(state), jnp.asarray(x), training=True)
        return sum(jnp.sum(r * jnp.asarray(c)) for r, c in zip(o["raw"], proj))

    want = jax.jit(jax.grad(jloss))(_jax(params))
    ps = [t.detach().requires_grad_() for t in leaves(tp)]
    o, _ = apply_model(tplan, rebuild(tp, ps), ts, torch.from_numpy(x), training=True)
    loss = sum((r * torch.from_numpy(c)).sum() for r, c in zip(o["raw"], proj))
    return rebuild(tp, list(torch.autograd.grad(loss, ps))), want


# ------------------------------------------------------------ split_concat ---

@pytest.fixture(scope="module")
def tiny():
    """yolov7-tiny training at width 0.25, BN running stats off (0, 1), and
    two 64 px images."""
    jplan, params, state, tplan, tp, ts = port_drawn_model(
        zoo_cfg("yolov7-tiny", "training", 0.25), seed=2, stats_seed=3)
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    return jplan, params, state, tplan, tp, ts, x


def test_split_concat_matches_jax(tiny):
    """The rewritten plan equals JAX's block for block; its inference pred
    equals JAX's rewritten pred (1e-5 of the largest |value|) and the
    port's unrewritten pred (1e-5); in training its raw maps (2e-4 of each
    map's largest), new BN state (1e-5) and param grads (2e-3 of each
    leaf's largest) match JAX's rewritten step, the tolerances of
    tests/test_torch_port_train_model.py."""
    jplan, params, state, tplan, tp, ts, x = tiny
    t2, j2 = make_split_concat(tplan), jsplit(jplan)
    n = sum(isinstance(s.block, SplitConcatConv) for s in t2.layers)
    assert n > 5
    _same_plan(t2, j2)
    with torch.no_grad():
        got, _ = apply_model(t2, tp, ts, torch.from_numpy(x))
        plain, _ = apply_model(tplan, tp, ts, torch.from_numpy(x))
    want, _ = japply(j2, _jax(params), _jax(state), jnp.asarray(x))
    w = np.asarray(want["pred"])
    np.testing.assert_allclose(got["pred"].numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
    np.testing.assert_allclose(got["pred"].numpy(), plain["pred"].numpy(), rtol=0,
                               atol=1e-5 * np.abs(w).max())
    got, got_state = apply_model(t2, tp, ts, torch.from_numpy(x), training=True)
    want, want_state = japply(j2, _jax(params), _jax(state), jnp.asarray(x), training=True)
    _raw_close(got["raw"], want["raw"], 2e-4)
    assert_trees_close(got_state, want_state, 1e-5, "BN state")
    g, w = _proj_loss_grads(t2, tp, ts, j2, params, state, x, 4)
    assert_trees_close(g, w, 2e-3, "param grads")


SPLIT_CFG = {"nc": 2, "anchors": [[10, 13, 16, 30, 33, 23]],
             "head": [[[-1], 1, "idetect", ["nc", "anchors"]]]}


@pytest.mark.parametrize("case", ["three_by_three", "multi_consumer"])
def test_split_concat_patterns(case):
    """A concat read by a 3x3 conv is left alone; two 1x1 readers of one
    concat (the FPN merge) are both rewritten, as in JAX
    (tests/test_fastconcat.py), and the rewritten forward equals the plain
    one in inference and training (1e-5)."""
    rows = [[-1, 1, "conv", [8, 3, 2]], [-1, 1, "conv", [8, 3, 1]],
            [[-1, -2], 1, "concat", [1]]]
    if case == "three_by_three":
        rows += [[-1, 1, "conv", [16, 3, 1]]]
    else:
        rows += [[-1, 1, "conv", [16, 1, 1]], [-2, 1, "conv", [8, 1, 1]],
                 [[-1, -2], 1, "concat", [1]], [-1, 1, "conv", [16, 1, 1]]]
    cfg = {**SPLIT_CFG, "backbone": rows}
    tplan, jplan = compile_graph(cfg), jcompile(cfg)
    t2, j2 = make_split_concat(tplan), jsplit(jplan)
    if case == "three_by_three":
        assert t2 is tplan and j2 is jplan
        return
    assert sum(isinstance(s.block, SplitConcatConv) for s in t2.layers) == 3
    _same_plan(t2, j2)
    tp, ts = init_model(tplan, torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32))
    for training in (False, True):
        a, sa = apply_model(tplan, tp, ts, x, training=training)
        b, sb = apply_model(t2, tp, ts, x, training=training)
        for ra, rb in zip(a["raw"], b["raw"]):
            torch.testing.assert_close(rb, ra, rtol=1e-5, atol=1e-5)
        for la, lb in zip(leaves(sa), leaves(sb)):
            torch.testing.assert_close(lb, la, rtol=1e-5, atol=1e-6)


# -------------------------------------------------------------- lane_align ---

def test_lane_align_w6_matches_jax():
    """yolov7-w6 training at width 0.25 (taps of 16-96 channels): the
    rewritten plan equals JAX's block for block, every padded concat's
    boundaries sit on multiples of 128, the param and state trees are unchanged, and the
    inference pred equals JAX's rewritten pred and the port's plain pred
    (1e-5 of the largest |value|) at 128 px."""
    jplan, params, state, tplan, tp, ts = port_drawn_model(
        zoo_cfg("yolov7-w6", "training", 0.25), seed=5, stats_seed=6)
    t2, j2 = make_lane_align(tplan), jlane(jplan)
    assert sum(isinstance(s.block, LaneAlignedConv) for s in t2.layers) > 20
    _same_plan(t2, j2)
    padded = [s for s, s0 in zip(t2.layers, tplan.layers)
              if isinstance(s.block, TL.Concat) and s.block != s0.block]
    assert len(padded) > 5
    for s in padded:
        assert all(b % 128 == 0 for b in np.cumsum(s.block.cins)), s.index
    x = np.random.default_rng(0).uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)
    with torch.no_grad():
        got, _ = apply_model(t2, tp, ts, torch.from_numpy(x))
        plain, _ = apply_model(tplan, tp, ts, torch.from_numpy(x))
    want, _ = japply(j2, _jax(params), _jax(state), jnp.asarray(x))
    w = np.asarray(want["pred"])
    np.testing.assert_allclose(got["pred"].numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
    np.testing.assert_allclose(got["pred"].numpy(), plain["pred"].numpy(), rtol=0,
                               atol=1e-5 * np.abs(w).max())
    p0, _ = init_model(t2, torch.Generator().manual_seed(0))
    assert [t.shape for t in leaves(p0)] == [t.shape for t in leaves(tp)]


LANE_CFG = {"nc": 2, "anchors": [[10, 13, 16, 30, 33, 23]],
            "backbone": [[-1, 1, "conv", [48, 3, 2]], [-1, 1, "conv", [48, 1, 1]],
                         [-2, 1, "conv", [48, 1, 1]], [-1, 1, "conv", [48, 3, 1]],
                         [[-1, -2, -3], 1, "concat", [1]], [-1, 1, "conv", [64, 1, 1]]],
            "head": [[[-1], 1, "idetect", ["nc", "anchors"]]]}


def test_lane_align_train_matches_jax():
    """The shallow unaligned ELAN of tests/test_lanealign.py: rewritten as
    JAX rewrites it; in training the raw maps, new BN state (running stats
    computed padded and sliced back) and param grads equal JAX's rewritten
    step and the port's plain step (1e-5)."""
    jplan, params, state, tplan, tp, ts = port_drawn_model(LANE_CFG, seed=7, stats_seed=8)
    t2, j2 = make_lane_align(tplan), jlane(jplan)
    assert sum(isinstance(s.block, LaneAlignedConv) for s in t2.layers) >= 4
    _same_plan(t2, j2)
    x = np.random.default_rng(1).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    got, got_state = apply_model(t2, tp, ts, torch.from_numpy(x), training=True)
    plain, plain_state = apply_model(tplan, tp, ts, torch.from_numpy(x), training=True)
    want, want_state = japply(j2, _jax(params), _jax(state), jnp.asarray(x), training=True)
    _raw_close(got["raw"], want["raw"], 1e-5)
    _raw_close(got["raw"], [r.detach().numpy() for r in plain["raw"]], 1e-5)
    assert_trees_close(got_state, want_state, 1e-5, "BN state")
    assert_trees_close(got_state, to_numpy(to_jax_tree(plain_state)), 1e-5, "BN state")
    g, w = _proj_loss_grads(t2, tp, ts, j2, params, state, x, 9)
    assert_trees_close(g, w, 1e-5, "param grads")
    g0, _ = _proj_loss_grads(tplan, tp, ts, jplan, params, state, x, 9)
    assert_trees_close(g, to_numpy(to_jax_tree(g0)), 1e-5, "grads against the plain plan")


@pytest.mark.parametrize("case", ["aligned", "pool_reader"])
def test_lane_align_declines(case):
    """An aligned concat (128 + 128) and an unaligned one read by a max
    pool are left alone, in both packages."""
    c = 128 if case == "aligned" else 48
    rows = [[-1, 1, "conv", [c, 3, 2]], [-1, 1, "conv", [c, 3, 1]],
            [[-1, -2], 1, "concat", [1]]]
    rows += ([[-1, 1, "conv", [64, 1, 1]]] if case == "aligned"
             else [[-1, 1, "mp", []], [-1, 1, "conv", [64, 1, 1]]])
    cfg = {**LANE_CFG, "backbone": rows}
    tplan, jplan = compile_graph(cfg), jcompile(cfg)
    assert make_lane_align(tplan) is tplan and jlane(jplan) is jplan


# ---------------------------------------------------------- train fast stem ---

def _bn_params(rng, c):
    return ({"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
             "bias": rng.normal(0, 0.1, c).astype(np.float32)},
            {"mean": rng.normal(0.3, 0.2, c).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, c).astype(np.float32)})


def _block_pair(blocks_t, blocks_j, params, state, x, training, seed):
    """Apply a chain of port blocks and of JAX blocks to NHWC x: (port y,
    port new states, port grads, JAX y, JAX new states, JAX grads), the
    grads of a random projection of y w.r.t. every param."""
    ctx_t, ctx_j = TL.Ctx(training=training), JL.Ctx(training=training)
    tps = [from_jax_tree(p) for p in params]
    tss = [from_jax_tree(s) for s in state]
    flat = [t.requires_grad_() for p in tps for t in leaves(p)]
    y = torch.from_numpy(x).permute(0, 3, 1, 2)
    ts_new = []
    for blk, p, s in zip(blocks_t, tps, tss):
        y, s2 = blk.apply(p, s, y, ctx_t)
        ts_new.append(to_jax_tree(s2))
    proj = np.random.default_rng(seed).normal(0, 1, _nhwc(y).shape).astype(np.float32)
    loss = (y.permute(0, 2, 3, 1) * torch.from_numpy(proj)).sum()
    tg = torch.autograd.grad(loss, flat)

    def jfn(ps):
        yj, news = jnp.asarray(x), []
        for blk, p, s in zip(blocks_j, ps, state):
            yj, s2 = blk.apply(p, _jax(s), yj, ctx_j)
            news.append(s2)
        return jnp.sum(yj * jnp.asarray(proj)), (yj, news)

    (_, (yj, js_new)), jg = jax.value_and_grad(jfn, has_aux=True)([_jax(p) for p in params])
    tgt = rebuild(tps, list(tg))
    return _nhwc(y), ts_new, to_jax_tree(tgt), np.asarray(yj), to_numpy(js_new), to_numpy(jg)


def _close_tree(a, b, rel):
    for u, v in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        u, v = np.asarray(u), np.asarray(v)
        assert u.shape == v.shape
        np.testing.assert_allclose(u, v, rtol=0, atol=rel * max(np.abs(v).max(), 1e-30))


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_train_phased_pair_matches_jax_and_unfolded(training):
    """TrainPhasedConvA + TrainPhasedConvB (the (k3/s1, k3/s2) pair folded
    into phase space) against JAX's pair and the port's two ConvBnActs:
    output and new BN state within 1e-5 of each tensor's largest |value|,
    the grads of w and BN affine through a random projection within 1e-4
    (JAX's own tolerance for the fold's grads, tests/test_reparam.py:130;
    3.5e-5 measured), fp32, 3 -> 64 -> 32 channels, 32 px, running means
    off zero."""
    rng = np.random.default_rng(11)
    c0, c1 = 64, 32
    x = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    bn0, st0 = _bn_params(rng, c0)
    bn1, st1 = _bn_params(rng, c1)
    params = [{"w": rng.normal(0, 0.3, (3, 3, 3, c0)).astype(np.float32), "bn": bn0},
              {"w": rng.normal(0, 0.05, (3, 3, c0, c1)).astype(np.float32), "bn": bn1}]
    state = [{"bn": st0}, {"bn": st1}]
    fold_t = [tfs.TrainPhasedConvA(3, c0), tfs.TrainPhasedConvB(4 * c0, c1)]
    fold_j = [jfs.TrainPhasedConvA(3, c0), jfs.TrainPhasedConvB(4 * c0, c1)]
    plain_t = [TL.ConvBnAct(3, c0, 3, 1), TL.ConvBnAct(c0, c1, 3, 2)]
    y, s, g, yj, sj, gj = _block_pair(fold_t, fold_j, params, state, x, training, 12)
    _close_tree(y, yj, 1e-5)
    _close_tree(s, sj, 1e-5)
    _close_tree(g, gj, 1e-4)
    yp, sp, gp, *_ = _block_pair(plain_t, fold_j, params, state, x, training, 12)
    _close_tree(y, yp, 1e-5)
    _close_tree(s, sp, 1e-5)
    _close_tree(g, gp, 1e-4)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_train_reorg_conv_matches_jax_and_unfolded(training):
    """TrainReorgConv ([ReOrg, k3/s1 ConvBnAct] as one 6x6/s2 conv) against
    JAX's and the port's ReOrg + ConvBnAct (tests/test_reparam.py:101):
    output and new BN state within 1e-5 of each tensor's largest, grads
    within 1e-4 (JAX's tolerance there)."""
    rng = np.random.default_rng(13)
    c, c2 = 3, 16
    x = rng.normal(0, 1, (2, 32, 32, c)).astype(np.float32)
    bn, st = _bn_params(rng, c2)
    params = [{"w": rng.normal(0, 0.2, (3, 3, 4 * c, c2)).astype(np.float32), "bn": bn}]
    state = [{"bn": st}]
    y, s, g, yj, sj, gj = _block_pair([tfs.TrainReorgConv(c, c2)], [jfs.TrainReorgConv(c, c2)],
                                      params, state, x, training, 14)
    _close_tree(y, yj, 1e-5)
    _close_tree(s, sj, 1e-5)
    _close_tree(g, gj, 1e-4)
    yp, sp, gp, *_ = _block_pair([TL.ReOrg(c), TL.ConvBnAct(4 * c, c2, 3, 1)],
                                 [JL.ReOrg(c), JL.ConvBnAct(4 * c, c2, 3, 1)],
                                 [{}] + params, [{}] + state, x, training, 14)
    _close_tree(y, yp, 1e-5)
    _close_tree(s, sp[1:], 1e-5)
    _close_tree(g, gp[1:], 1e-4)


# The folded yolov7's raw maps lie 2.5e-4 - 6.6e-4 of each map's largest
# |value| from JAX's folded forward at 64 px (the unfolded plan on the same
# weights: 2.7e-5): TrainPhasedConvA takes JAX's one-pass moments about the
# running mean, whose cancellation amplifies the two backends' fp32
# rounding of the k4/s2 conv; the fold alone holds 1e-5 (the block tests).
FOLD_RAW_REL = 1e-3
# the new BN state: w6's P6 maps of 2 x 2 (1.4e-5 of a leaf's largest
# measured; yolov7 within 1e-5)
FOLD_STATE_REL = 5e-5


@pytest.mark.parametrize("name", ["yolov7", "yolov7-w6", "yolov7-tiny"])
def test_train_fast_stem_plan_and_forward(name):
    """make_train_fast_stem folds what JAX's folds (yolov7: layers 0-1 and
    2-3; w6: the ReOrg stem; tiny: nothing), block for block; the folded
    training forward's raw maps and new BN state equal JAX's folded
    forward (FOLD_RAW_REL of each map's largest, FOLD_STATE_REL) at width
    0.25, 64 px (w6 128 px)."""
    size = 128 if name == "yolov7-w6" else 64
    jplan, params, state, tplan, tp, ts = port_drawn_model(
        zoo_cfg(name, "training", 0.25), seed=15, stats_seed=16)
    t2, j2 = tfs.make_train_fast_stem(tplan), jfs.make_train_fast_stem(jplan)
    if name == "yolov7-tiny":
        assert t2 is tplan and j2 is jplan
        return
    _same_plan(t2, j2)
    kinds = [type(s.block).__name__ for s in t2.layers[:4]]
    assert kinds == (["TrainPhasedConvA", "TrainPhasedConvB"] * 2 if name == "yolov7"
                     else ["_Passthrough", "TrainReorgConv", "ConvBnAct", "ConvBnAct"])
    x = np.random.default_rng(17).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    got, got_state = apply_model(t2, tp, ts, torch.from_numpy(x), training=True)
    want, want_state = japply(j2, _jax(params), _jax(state), jnp.asarray(x), training=True)
    _raw_close(got["raw"], want["raw"], FOLD_RAW_REL)
    assert_trees_close(got_state, want_state, FOLD_STATE_REL, "BN state")


# yolov7's stem (its first four convs, which the fold takes as two pairs),
# a 1x1 and an IDetect head: the fault is in layer 0
STEM_CFG = {"nc": 2, "anchors": [[10, 13, 16, 30, 33, 23]],
            "backbone": [[-1, 1, "conv", [32, 3, 1]], [-1, 1, "conv", [64, 3, 2]],
                         [-1, 1, "conv", [64, 3, 1]], [-1, 1, "conv", [128, 3, 2]],
                         [-1, 1, "conv", [64, 1, 1]]],
            "head": [[[-1], 1, "idetect", ["nc", "anchors"]]]}


def test_fold_honours_bn_shards():
    """The JAX package's fault, and the port's repair: at bn_shards 2 the
    unfolded layer 0 normalizes each half of the batch with its own
    moments and its running stats follow half 0. The port's fold does the
    same (new mean and var within 1e-6 of the port's unfolded step, which
    is within 1e-5 of JAX's unfolded step), where JAX's fold takes the
    whole batch's moments and moves the running stats elsewhere. On
    yolov7's stem (STEM_CFG), both pairs folded."""
    jplan, params, state, tplan, tp, ts = port_drawn_model(STEM_CFG, seed=18, stats_seed=19)
    rng = np.random.default_rng(20)
    x = rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    x[2:] = x[2:] ** 3          # the halves' moments differ
    t2, j2 = tfs.make_train_fast_stem(tplan), jfs.make_train_fast_stem(jplan)
    assert [type(s.block).__name__ for s in t2.layers[:4]] == \
        ["TrainPhasedConvA", "TrainPhasedConvB"] * 2

    def layer0(st):
        return np.stack([np.asarray(st["layers"][0]["bn"][k]) for k in ("mean", "var")])

    _, s_fold = apply_model(t2, tp, ts, torch.from_numpy(x), training=True, bn_shards=2)
    _, s_plain = apply_model(tplan, tp, ts, torch.from_numpy(x), training=True, bn_shards=2)
    _, j_plain = japply(jplan, _jax(params), _jax(state), jnp.asarray(x), training=True,
                        bn_shards=2)
    _, j_fold = japply(j2, _jax(params), _jax(state), jnp.asarray(x), training=True,
                       bn_shards=2)
    fold, plain = layer0(to_jax_tree(s_fold)), layer0(to_jax_tree(s_plain))
    jp, jf = layer0(j_plain), layer0(j_fold)
    np.testing.assert_allclose(fold, plain, rtol=0, atol=1e-6 * np.abs(plain).max())
    np.testing.assert_allclose(plain, jp, rtol=0, atol=1e-5 * np.abs(jp).max())
    # JAX's fold: the whole batch's moments, off by far more than rounding
    assert np.abs(jf - jp).max() > 100 * 1e-5 * np.abs(jp).max()
    # the rest of the state agrees too (layer 1 reads layer 0's output)
    assert_trees_close(s_fold, j_plain, 1e-5, "BN state")


def _fold_rank(rank, world, init_method, cases):
    """Per case (x, params, state, gy, bn_shards): TrainPhasedConvA + B in
    training on this rank's slice of x under the group (SyncBN, or per
    replica with bn_shards > 1), and the backward from this rank's slice
    of gy: (y, new states, grads of every param)."""
    from yolo_series_tpu_torch.parallel.dist import host_local_slice, init_distributed

    group = init_distributed(rank, world, init_method, "cpu")
    out = []
    for x, params, state, gy, bn_shards in cases:
        sl = host_local_slice(x.shape[0], rank, world)
        out.append(_fold_pair(x[sl], params, state, gy[sl],
                              TL.Ctx(training=True, bn_shards=bn_shards, group=group)))
    return out


def _fold_pair(x, params, state, gy, ctx):
    blocks = [tfs.TrainPhasedConvA(3, 64), tfs.TrainPhasedConvB(256, 32)]
    tps = [from_jax_tree(p) for p in params]
    flat = [t.requires_grad_() for p in tps for t in leaves(p)]
    y = torch.from_numpy(x).permute(0, 3, 1, 2)
    news = []
    for blk, p, s in zip(blocks, tps, state):
        y, s2 = blk.apply(p, from_jax_tree(s), y, ctx)
        news.append(to_jax_tree(s2))
    grads = torch.autograd.grad(y, flat, torch.from_numpy(gy).permute(0, 3, 1, 2))
    return _nhwc(y), news, [g.numpy() for g in grads]


FOLD_SHARDS = (1, 2)


@pytest.fixture(scope="module")
def fold_runs():
    """The folded pair's inputs, and its run on 2 gloo ranks of 2 images
    each at each bn_shards of FOLD_SHARDS (one launch)."""
    from yolo_series_tpu_torch.parallel.dist import launch

    rng = np.random.default_rng(21)
    x = rng.uniform(0, 1, (4, 16, 16, 3)).astype(np.float32)
    x[2:] = x[2:] ** 2
    bn0, st0 = _bn_params(rng, 64)
    bn1, st1 = _bn_params(rng, 32)
    params = [{"w": rng.normal(0, 0.3, (3, 3, 3, 64)).astype(np.float32), "bn": bn0},
              {"w": rng.normal(0, 0.05, (3, 3, 64, 32)).astype(np.float32), "bn": bn1}]
    state = [{"bn": st0}, {"bn": st1}]
    gy = rng.normal(0, 1, (4, 8, 8, 32)).astype(np.float32)
    inputs = (x, params, state, gy)
    outs = launch(_fold_rank, 2, args=([inputs + (g,) for g in FOLD_SHARDS],), timeout=240,
                  threads=1)
    return inputs, outs


@pytest.mark.parametrize("case", range(len(FOLD_SHARDS)), ids=["sync_bn", "per_replica"])
def test_fold_two_ranks_match_one_process(fold_runs, case):
    """The folded pair on 2 gloo ranks of 2 images each against one process
    on all 4 with the same bn_shards: outputs (1e-5 of the largest), the
    new BN state (rank 0's, 1e-5), and the param grads summed over the
    ranks (1e-4; the step's all-reduce sums them): under SyncBN the
    moments' backward reaches every rank, as JAX's pmean's does."""
    (x, params, state, gy), outs = fold_runs
    ranks = [o[case] for o in outs]
    y, news, grads = _fold_pair(x, params, state, gy,
                                TL.Ctx(training=True, bn_shards=FOLD_SHARDS[case]))
    _close_tree(np.concatenate([r[0] for r in ranks]), y, 1e-5)
    _close_tree(ranks[0][1], news, 1e-5)
    _close_tree([a + b for a, b in zip(ranks[0][2], ranks[1][2])], grads, 1e-4)
