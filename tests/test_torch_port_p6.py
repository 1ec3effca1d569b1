"""The YOLOv7 P6 family (w6, e6, d6, e6e) in the port against the JAX
package on the CPU: every new cfg compiles to JAX's plan; ReOrg, Shortcut
and DownC (train mode, its tiled pool on tied inputs) block by block; the
eval predictions and the training raw maps (lead + aux, 2 x nl) of the
four models; `fuse_model`; `fused_head_nms` on a 4-level head; the w6
deploy `ServingEngine` end to end. Same numpy weights and inputs on both
sides, fp32, width 0.125 (0.5 for the engine, whose ELAN spans need
32-channel multiples), 128 px, batch 2."""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import feature_error, image_rows, liven, match_fraction
from tests._torch_port_util import (P6_MODELS, assert_trees_close, port_drawn_model,
                                    zoo_cfg)
from yolo_series_tpu.models import layers as JL
from yolo_series_tpu.models import reparam as jreparam
from yolo_series_tpu.models.graph import compile_graph as jcompile
from yolo_series_tpu.models.layers import Ctx as JCtx
from yolo_series_tpu.models.model import _run_layer as jrun_layer
from yolo_series_tpu.models.model import apply_model as japply
from yolo_series_tpu.ops import nms as jnms
from yolo_series_tpu_torch.infer.serving import ServingEngine
from yolo_series_tpu_torch.models import heads as TH
from yolo_series_tpu_torch.models import layers as TL
from yolo_series_tpu_torch.models import reparam as treparam
from yolo_series_tpu_torch.models.convert import to_jax_params, to_jax_tree
from yolo_series_tpu_torch.models.graph import compile_graph
from yolo_series_tpu_torch.models.model import _run_layer, apply_model
from yolo_series_tpu_torch.models.model import tree_leaves as leaves
from yolo_series_tpu_torch.models.model import tree_rebuild as rebuild
from yolo_series_tpu_torch.ops import fused_elan
from yolo_series_tpu_torch.ops import nms as tnms

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WIDTH, SIZE = 0.125, 128
# every cfg the port copies in this slice: the P6 family, the fork's
# 83-class w6, and yolov7x / yolov7-custom (no module the port lacked)
NEW_CFGS = ([f"{k}/{m}" for k in ("training", "deploy") for m in P6_MODELS]
            + ["training/yolov7-w6-custom", "training/yolov7x", "deploy/yolov7x",
               "training/yolov7-custom"])


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _images(seed, size=SIZE):
    return np.random.default_rng(seed).uniform(0, 1, (2, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("cfg", NEW_CFGS)
def test_cfg_compiles_like_jax(cfg):
    """The port's copy of the cfg is the JAX package's, byte for byte, and
    compiles to the same plan: each layer's block (type and config),
    routes, widths, strides and repeats, the save list, and the head's nc,
    input widths, lead strides and normalized anchors."""
    port = ROOT / "yolo_series_tpu_torch/models/cfg" / f"{cfg}.yaml"
    ref = ROOT / "yolo_series_tpu/models/cfg" / f"{cfg}.yaml"
    assert port.read_bytes() == ref.read_bytes()
    jp, tp = jcompile(str(ref)), compile_graph(str(port))
    assert len(jp.layers) == len(tp.layers) and jp.save == tp.save and jp.nc == tp.nc
    for a, b in zip(jp.layers, tp.layers):
        assert (a.index, a.frm, a.cout, a.stride, a.n_seq, a.is_head) == \
            (b.index, b.frm, b.cout, b.stride, b.n_seq, b.is_head), a.index
        assert repr(a.block) == repr(b.block), a.index
    if "6" in cfg:
        assert tp.strides == (8.0, 16.0, 32.0, 64.0)
        head = TH.IAuxDetect if cfg.startswith("training") else TH.Detect
        assert type(tp.head) is head and len(tp.head.ch) == (8 if head is TH.IAuxDetect else 4)


def test_reorg_and_shortcut_match_jax():
    """ReOrg (space to depth in the reference's channel order) and Shortcut
    on the same input: equal."""
    x = np.random.default_rng(0).normal(0, 1, (2, 8, 6, 5)).astype(np.float32)
    want, _ = JL.ReOrg(5).apply({}, {}, jnp.asarray(x), JCtx())
    got, _ = TL.ReOrg(5).apply({}, {}, _nchw(x), TL.Ctx())
    assert TL.ReOrg(5).cout == 20 and TL.ReOrg(5).stride_factor == 2.0
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))
    want, _ = JL.Shortcut((5, 5)).apply({}, {}, [jnp.asarray(x), jnp.asarray(2 * x)], JCtx())
    got, _ = TL.Shortcut((5, 5)).apply({}, {}, [_nchw(x), _nchw(2 * x)], TL.Ctx())
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


def test_downc_train_mode_matches_jax_on_tied_inputs():
    """DownC in training (BN with batch moments, the new BN state) on an
    input of constant 2 x 2 blocks, where every window of its max pool
    ties: the output, the new state, and the grads of every param and of
    the input of a random projection, each within 1e-5 of its largest
    value. torch's max_pool2d would route each tie's gradient to one input;
    `MaxPoolTiled` splits it equally, as the JAX package does."""
    rng = np.random.default_rng(1)
    x = np.repeat(np.repeat(rng.normal(0, 1, (2, 4, 4, 16)), 2, 1), 2, 2).astype(np.float32)
    tblock = TL.DownC(16, 32)
    tp, ts = tblock.init(torch.Generator().manual_seed(0))
    for c in ("cv1", "cv2", "cv3"):
        ts[c]["bn"]["mean"].normal_(0, 0.2)
        ts[c]["bn"]["var"].uniform_(0.5, 1.5)
    params, state = to_jax_tree(tp), to_jax_tree(ts)
    proj = rng.normal(0, 1, (2, 4, 4, 32)).astype(np.float32)
    jblock = JL.DownC(16, 32)

    def jf(p, xx):
        y, s = jblock.apply(p, _jax(state), xx, JCtx(training=True))
        return jnp.sum(y * proj), (y, s)

    (_, (want, want_s)), (gp, gx) = jax.value_and_grad(jf, (0, 1), has_aux=True)(
        _jax(params), jnp.asarray(x))
    ps = [t.clone().requires_grad_() for t in leaves(tp)]
    xt = _nchw(x).requires_grad_()
    got, got_s = tblock.apply(rebuild(tp, ps), ts, xt, TL.Ctx(training=True))
    grads = torch.autograd.grad((got * _nchw(proj)).sum(), ps + [xt])
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(want)).max())
    assert_trees_close({"layers": [got_s]}, {"layers": [want_s]}, 1e-5, "DownC state")
    assert_trees_close({"layers": [rebuild(tp, list(grads[:-1]))]}, {"layers": [gp]}, 1e-5,
                       "DownC param grads")
    np.testing.assert_allclose(_nhwc(grads[-1]), np.asarray(gx), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(gx)).max())


@pytest.fixture(scope="module", params=P6_MODELS)
def p6(request):
    """A P6 training form at width 0.125, weights drawn by the port, BN
    running stats off (0, 1), with the JAX side's trees."""
    return (request.param,) + port_drawn_model(zoo_cfg(request.param, width=WIDTH),
                                               seed=0, stats_seed=1)


# The eval forward (running stats, no batch moments) carries fp32 rounding
# only: the lead raws and the decoded predictions within EVAL_REL of each
# tensor's largest |value| (2.2e-7 measured). In training every BN
# renormalizes with the batch's moments, over 2 x 2 x 2 values a channel at
# the 64-stride level at 128 px, and a random network's BN amplifies the
# two libraries' fp32 rounding as it goes: the training raws lie 2.5e-5
# (w6), 3.5e-4 (e6), 6.1e-4 (e6e) and 8.4e-3 (d6, 167 layers) of each map's
# largest |value| from JAX's, while each layer fed the same input agrees to
# 1.4e-6 (`test_d6_train_layers_match_jax`). So the training raws within
# TRAIN_REL, and the new BN state (3 % of the batch's moments, carried
# through the same layers: 1.8e-4 at d6) within STATE_REL relative of each
# leaf's largest value.
EVAL_REL, TRAIN_REL, STATE_REL, LAYER_REL = 1e-5, 2e-2, 1e-3, 1e-5


def test_p6_forward_matches_jax(p6):
    name, jplan, params, state, tplan, tp, ts = p6
    x = _images(0)
    for training in (False, True):
        fn = jax.jit(lambda p, s, xx, t=training: japply(jplan, p, s, xx, training=t))
        want, want_s = fn(_jax(params), _jax(state), jnp.asarray(x))
        got, got_s = apply_model(tplan, tp, ts, torch.from_numpy(x), training=training)
        nl = 4
        assert len(got["raw"]) == len(want["raw"]) == (2 * nl if training else nl)
        rel = TRAIN_REL if training else EVAL_REL
        for g, w in zip(got["raw"], want["raw"]):
            w = np.asarray(w)
            assert g.shape == w.shape
            np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                       atol=rel * np.abs(w).max())
        if training:
            assert set(got) == {"raw"}
            assert_trees_close(got_s, want_s, STATE_REL, f"{name} BN state")
        else:
            w = np.asarray(want["pred"])
            assert got["pred"].shape == w.shape == (2, 3 * (16 ** 2 + 8 ** 2 + 4 ** 2 + 2 ** 2),
                                                    85)
            np.testing.assert_allclose(got["pred"].numpy(), w, rtol=0,
                                       atol=EVAL_REL * np.abs(w).max())


def test_d6_train_layers_match_jax():
    """yolov7-d6 in training, layer by layer: each layer (its DownC, ReOrg,
    SPPCSPC, ELAN convs and concats) fed JAX's output of the layer before
    gives JAX's output within LAYER_REL of its largest |value| (1.4e-6
    measured): the end-to-end gap of `test_p6_forward_matches_jax` is BN's
    amplification, not a layer that computes something else."""
    jplan, params, state, tplan, tp, ts = port_drawn_model(
        zoo_cfg("yolov7-d6", width=WIDTH), seed=0, stats_seed=1)
    jp, js = _jax(params)["layers"], _jax(state)["layers"]
    jctx, tctx = JCtx(training=True), TL.Ctx(training=True)
    y, saved = jnp.asarray(_images(0)), {}
    for idx, spec in enumerate(jplan.layers):
        if spec.is_head:
            break
        inp = ([y if j == -1 else saved[j] for j in spec.frm] if isinstance(spec.frm, tuple)
               else y if spec.frm == -1 else saved[spec.frm])
        want, _ = jrun_layer(jctx, spec, jp[idx], js[idx], inp, None, idx)
        tin = [_nchw(a) for a in inp] if isinstance(inp, list) else _nchw(inp)
        got, _ = _run_layer(tctx, tplan.layers[idx], tp["layers"][idx], ts["layers"][idx],
                            tin, idx)
        w = np.asarray(want)
        np.testing.assert_allclose(_nhwc(got), w, rtol=0, atol=LAYER_REL * np.abs(w).max(),
                                   err_msg=f"layer {idx} {type(spec.block).__name__}")
        y = want
        if idx in jplan.save:
            saved[idx] = y


@pytest.mark.parametrize("name", ["yolov7-w6", "yolov7-e6e"])
def test_fuse_model_exact(name):
    """`fuse_model` of a P6 training form (DownC's children fused, the lead
    convs absorbing ia / im, the aux convs `m2` kept as they are): the same
    plan, the fused forward within 1e-5 of the unfused one (raws and preds,
    of each tensor's largest |value|), and the fused trees within 1e-6 of
    JAX's `fuse_model` of the same weights."""
    jplan, params, state, tplan, tp, ts = port_drawn_model(
        zoo_cfg(name, width=WIDTH), seed=2, stats_seed=3)
    fp, fs = treparam.fuse_model(tplan, tp, ts)
    head = fp["layers"][-1]
    assert set(head) == {"m", "m2"}
    for a, b in zip(leaves(head["m2"]), leaves(tp["layers"][-1]["m2"])):
        assert torch.equal(a, b)
    downc = [i for i, s in enumerate(tplan.layers) if isinstance(s.block, TL.DownC)]
    assert bool(downc) == (name == "yolov7-e6e")   # w6 downsamples by conv
    assert all(set(fp["layers"][i][c]) == {"w", "b"} for i in downc for c in ("cv1", "cv2", "cv3"))
    x = torch.from_numpy(_images(1))
    want, _ = apply_model(tplan, tp, ts, x)
    got, _ = apply_model(tplan, fp, fs, x)
    for g, w in zip(got["raw"] + [got["pred"]], want["raw"] + [want["pred"]]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * w.abs().max().item())
    jfp, jfs = jreparam.fuse_model(jplan, _jax(params), _jax(state))
    assert_trees_close(fp, jfp, 1e-6, "fused params")
    assert_trees_close(fs, jfs, 1e-6, "fused state")


@pytest.mark.parametrize("const", [False, True])
def test_fused_head_nms_four_levels_matches_jax(const):
    """`fused_head_nms` on a 4-level Detect (w6 deploy at width 0.125, 128
    px: 3 x (16^2 + 8^2 + 4^2 + 2^2) = 1020 anchors an image) against
    JAX's on the same features: counts and classes equal, boxes and scores
    within 1e-5. const: every cell of a level equal, so its anchors tie."""
    jplan, _, _, tplan, tp, ts = port_drawn_model(zoo_cfg("yolov7-w6", "deploy", WIDTH), seed=4)
    for m in tp["layers"][-1]["m"]:   # as `liven` does: candidates pass conf 0.25
        m["w"].mul_(20.0)
        m["b"].view(3, 85)[:, 4:] = 0.0
    params, _ = to_jax_params(tplan, tp, ts)
    rng = np.random.default_rng(5)
    feats = []
    for c, s in zip(tplan.head.ch, tplan.head.strides):
        f = rng.normal(0, 1.0, (2, SIZE // int(s), SIZE // int(s), c)).astype(np.float32)
        if const:
            f[:] = f[:, :1, :1]
        feats.append(f)
    kw = dict(conf_thres=0.25, iou_thres=0.45, max_det=300, max_nms=256)
    want = jnms.fused_head_nms(jplan.head, _jax(params)["layers"][-1],
                               [jnp.asarray(f) for f in feats], compute_dtype=jnp.float32, **kw)
    got = tnms.fused_head_nms(tplan.head, tp["layers"][-1], [torch.from_numpy(f) for f in feats],
                              compute_dtype=torch.float32, **kw)
    np.testing.assert_array_equal(got.num_dets.numpy(), np.asarray(want[0]))
    assert np.asarray(want[0]).max() > 5
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want[1]), rtol=1e-5,
                               atol=1e-5 * SIZE)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-5)


# the w6 deploy graph's ELAN spans: 5 in the backbone (chains 64..512 at
# full width), 6 in the head (chains 64..256)
W6_SPANS = 11


def test_w6_serving_engine_matches_jax(monkeypatch):
    """The w6 deploy `ServingEngine` at width 0.5, 128 px, batch 2, fp32,
    against the JAX engine with its Pallas kernels in interpret mode, on
    the same livened weights. The fused stem does not match the ReOrg stem
    (neither package's); the fast stem folds the (k3/s1, k3/s2) pair after
    the ReOrg into phase space, and every one of the 11 ELAN spans is
    fused, in both packages alike. As in the yolov7 engine's test, the
    kernels round to bf16 at each stage in another order than the JAX
    kernels: head inputs within 3% relative RMS, and each image's
    detections matched (same class, IoU >= 0.5, score within 0.1) at
    least 90% both ways."""
    monkeypatch.setenv("YOLO_TPU_PALLAS_STEM", "1")
    monkeypatch.setenv("YOLO_TPU_PALLAS_ELAN", "1")
    monkeypatch.setenv("YOLO_TPU_PALLAS_INTERPRET", "1")
    from yolo_series_tpu.infer.serving import ServingEngine as JaxEngine

    cfg = zoo_cfg("yolov7-w6", "deploy", 0.5)
    _, _, _, tplan, tp, ts = port_drawn_model(cfg, seed=6)
    calib = np.random.default_rng(6).integers(0, 256, (2, SIZE, SIZE, 3)) / 255.0
    liven(tplan, tp, ts, torch.from_numpy(calib).float(), candidates=60)
    params, state = to_jax_params(tplan, tp, ts)
    jplan = jcompile(cfg)
    jp, js = jreparam.fuse_model(jplan, _jax(params), _jax(state))
    fp, fs = treparam.fuse_model(tplan, tp, ts)
    assert len(fused_elan.find_elan_spans(tplan, fp)) == W6_SPANS
    kw = dict(batch_size=2, img_size=SIZE, max_det=100, max_nms=512)
    jeng = JaxEngine(jplan, jp, js, dtype=jnp.float32, **kw)
    teng = ServingEngine(tplan, fp, fs, dtype=torch.float32, device="cpu", **kw)
    names = [type(layer.block).__name__ for layer in teng.plan.layers]
    assert names[:3] == ["ReOrg", "PhasedConv", "PhasedConv"]
    assert names.count("FusedStem") == 0 and names.count("FusedELAN") == W6_SPANS
    assert [type(la.block).__name__ for la in jeng.plan.layers] == names
    x = np.random.default_rng(7).integers(0, 255, (2, SIZE, SIZE, 3), np.uint8)
    want, got = jeng.infer(x), teng.infer(x)
    xf = x.astype(np.float32) / 255.0
    jfeats, _ = japply(jeng.plan, jeng._params, jeng._state, jnp.asarray(xf),
                       return_head_inputs=True)
    with torch.inference_mode():
        tfeats, _ = apply_model(teng.plan, teng._params, teng._state, torch.from_numpy(xf),
                                return_head_inputs=True)
    assert len(tfeats) == 4
    assert feature_error(tfeats, [torch.from_numpy(np.array(f)) for f in jfeats]) < 0.03
    for i in range(2):
        a, b = image_rows(got, i), image_rows(want, i)
        assert len(b["scores"]) > 5
        assert match_fraction(a, b) >= 0.9 and match_fraction(b, a) >= 0.9


def test_iauxdetect_raw_layout():
    """IAuxDetect in training returns the lead maps, then the aux maps, each
    (B, na, ny, nx, no); in inference the lead maps and their decode only.
    The aux convs get the bias prior too."""
    head = TH.IAuxDetect(nc=2, anchors=((1, 2, 3, 4, 5, 6),) * 2, ch=(16, 16, 8, 8),
                         strides=(8.0, 16.0))
    p, _ = head.init(torch.Generator().manual_seed(0))
    assert len(p["m"]) == len(p["m2"]) == len(p["ia"]) == len(p["im"]) == 2
    assert p["m2"][0]["w"].shape == (21, 8, 1, 1)
    pb = head.init_biases(p)
    assert not torch.equal(pb["m2"][1]["b"], p["m2"][1]["b"])
    xs = [torch.randn(1, c, 32 // int(s), 32 // int(s))
          for c, s in zip(head.ch, (8.0, 16.0, 8.0, 16.0))]
    out, _ = head.apply(p, {}, xs, TL.Ctx(training=True))
    assert [tuple(r.shape) for r in out["raw"]] == [(1, 3, 4, 4, 7), (1, 3, 2, 2, 7)] * 2
    y = torch.nn.functional.conv2d(xs[2], p["m2"][0]["w"], p["m2"][0]["b"])
    torch.testing.assert_close(out["raw"][2], y.reshape(1, 3, 7, 4, 4).permute(0, 1, 3, 4, 2))
    out, _ = head.apply(p, {}, xs, TL.Ctx())
    assert len(out["raw"]) == 2 and out["pred"].shape == (1, 3 * (16 + 4), 7)
    assert dataclasses.is_dataclass(head)
