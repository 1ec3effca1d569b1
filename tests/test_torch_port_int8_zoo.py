"""int8 beyond yolov7 in the port against the JAX package on the CPU: the
long-tail cfg's int8 forward (the composites' own leaves and a deployed
RepConv_OREPA pass through `quantize_tree` unquantized), and the int8
trees of yolov7-w6 deploy (ReOrg, DownC, the four-level head) and
yolov7-tiny deploy: `calibrate`'s paths and scales, `quantize_model` full
and mixed, `pallas_1x1_eligible` conv by conv, and each int8 layer fed
JAX's int8 input. x50-csp's grouped convs and yolov3's repeats are held
in tests/test_torch_port_zoo.py. Weights drawn by the port
(`port_drawn_model`), fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import feature_error, k4_convs, recorded_k4
from tests._torch_port_util import port_drawn_model, to_numpy, zoo_cfg
from tests.test_torch_port_int8 import _conv_paths, _flat, _nchw
from tests.test_torch_port_zoo_tail_cfgs import LONG_TAIL
from yolo_series_tpu.infer import quant as jquant
from yolo_series_tpu.models import graph as jgraph
from yolo_series_tpu.models import layers as JL
from yolo_series_tpu.models import reparam as jreparam
from yolo_series_tpu.models.model import _run_layer as jrun_layer
from yolo_series_tpu_torch.infer import quant as tquant
from yolo_series_tpu_torch.models import extra as TX
from yolo_series_tpu_torch.models import graph as tgraph
from yolo_series_tpu_torch.models import layers as TL
from yolo_series_tpu_torch.models import reparam as treparam
from yolo_series_tpu_torch.models.convert import from_jax_params, to_jax_tree
from yolo_series_tpu_torch.models.model import _run_layer, apply_model

torch.set_num_threads(2)

# The long-tail plan's int8 head inputs against the port's own fp32 forward
# (relative RMS, `chip_smoke.feature_error`): a sanity limit, as
# chip_smoke.INT8_FEAT_MAX for yolov7. Per-tensor int8 inputs add ~1% RMS
# noise at each quantized conv; a wrong scale, channel or a leaf read from
# the wrong place gives ~100%. Measured 1.2e-3 (full) and 9.9e-4 (mixed).
TAIL_INT8_FEAT_MAX = 0.1
# quantized leaves: wq equal; sw, b and sx fp32 arithmetic of the same
# numbers in the same order
LEAF_RTOL = 1e-6


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _int8_nodes(tree, path=""):
    """{path: node} of every int8 conv leaf ({wq, sw, b[, sx]}) of a JAX
    layout tree."""
    if isinstance(tree, dict):
        if "wq" in tree:
            return {path: tree}
        return {k: v for key, sub in tree.items()
                for k, v in _int8_nodes(sub, f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _int8_nodes(sub, f"{path}[{i}]").items()}
    return {}


def _same_leaf(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        if k == "wq":
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=what)
        else:
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                       rtol=LEAF_RTOL, atol=0, err_msg=f"{what}/{k}")


@pytest.fixture(scope="module")
def long_tail():
    """The long-tail cfg at 4x its widths (128-256 channels), so that mixed
    int8 finds K4-eligible 1x1s (at 32-64 channels it quantizes none)."""
    cfg = {**LONG_TAIL, "width_multiple": 4.0}
    jplan, params, state, tplan, tp, ts = port_drawn_model(cfg, seed=0, stats_seed=1)
    fp, fs = treparam.fuse_model(tplan, tp, ts)
    jfp, _ = jreparam.fuse_model(jplan, _jax(params), _jax(state))
    x = np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    scales = tquant.calibrate(tplan, fp, fs, [x[:1]])
    return jplan, jfp, tplan, fp, fs, x, scales


@pytest.mark.parametrize("mixed", [False, True], ids=["full", "mixed"])
def test_long_tail_int8_forward(long_tail, mixed):
    """The fused long-tail plan quantized full and mixed: the forward runs
    (it raised KeyError 'rbr_dense' and then 'conv1x1' before the repair).
    Every leaf that JAX's `quantize_tree` quantizes equals JAX's
    quantization of the same fused leaf, layer by layer with the same
    scales; JAX's raises at the deployed RepConv_OREPA alone, and its fused
    forward of these blocks raises (ROADMAP queue 3), so the whole plan is
    held against the port's own fp32 forward. The composites' own leaves
    and the deployed RepConv_OREPA pass through as they were fused."""
    jplan, jfp, tplan, fp, fs, x, scales = long_tail
    q, qs = tquant.quantize_model(tplan, fp, fs, scales, mixed=mixed)
    got = to_jax_tree(q)
    raised, n_nodes = [], 0
    for idx, spec in enumerate(jplan.layers):
        if spec.is_head:
            continue
        try:
            want = jquant.quantize_tree(spec.block, jfp["layers"][idx], scales, f"l{idx}",
                                        mixed=mixed)
        except KeyError:
            raised.append(idx)
            continue
        nodes = _int8_nodes(to_numpy(want))
        gnodes = _int8_nodes(got["layers"][idx])
        assert nodes.keys() == gnodes.keys(), idx
        for path, node in nodes.items():
            _same_leaf(gnodes[path], node, f"l{idx}{path}")
        n_nodes += len(nodes)
    orepa = [i for i, sp in enumerate(tplan.layers) if isinstance(sp.block, TX.RepConvOREPA)]
    assert raised == orepa == [8]
    assert q["layers"][8] is fp["layers"][8]
    assert n_nodes > (3 if mixed else 20), n_nodes
    robust = q["layers"][1]
    own = set(robust) - set(tplan.layers[1].block.children())
    assert own and all(robust[k] is fp["layers"][1][k] for k in own)
    with torch.no_grad(), recorded_k4() as k4:
        want, _ = apply_model(tplan, fp, fs, torch.from_numpy(x), return_head_inputs=True)
        got8, _ = apply_model(tplan, q, qs, torch.from_numpy(x), return_head_inputs=True)
    # the K4 convs that ran are those chip_smoke.py counts from the tree
    assert len(k4) == k4_convs(tplan, q) > 0
    assert all(torch.isfinite(g).all() for g in got8)
    err = feature_error(got8, want)
    assert 0 < err <= TAIL_INT8_FEAT_MAX, err


# (cfg, width, px): the smallest input with a 2 x 2 map at the largest stride.
# The zoo tests below run on tiny here and on w6 in
# tests/test_torch_port_int8_zoo_w6.py, which collects them with its own
# `zoo_model` (each file under a minute on one worker).
ZOO = {"w6": ("yolov7-w6", 0.5, 128), "tiny": ("yolov7-tiny", 0.5, 64)}


def make_zoo_model(name):
    """The deploy cfg at width 0.5, fused by the JAX package; the port gets
    the same fused tree through from_jax_params. JAX's calibrated scales
    on one noise batch."""
    cfg, width, img = ZOO[name]
    jplan, params, state, tplan, _, _ = port_drawn_model(
        zoo_cfg(cfg, "deploy", width), seed=11, stats_seed=12)
    jp, js = jreparam.fuse_model(jplan, _jax(params), _jax(state))
    tp, ts = from_jax_params(tplan, to_numpy(jp), to_numpy(js))
    cal = [np.random.default_rng(13).uniform(0, 1, (1, img, img, 3)).astype(np.float32)]
    scales = jquant.calibrate(jplan, jp, js, cal)
    return name, img, jplan, jp, js, tplan, tp, ts, cal, scales


@pytest.fixture(scope="module", params=["tiny"])
def zoo_model(request):
    return make_zoo_model(request.param)


def test_zoo_eligible_convs_match_jax_full_width(zoo_model):
    """At full width, the same conv leaves and the same K4-eligible ones as
    the JAX package, conv by conv."""
    name = zoo_model[0]
    cfg = zoo_cfg(ZOO[name][0], "deploy", 1.0)
    want = _conv_paths(jgraph.compile_graph(cfg), JL, jquant.pallas_1x1_eligible)
    got = _conv_paths(tgraph.compile_graph(cfg), TL, tquant.pallas_1x1_eligible)
    assert got == want and sum(got.values()) > 0


def test_zoo_calibrate_matches_jax(zoo_model):
    """`calibrate`'s whole dict: the same paths (w6's ReOrg stem, DownC's
    children, the four-level head's "" path) and scales to 1e-4 (the fp32
    forwards differ in summation order)."""
    _, _, _, _, _, tplan, tp, ts, cal, scales = zoo_model
    got = tquant.calibrate(tplan, tp, ts, cal)
    assert got.keys() == scales.keys() and "" in got
    for k in scales:
        np.testing.assert_allclose(got[k], scales[k], rtol=1e-4, err_msg=k)


_QUANTIZED = {}


def _quantized(zoo_model, mixed):
    """JAX's quantization of the fused tree with its scales, in the port's
    layout (made once a model and form)."""
    name, _, jplan, jp, js, tplan, _, _, _, scales = zoo_model
    if (name, mixed) not in _QUANTIZED:
        jq, jqs = jquant.quantize_model(jplan, jp, js, scales, mixed=mixed)
        _QUANTIZED[name, mixed] = (jq, jqs, *from_jax_params(tplan, to_numpy(jq),
                                                             to_numpy(jqs)))
    return _QUANTIZED[name, mixed]


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "full"])
def test_zoo_quantize_matches_jax(zoo_model, mixed):
    """Both packages quantize the same fused tree with JAX's scales: the
    same leaves, wq equal, sw / sx / b equal (all fp32), the head left fp."""
    _, _, jplan, _, _, tplan, tp, ts, _, scales = zoo_model
    want = _flat(_quantized(zoo_model, mixed)[2])
    got = _flat(tquant.quantize_model(tplan, tp, ts, scales, mixed=mixed)[0])
    assert got.keys() == want.keys()
    assert sum(k.endswith("/wq") for k in got) > 0
    assert not any(k.endswith("/wq") for k in got
                   if k.startswith(f"/layers[{len(jplan.layers) - 1}]"))
    for key, t in got.items():
        assert t.dtype == want[key].dtype, key
        if key.endswith(("/wq", "/w")):
            assert torch.equal(t, want[key]), key
        else:
            np.testing.assert_allclose(t.numpy(), want[key].numpy(), rtol=1e-7, err_msg=key)


def test_zoo_int8_layers_match_jax(zoo_model):
    """Full int8 (every conv but the head's; mixed quantizes a subset of
    the same convs), layer by layer: each int8 layer fed JAX's int8 output
    of the layer before agrees to 1e-5 of its output's scale (the same int8
    inputs give the same int32 sums)."""
    name, img, jplan, _, _, tplan, _, _, _, _ = zoo_model
    jq, jqs, tq, tqs = _quantized(zoo_model, False)
    x = np.random.default_rng(14).uniform(0, 1, (1, img, img, 3)).astype(np.float32)
    jctx, tctx = JL.Ctx(), TL.Ctx()
    y, saved = jnp.asarray(x), {}
    for idx, spec in enumerate(jplan.layers):
        if spec.is_head:
            break
        frm = spec.frm if isinstance(spec.frm, tuple) else None
        inp = ([y if j == -1 else saved[j] for j in frm] if frm else
               (y if spec.frm == -1 else saved[spec.frm]))
        tin = [_nchw(a) for a in inp] if frm else _nchw(inp)
        with torch.no_grad():
            t, _ = _run_layer(tctx, tplan.layers[idx], tq["layers"][idx], tqs["layers"][idx],
                              tin, idx)
        y, _ = jrun_layer(jctx, spec, jq["layers"][idx], jqs["layers"][idx], inp, None, idx)
        w = np.asarray(y)
        err = np.abs(t.permute(0, 2, 3, 1).numpy() - w).max()
        assert err <= 1e-5 * max(np.abs(w).max(), 1e-3), (name, idx, err)
        if idx in jplan.save:
            saved[idx] = y


@pytest.mark.parametrize("shape,stride,groups,want", [
    ((128, 256, 1, 1), 1, 1, True), ((128, 256, 1, 1), (1, 1), 1, True),
    ((128, 256, 3, 3), 1, 1, False), ((128, 256, 1, 1), 2, 1, False),
    ((128, 8, 1, 1), 1, 32, False), ((96, 256, 1, 1), 1, 1, False)],
    ids=["1x1", "1x1-pair-stride", "3x3", "stride2", "grouped", "96-out"])
def test_k4_routes(shape, stride, groups, want):
    """`quant.k4_routes`, the test `int8_conv` makes on the weight: K4 takes
    a 1 x 1, stride 1, one-group conv with channels multiples of
    `int8_mm.ALIGN`, and `int8_conv` calls it exactly then."""
    from yolo_series_tpu_torch.ops import int8_mm

    wq = torch.ones(shape, dtype=torch.int8)
    assert tquant.k4_routes(wq, stride, groups) is want
    x = torch.ones((1, shape[1] * groups, 4, 4)).contiguous(memory_format=torch.channels_last)
    with recorded_k4() as k4:
        tquant.int8_conv(x, wq, torch.ones(shape[0]), torch.zeros(shape[0]), stride, 0, groups)
    assert len(k4) == int(want) and int8_mm.ALIGN == 128
