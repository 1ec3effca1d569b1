"""The port's int8 serving path against the JAX package on the CPU: the plain
K4 (int8 matmul with dequant) against the Pallas kernel in interpret mode,
the plain K4b against numpy, weight quantization, the eligibility rule,
`quantize_model`, `calibrate` (with its on-device percentile), the int8
convs and the quantized forward, and the mixed int8 `ServingEngine`
against JAX's. Width 0.5, 128 px, batch <= 2, fp32; weights drawn by JAX,
livened through the port and crossed with `from_jax_params`."""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import feature_error, image_rows, k4_shapes, match_fraction
from tests._torch_port_util import deploy_cfg, jax_model, to_numpy
from yolo_series_tpu.infer import quant as jquant
from yolo_series_tpu.models import graph as jgraph
from yolo_series_tpu.models import layers as JL
from yolo_series_tpu.models import reparam as jreparam
from yolo_series_tpu.models.model import _run_layer as jrun_layer
from yolo_series_tpu.models.model import apply_model as japply
from yolo_series_tpu.ops.pallas_int8 import int8_matmul_dequant as jint8_mm
from yolo_series_tpu_torch.infer import quant as tquant
from yolo_series_tpu_torch.infer.serving import ServingEngine
from yolo_series_tpu_torch.models import graph as tgraph
from yolo_series_tpu_torch.models import layers as TL
from yolo_series_tpu_torch.models.convert import from_jax_params
from yolo_series_tpu_torch.models.model import _run_layer, apply_model
from yolo_series_tpu_torch.ops import int8_mm

torch.set_num_threads(2)


def _nchw(a):
    """NHWC numpy -> the port's NCHW channels-last fp32 tensor."""
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


# ---------------------------------------------------------------- K4 ---

def test_k4_plain_matches_jax_interpret():
    """The plain K4 (what the CPU runs) against the Pallas kernel in
    interpret mode, at the JAX test's shapes (M = 320 is not a multiple
    of the block): int32 sums are exact, the epilogue rounds as JAX's."""
    rng = np.random.default_rng(0)
    m, k, n = 320, 256, 128
    xq = rng.integers(-127, 127, (m, k), np.int8)
    wq = rng.integers(-127, 127, (k, n), np.int8)
    scale = rng.uniform(1e-4, 1e-2, (n,)).astype(np.float32)
    bias = rng.normal(size=(n,)).astype(np.float32)
    want = jint8_mm(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(scale),
                    jnp.asarray(bias), bm=256, bk=128, bn=128, interpret=True)
    before = int8_mm.int8_matmul_dequant.launches
    got = int8_mm.int8_matmul_dequant(*map(torch.from_numpy, (xq, wq, scale, bias)))
    assert int8_mm.int8_matmul_dequant.launches == before  # plain on the CPU
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("m,k,n", [(320, 256, 128), (77, 2048, 384)])
def test_k4b_plain_int8_exact(m, k, n):
    """K4b's int8 form on the CPU (its plain version) equals numpy's int32
    product exactly, up to the largest K of the bench (127^2 * 2048 sums)."""
    rng = np.random.default_rng(k)
    x = rng.integers(-127, 128, (m, k), np.int8)
    w = rng.integers(-127, 128, (k, n), np.int8)
    x[0], w[:, 0] = 127, 127       # the largest sum the path can make
    got = int8_mm.matmul(torch.from_numpy(x), torch.from_numpy(w), torch.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), x.astype(np.int32) @ w.astype(np.int32))
    xb = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(torch.bfloat16)
    wb = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to(torch.bfloat16)
    gotb = int8_mm.matmul(xb, wb, torch.float32)
    np.testing.assert_allclose(gotb.numpy(), xb.float().numpy() @ wb.float().numpy(),
                               rtol=1e-5, atol=1e-4)


def test_k4_wrappers_check_shapes_on_cpu():
    """K and N must be multiples of 128 on every device, as the Pallas
    kernel asserts; the forms of K4b are int8 -> int32 and bf16 -> fp32."""
    x = torch.zeros((64, 96), dtype=torch.int8)
    w = torch.zeros((96, 128), dtype=torch.int8)
    s = torch.ones(128)
    with pytest.raises(ValueError, match="multiples of 128"):
        int8_mm.int8_matmul_dequant(x, w, s, s)
    with pytest.raises(ValueError, match="multiples of 128"):
        int8_mm.matmul(torch.zeros((64, 128), dtype=torch.int8),
                       torch.zeros((128, 64), dtype=torch.int8))
    with pytest.raises(TypeError):
        int8_mm.matmul(torch.zeros((64, 128), dtype=torch.int8),
                       torch.zeros((128, 128), dtype=torch.int8), torch.float32)
    with pytest.raises(ValueError, match="meta|CUDA"):
        int8_mm.int8_matmul_dequant(torch.zeros((64, 128), dtype=torch.int8, device="meta"),
                                    torch.zeros((128, 128), dtype=torch.int8,
                                                device="meta").t(),
                                    s.to("meta"), s.to("meta"))


# ------------------------------------------------- weights, eligibility ---

def test_quantize_weight_matches_jax():
    """Per-output-channel absmax / 127 with the 1e-8 floor (an all-zero
    channel), round half to even (values placed on .5 steps)."""
    rng = np.random.default_rng(1)
    w = rng.normal(0, 0.05, (3, 3, 16, 32)).astype(np.float32)    # HWIO
    w[..., 3] = 0.0
    w[0, 0, :4, 5] = np.array([0.5, 1.5, 2.5, -2.5], np.float32) * (1.0 / 127.0)
    w[1, 1, 0, 5] = 1.0                                            # absmax 1
    jwq, jsw = jquant.quantize_weight(jnp.asarray(w))
    twq, tsw = tquant.quantize_weight(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
    assert twq.dtype == torch.int8
    np.testing.assert_array_equal(twq.numpy().transpose(2, 3, 1, 0), np.asarray(jwq))
    np.testing.assert_allclose(tsw.numpy(), np.asarray(jsw), rtol=1e-7)
    assert tsw[3] == np.float32(1e-8)


def test_eligibility_predicate():
    """The cases of tests/test_pallas_int8.py, on the port's blocks."""
    assert tquant.pallas_1x1_eligible(TL.ConvBnAct(256, 128, 1, 1))
    assert not tquant.pallas_1x1_eligible(TL.ConvBnAct(256, 128, 3, 1))   # 3x3
    assert not tquant.pallas_1x1_eligible(TL.ConvBnAct(256, 128, 1, 2))   # s2
    assert not tquant.pallas_1x1_eligible(TL.ConvBnAct(256, 256, 1, 1, g=2))
    assert not tquant.pallas_1x1_eligible(TL.ConvBnAct(96, 128, 1, 1))    # 96%128


def _conv_paths(plan, lib, eligible):
    """{path: eligible} of every conv leaf of a plan, with the paths of
    quantize_tree, walked with one package's blocks and predicate."""
    out = {}

    def walk(block, path):
        if isinstance(block, (lib.ConvBnAct, lib.RepConv, lib.PlainConv)):
            out[path] = eligible(block)
        elif isinstance(block, lib.Composite):
            for name, child in block.children().items():
                walk(child, f"{path}/{name}")

    for idx, spec in enumerate(plan.layers):
        if not spec.is_head:
            walk(spec.block, f"l{idx}")
    return out


def test_eligible_convs_match_jax_full_width():
    """Full-width yolov7 deploy: the same conv leaves and the same 41
    K4-eligible ones as the JAX package; `chip_smoke.k4_shapes` gives
    their batch-8, 640 px shapes (2 at 160 px, 10 at 80, 15 at 40, 14 at
    20: 245.8 G int8 operations, 1.46 GB with the fp32 output)."""
    jplan = jgraph.compile_graph(deploy_cfg(1.0))
    tplan = tgraph.compile_graph(deploy_cfg(1.0))
    want = _conv_paths(jplan, JL, jquant.pallas_1x1_eligible)
    got = _conv_paths(tplan, TL, tquant.pallas_1x1_eligible)
    assert got == want
    assert len(got) == 89 and sum(got.values()) == 41
    shapes = k4_shapes(tplan, 8, 640)
    assert len(shapes) == 41
    assert Counter(int((m // 8) ** 0.5) for m, _, _ in shapes) == {160: 2, 80: 10,
                                                                   40: 15, 20: 14}
    assert round(sum(2 * m * k * n for m, k, n in shapes) / 1e8) == 2458
    assert round(sum(m * k + k * n + 4 * m * n for m, k, n in shapes) / 1e7) == 146


# ------------------------------------------------------------ models ---

@pytest.fixture(scope="module")
def models():
    """Width-0.5 deploy yolov7, fused by the JAX package; the port gets the
    same fused tree through from_jax_params. Plus JAX's calibrated scales
    on two noise batches."""
    plan, params, state = jax_model(0.5, seed=2)
    jp, js = jreparam.fuse_model(plan, jax.tree_util.tree_map(jnp.asarray, params),
                                 jax.tree_util.tree_map(jnp.asarray, state))
    tplan = tgraph.compile_graph(deploy_cfg(0.5))
    tp, ts = from_jax_params(tplan, to_numpy(jp), to_numpy(js))
    rng = np.random.default_rng(5)
    cal = [rng.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32) for _ in range(2)]
    scales = jquant.calibrate(plan, jp, js, cal)
    return plan, jp, js, tplan, tp, ts, cal, scales


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}[{i}]").items()}
    return {prefix: tree}


@pytest.mark.parametrize("mixed", [True, False])
def test_quantize_model_matches_jax(models, mixed):
    """Both packages quantize the same fused tree: the same leaves, wq
    equal, sw / sx / b equal (all fp32), the head left fp."""
    plan, jp, js, tplan, tp, ts, _, scales = models
    jq, _ = jquant.quantize_model(plan, jp, js, scales, mixed=mixed)
    want = _flat(from_jax_params(tplan, to_numpy(jq), to_numpy(js))[0])
    got = _flat(tquant.quantize_model(tplan, tp, ts, scales, mixed=mixed)[0])
    assert got.keys() == want.keys()
    n_wq = sum(k.endswith("/wq") for k in got)
    assert n_wq == (30 if mixed else 89)
    assert not any(k.endswith("/wq") for k in got if k.startswith(f"/layers[{len(plan.layers) - 1}]"))
    for key, t in got.items():
        assert t.dtype == want[key].dtype, key
        if key.endswith(("/wq", "/w")):
            assert torch.equal(t, want[key]), key
        else:
            np.testing.assert_allclose(t.numpy(), want[key].numpy(), rtol=1e-7, err_msg=key)


@pytest.mark.parametrize("n,q", [(1, 99.99), (2, 50.0), (1000, 99.99), (12345, 0.0),
                                 (12345, 100.0), (200001, 99.99), (200001, 37.5)])
def test_abs_percentile_matches_numpy(n, q):
    """The on-device percentile (two order statistics) equals numpy's
    linear percentile of |x| bit for bit, both ends of the range too."""
    x = np.random.default_rng(n).normal(0, 2.0, n).astype(np.float32)
    assert tquant.abs_percentile(torch.from_numpy(x), q) == float(
        np.percentile(np.abs(x), q))


def test_calibrate_matches_jax(models):
    """The same paths as JAX's calibrate (conv leaves "l3", "l51/cv1", and
    "" for the head's convs, as JAX's head runs with the base context),
    and scales to 1e-4: the fp32 forwards differ in summation order only."""
    plan, _, _, tplan, tp, ts, cal, scales = models
    got = tquant.calibrate(tplan, tp, ts, cal)
    assert got.keys() == scales.keys() and len(got) == 90
    assert {"", "l0", "l51/cv1", "l51/cv7", "l104"} <= got.keys()
    for k in scales:
        np.testing.assert_allclose(got[k], scales[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("k,s,pad,c,n,static", [
    (1, 1, 0, 128, 256, True),          # K4-eligible: int8_conv1x1
    (1, 1, 0, 96, 128, False),          # 1x1 with unaligned channels: im2col
    (3, 1, 1, 32, 64, True),
    (3, 2, 1, 3, 32, False),            # the stem's first conv: K = 27
    (3, 1, ((1, 0), (0, 2)), 16, 48, True),
])
def test_int8_conv_matches_jax(k, s, pad, c, n, static):
    """`quant.int8_conv` against JAX's (the XLA int8 conv on the CPU): the
    int32 sums are exact and the epilogue rounds the same way."""
    rng = np.random.default_rng(k * 100 + c)
    x = rng.normal(0, 1.0, (2, 12, 14, c)).astype(np.float32)
    w = rng.normal(0, 0.1, (k, k, c, n)).astype(np.float32)
    b = rng.normal(0, 0.1, (n,)).astype(np.float32)
    sx = np.float32(0.021) if static else None
    jwq, jsw = jquant.quantize_weight(jnp.asarray(w))
    want = jquant.int8_conv(jnp.asarray(x), jwq, jsw, jnp.asarray(b), s, pad, 1,
                            None if sx is None else jnp.asarray(sx))
    twq = torch.from_numpy(np.asarray(jwq).transpose(3, 2, 0, 1).copy())
    got = tquant.int8_conv(_nchw(x), twq, torch.from_numpy(np.array(jsw)),
                           torch.from_numpy(b), s, pad, 1,
                           None if sx is None else torch.tensor(sx))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


CASES = [("mixed", True), ("full", True), ("full-dynamic", False)]


def _quantized(models, case):
    plan, jp, js, tplan, _, _, _, scales = models
    name, calibrated = case
    jq, jqs = jquant.quantize_model(plan, jp, js, scales if calibrated else None,
                                    mixed=name == "mixed")
    tq, tqs = from_jax_params(tplan, to_numpy(jq), to_numpy(jqs))
    return jq, jqs, tq, tqs


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_int8_layers_match_jax(models, case):
    """Layer by layer on the same input (JAX's output of the layer before):
    every layer of the quantized plan agrees to 1e-5 of its output's
    scale. Same int8 inputs give the same int32 sums, so what is left is
    the fp32 convs' summation order."""
    plan, _, _, tplan, _, _, _, _ = models
    jq, jqs, tq, tqs = _quantized(models, case)
    x = np.random.default_rng(6).uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    jctx, tctx = JL.Ctx(), TL.Ctx()
    y, saved = jnp.asarray(x), {}
    for idx, spec in enumerate(plan.layers):
        if spec.is_head:
            break
        frm = spec.frm if isinstance(spec.frm, tuple) else None
        inp = ([y if j == -1 else saved[j] for j in frm] if frm else
               (y if spec.frm == -1 else saved[spec.frm]))
        tin = [_nchw(a) for a in inp] if frm else _nchw(inp)
        with torch.no_grad():
            got, _ = _run_layer(tctx, tplan.layers[idx], tq["layers"][idx],
                                tqs["layers"][idx], tin, idx)
        y, _ = jrun_layer(jctx, spec, jq["layers"][idx], jqs["layers"][idx], inp, None, idx)
        want = np.asarray(y)
        err = np.abs(got.permute(0, 2, 3, 1).numpy() - want).max()
        assert err <= 1e-5 * max(np.abs(want).max(), 1e-3), (idx, err)
        if idx in plan.save:
            saved[idx] = y


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_int8_forward_matches_jax(models, case, monkeypatch):
    """End to end, the head inputs of the two quantized forwards. A value
    that lands on a rounding boundary of x / sx rounds to one int8 step in
    one package and the other in the other (the fp32 convs sum in another
    order), and a difference of one step meets more boundaries downstream:
    after a few quantized convs the two int8 paths lie about as far apart
    as each lies from fp32. So the port's distance from JAX must stay
    within 1.5x JAX's own int8-to-fp32 distance (measured 0.7-1.1x),
    which a wrong scale or channel (~100%) breaks. The K4 launches of the
    forward have the shapes `chip_smoke.k4_shapes` lists."""
    plan, jp, js, tplan, _, _, _, _ = models
    jq, jqs, tq, tqs = _quantized(models, case)
    x = np.random.default_rng(7).uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    jfp, _ = japply(plan, jp, js, jnp.asarray(x), return_head_inputs=True)
    jint8, _ = japply(plan, jq, jqs, jnp.asarray(x), return_head_inputs=True)
    shapes = []
    plain = int8_mm.int8_matmul_dequant

    def spy(xq, wq, scale, bias):
        shapes.append((xq.shape[0], xq.shape[1], wq.shape[1]))
        return plain(xq, wq, scale, bias)

    monkeypatch.setattr(int8_mm, "int8_matmul_dequant", spy)
    with torch.inference_mode():
        got, _ = apply_model(tplan, tq, tqs, torch.from_numpy(x), return_head_inputs=True)
    assert sorted(shapes) == sorted(k4_shapes(tplan, 2, 128)) and len(shapes) == 30
    to_t = lambda fs: [torch.from_numpy(np.array(f)) for f in fs]  # noqa: E731
    err, int8_err = feature_error(got, to_t(jint8)), feature_error(to_t(jint8), to_t(jfp))
    assert all(torch.isfinite(g).all() for g in got)
    assert err <= 1.5 * int8_err, (err, int8_err)


def test_int8_serving_engine_matches_jax(models, monkeypatch):
    """The mixed int8 engines of both packages at 128 px, batch 2, fp32
    working dtype, built as tools/exp_int8_serve.py builds JAX's:
    calibrate, quantize the K4-eligible 1x1s, then the stem and ELAN
    transforms. The same plan (the fused stem; only the span whose 1x1s
    stay fp fuses). Detections are random boxes packed densely in score:
    as two int8 paths lie about as far apart as int8 from fp32 (see
    test_int8_forward_matches_jax), each image's matched fraction between
    the two must be within 0.1 of JAX's own int8-to-fp32 agreement."""
    monkeypatch.setenv("YOLO_TPU_PALLAS_STEM", "1")
    monkeypatch.setenv("YOLO_TPU_PALLAS_ELAN", "1")
    monkeypatch.setenv("YOLO_TPU_PALLAS_INTERPRET", "1")
    from yolo_series_tpu.infer.serving import ServingEngine as JaxEngine

    plan, jp, js, tplan, _, ts, _, _ = models
    jq, jqs, tq, tqs = _quantized(models, ("mixed", True))
    kw = dict(batch_size=2, img_size=128, max_det=100, max_nms=512)
    jeng = JaxEngine(plan, jq, jqs, dtype=jnp.float32, **kw)
    jfp = JaxEngine(plan, jp, js, dtype=jnp.float32, **kw)
    teng = ServingEngine(tplan, tq, tqs, dtype=torch.float32, device="cpu", **kw)
    names = [type(layer.block).__name__ for layer in teng.plan.layers]
    assert names.count("FusedStem") == 1 and names.count("FusedELAN") == 1
    assert [type(la.block).__name__ for la in jeng.plan.layers] == names
    x = np.random.default_rng(4).integers(0, 255, (2, 128, 128, 3), np.uint8)
    before = int8_mm.int8_matmul_dequant.launches
    want, ref, got = jeng.infer(x), jfp.infer(x), teng.infer(x)
    assert int8_mm.int8_matmul_dequant.launches == before   # plain on the CPU
    assert got["det_boxes"].shape == (2, 100, 4)
    for i in range(2):
        a, b, r = image_rows(got, i), image_rows(want, i), image_rows(ref, i)
        assert len(b["scores"]) > 5 and np.isfinite(a["boxes"]).all()
        floor = min(match_fraction(b, r), match_fraction(r, b)) - 0.1
        assert min(match_fraction(a, b), match_fraction(b, a)) >= floor


def test_bf16_placement_keeps_int8_leaves_fp32(models):
    """At a bf16 working dtype the engine casts fp32 weights to bf16 but
    keeps every int8 leaf's sw, sx and b in fp32 (int8 wq), as JAX does."""
    _, _, _, tplan, tp, ts, _, scales = models
    tq, tqs = tquant.quantize_model(tplan, tp, ts, scales, mixed=True)
    eng = ServingEngine(tplan, tq, tqs, batch_size=1, img_size=64,
                        dtype=torch.bfloat16, device="cpu")
    leaves = _flat(eng._params)
    int8_leaves = {k[:-len("/wq")] for k in leaves if k.endswith("/wq")}
    for key, t in leaves.items():
        base, _, name = key.rpartition("/")
        if base in int8_leaves:
            assert t.dtype == (torch.int8 if name == "wq" else torch.float32), key
            assert name in ("wq", "sw", "sx", "b"), key
        elif t.dtype.is_floating_point:
            assert t.dtype == torch.bfloat16, key
    n_int8 = len(int8_leaves)
    assert all(f"{b}/sx" in leaves for b in int8_leaves)
    assert n_int8 == 30
    out = eng.infer(np.zeros((1, 64, 64, 3), np.uint8))
    assert np.isfinite(out["det_boxes"]).all()
