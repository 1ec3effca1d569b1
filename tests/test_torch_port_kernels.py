"""The port's kernel modules against the JAX package on the CPU: the plain
versions of K1 (NMS keep-mask), K2 (fused stem tail) and K3 (fused ELAN
span) against the JAX functions and the Pallas kernels in interpret mode,
and the span finder and weight packing against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_util import deploy_cfg, jax_model, nms_chain
from yolo_series_tpu.models import graph as jgraph
from yolo_series_tpu.models import reparam as jreparam
from yolo_series_tpu.ops import nms as jnms
from yolo_series_tpu.ops import pallas_elan as jpe
from yolo_series_tpu.ops import pallas_stem as jps
from yolo_series_tpu.ops.pallas_nms import nms_keep_mask_pallas
from yolo_series_tpu_torch.models import graph as tgraph
from yolo_series_tpu_torch.models import reparam as treparam
from yolo_series_tpu_torch.models.convert import from_jax_params
from yolo_series_tpu_torch.ops import conv_silu
from yolo_series_tpu_torch.ops import fused_elan as tfe
from yolo_series_tpu_torch.ops import fused_stem as tfs
from yolo_series_tpu_torch.ops import nms_keep
from yolo_series_tpu_torch.ops.boxes import box_iou

torch.set_num_threads(2)


# ---------------------------------------------------------------- spans ---

def _dummy_fused(plan):
    """Structurally fused params ({w, b} everywhere) for the span finder."""
    return {"layers": [{"w": 0, "b": 0} for _ in plan.layers]}


# (H at 640 px, cin, ct, cc, cout) of the 8 spans of full-width yolov7
SPAN_SHAPES = {
    4: (160, 128, 64, 64, 256), 17: (80, 256, 128, 128, 512),
    30: (40, 512, 256, 256, 1024), 43: (20, 1024, 256, 256, 1024),
    56: (40, 512, 256, 128, 256), 68: (80, 256, 128, 64, 128),
    81: (40, 512, 256, 128, 256), 94: (20, 1024, 512, 256, 512)}


def test_find_elan_spans_matches_jax_full_width():
    jplan = jgraph.compile_graph(deploy_cfg(1.0))
    tplan = tgraph.compile_graph(deploy_cfg(1.0))
    want = jpe.find_elan_spans(jplan, _dummy_fused(jplan))
    got = tfe.find_elan_spans(tplan, _dummy_fused(tplan))
    assert got == want == ((4, "backbone"), (17, "backbone"), (30, "backbone"),
                           (43, "backbone"), (56, "head"), (68, "head"),
                           (81, "head"), (94, "head"))
    for i, _ in got:
        layers = tplan.layers
        shape = (int(640 / layers[i].stride), layers[i].block.c1,
                 layers[i].block.c2, layers[i + 2].block.c2,
                 layers[i + 7].block.c2)
        assert shape == SPAN_SHAPES[i], i


@pytest.fixture(scope="module")
def fused_half():
    """Width-0.5 deploy yolov7, fused by JAX and by the port from the same
    weights."""
    plan, params, state = jax_model(0.5, seed=3)
    jp, js = jreparam.fuse_model(plan, jax.tree_util.tree_map(jnp.asarray, params),
                                 jax.tree_util.tree_map(jnp.asarray, state))
    tplan = tgraph.compile_graph(deploy_cfg(0.5))
    tp, ts = from_jax_params(tplan, params, state)
    fp, fs_ = treparam.fuse_model(tplan, tp, ts)
    return plan, jp, js, tplan, fp, fs_


def _bf16_equal(port, jax_arr, shape):
    """The port's HWIO bf16 weight, reshaped to JAX's packed form, holds the
    same bf16 values."""
    a = port.float().reshape(shape).numpy()
    np.testing.assert_array_equal(a, np.asarray(jax_arr, np.float32))


def test_span_packing_unpacks_to_jax(fused_half):
    plan, jp, _, tplan, fp, _ = fused_half
    spans = tfe.find_elan_spans(tplan, fp)
    assert spans == jpe.find_elan_spans(plan, jp)
    for i, _ in spans:
        want = jpe._pack_span(jp["layers"], i)
        got = tfe.pack_span(fp["layers"], i)
        for k, v in want.items():
            assert got[k].dtype == torch.bfloat16
            _bf16_equal(got[k], v, v.shape)


def test_span_packing_merges_x4_x5_for_one_launch(fused_half):
    """pack_span keeps w4, b4, w5, b5 (compared with JAX above) and adds the
    kernel's merged w45 = [w5 | w4], b45 = [b5 | b4]: the order of their
    concat slots."""
    _, _, _, tplan, fp, _ = fused_half
    for i, _ in tfe.find_elan_spans(tplan, fp):
        got = tfe.pack_span(fp["layers"], i)
        assert torch.equal(got["w45"], torch.cat([got["w5"], got["w4"]], dim=3))
        assert torch.equal(got["b45"], torch.cat([got["b5"], got["b4"]]))
        assert got["w45"].is_contiguous() and got["w45"].dtype == torch.bfloat16


@pytest.mark.parametrize("order", ["backbone", "head"])
def test_merged_x45_conv_equals_the_two_convs(order):
    """One plain conv with the merged weight gives, in the x5 and x4 concat
    slots, the two plain convs bit for bit (the kernel's x45 launch)."""
    rng = np.random.default_rng(7)
    cin, ct, cc = 64, 32, 32
    x = torch.from_numpy(_bf16_np(rng, (2, 8, 12, cin), 1.0)).to(torch.bfloat16)
    p = {k: torch.from_numpy(_bf16_np(rng, shape, 0.1)).to(torch.bfloat16)
         for k, shape in (("w4", (1, 1, cin, ct)), ("b4", (ct,)),
                          ("w5", (1, 1, cin, ct)), ("b5", (ct,)))}
    m = tfe.merge_x45(p)
    both = conv_silu.conv_silu_plain(x, m["w45"], m["b45"])
    slots, _ = tfe.concat_slots(order, ct, cc)
    assert slots["x4"] == slots["x5"] + ct  # x5 then x4, side by side
    assert torch.equal(both[..., :ct], conv_silu.conv_silu_plain(x, p["w5"], p["b5"]))
    assert torch.equal(both[..., ct:], conv_silu.conv_silu_plain(x, p["w4"], p["b4"]))


@pytest.mark.parametrize("k,stride,pad,want", [
    (2, 1, (1, 0), (1, 0, 1, 0)),   # the stem's k2 stage
    (3, 1, (1, 1), (1, 1, 1, 1)),
    (3, 2, (1, 0), (1, 1, 1, 1)),   # stride 2: the unread last row padded too
    (1, 1, (0, 0), (0, 0, 0, 0))])
def test_chip_smoke_launch_stage_matches_the_launch(k, stride, pad, want):
    """`chip_smoke.launch_stage`, behind the stage lines and the staged
    floor, recovers a recorded launch's logical input and output slices and
    its pad: the plain conv of the slice has the output slice's shape, and
    the counts are 2 M N K operations and each slice, weight and bias once."""
    import chip_smoke

    h, wid, c, co = 8, 10, 32, 16
    oh = (h + sum(pad) - k) // stride + 1
    ow = (wid + sum(pad) - k) // stride + 1
    x = torch.zeros((2, h + 3, wid, 96), dtype=torch.bfloat16)
    w = torch.zeros((k, k, c, co), dtype=torch.bfloat16)
    b = torch.zeros((co,), dtype=torch.bfloat16)
    y = torch.zeros((2, oh, ow, 48), dtype=torch.bfloat16)
    st = chip_smoke.launch_stage(((x, w, b, y), dict(
        h=h, c=c, stride=stride, pad_t=pad[0], pad_l=pad[0], x_row0=3, x_coff=64,
        y_coff=16)))
    assert st.pad == want and st.stride == stride
    assert st.x.shape == (2, h, wid, c) and st.y.shape == (2, oh, ow, co)
    assert conv_silu.conv_silu_plain(st.x, w, b, stride, st.pad).shape == st.y.shape
    assert st.ops == 2 * (2 * oh * ow) * co * (k * k * c)
    assert st.nbytes == 2 * (st.x.numel() + w.numel() + b.numel() + st.y.numel())


def test_stem_packing_unpacks_to_jax(fused_half):
    plan, jp, js, tplan, fp, fs_ = fused_half
    assert tfs._stem_matches(tplan, fp) and jps._stem_matches(plan, jp)
    jplan2, jp2, _ = jps.make_pallas_stem(plan, jp, js, force=True)
    tplan2, fp2, _ = tfs.make_fused_stem(tplan, fp, fs_)
    for a, b in zip(tplan2.layers[:4], jplan2.layers[:4]):
        assert (type(a.block).__name__, a.cout, a.stride, a.frm) == \
            (type(b.block).__name__, b.cout, b.stride, b.frm)
    assert tplan2.layers[0].block.pad == jplan2.layers[0].block.pad
    np.testing.assert_array_equal(
        fp2["layers"][0]["w"].permute(2, 3, 1, 0).numpy(),
        np.asarray(jp2["layers"][0]["w"]))
    for k, v in jp2["layers"][1].items():
        _bf16_equal(fp2["layers"][1][k], v, v.shape)


# ----------------------------------------------------- K2 / K3 numerics ---

def _bf16_np(rng, shape, scale):
    """Random values exactly representable in bf16, as float32 numpy."""
    x = torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


class _Ctx:
    dtype = jnp.float32


def _close(got, want, rel):
    d = np.abs(got - want)
    scale = max(np.abs(want).max(), 1.0)
    assert d.max() <= rel * scale, (d.max(), scale)
    edge = np.concatenate([d[:, :2], d[:, -2:]], axis=1)  # image-boundary rows
    assert edge.max() <= rel * scale, (edge.max(), scale)


# Tolerances. Against the interpret-mode Pallas kernel: the same math,
# rounded to bf16 at the same points (fp32 accumulate, + bias, SiLU, bf16),
# in another summation order — a stage output may round to the
# neighbouring bf16 value and that compounds through the chain: 1% of the
# output scale. Against `_ref_apply`: it rounds each conv's sum to bf16
# before the bias and keeps the stage outputs in fp32 (dtype fp32): 5%, as
# the JAX package's own interpret tests allow.
PALLAS_REL, REF_REL = 1e-2, 5e-2


def test_fused_stem_plain_matches_jax(monkeypatch):
    monkeypatch.setenv("YOLO_TPU_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(0)
    hx, w, c1, cm, co = 32, 32, 128, 64, 128
    p = {"wk2": _bf16_np(rng, (2, 2, c1, cm), 0.05), "b1": _bf16_np(rng, (cm,), 0.1),
         "ws2": _bf16_np(rng, (3, 3, cm, cm), 0.05), "b2": _bf16_np(rng, (cm,), 0.1),
         "ws3": _bf16_np(rng, (3, 3, cm, co), 0.05), "b3": _bf16_np(rng, (co,), 0.1)}
    # halo rows non-zero: both must read past them
    x = _bf16_np(rng, (2, hx + 2 * jps._PAD, w, c1), 1.0)
    jparams = {"wk2": p["wk2"].reshape(2, 2 * c1, cm), "b1": p["b1"],
               "ws2": p["ws2"].reshape(3, 3 * cm, cm), "b2": p["b2"],
               "ws3": p["ws3"].reshape(3, 3 * cm, co), "b3": p["b3"]}
    jparams = {k: jnp.asarray(v, jnp.bfloat16) for k, v in jparams.items()}
    blk = jps.FusedStem(c1, cm, co)
    pallas, _ = blk.apply(jparams, {}, jnp.asarray(x), _Ctx())
    ref = blk._ref_apply(jparams, jnp.asarray(x), jnp.float32)
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()}
    got = tfs.fused_stem(torch.from_numpy(x).to(torch.bfloat16), tp)
    got = got.float().numpy()
    assert got.shape == (2, hx // 2, w // 2, co)
    _close(got, np.asarray(pallas, np.float32), PALLAS_REL)
    _close(got, np.asarray(ref, np.float32), REF_REL)


@pytest.mark.parametrize("order", ["backbone", "head"])
def test_fused_elan_plain_matches_jax(order, monkeypatch):
    monkeypatch.setenv("YOLO_TPU_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(1)
    h = w = 16
    cin, ct, cc, cout = 32, 32, 32, 64
    cat = (4 * cc + 2 * ct) if order == "head" else (2 * cc + 2 * ct)
    p = {"w4": _bf16_np(rng, (1, 1, cin, ct), 0.1), "b4": _bf16_np(rng, (ct,), 0.1),
         "w5": _bf16_np(rng, (1, 1, cin, ct), 0.1), "b5": _bf16_np(rng, (ct,), 0.1),
         "wc0": _bf16_np(rng, (3, 3, ct, cc), 0.05), "bc0": _bf16_np(rng, (cc,), 0.1),
         "wc": _bf16_np(rng, (3, 3, 3, cc, cc), 0.05),
         "bc": _bf16_np(rng, (3, cc), 0.1),
         "w11": _bf16_np(rng, (1, 1, cat, cout), 0.05),
         "b11": _bf16_np(rng, (cout,), 0.1)}
    x = _bf16_np(rng, (2, h, w, cin), 1.0)
    jparams = dict(p, w4=p["w4"][0, 0], w5=p["w5"][0, 0], w11=p["w11"][0, 0],
                   wc0=p["wc0"].reshape(3, 3 * ct, cc),
                   wc=p["wc"].reshape(3, 3, 3 * cc, cc))
    jparams = {k: jnp.asarray(v, jnp.bfloat16) for k, v in jparams.items()}
    blk = jpe.FusedELAN(cin, ct, cc, cout, order)
    pallas, _ = blk.apply(jparams, {}, jnp.asarray(x), _Ctx())
    ref = blk._ref_apply(jparams, jnp.asarray(x), jnp.float32)
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()}
    got = tfe.fused_elan(torch.from_numpy(x).to(torch.bfloat16), tp, order)
    got = got.float().numpy()
    assert got.shape == (2, h, w, cout)
    _close(got, np.asarray(pallas, np.float32), PALLAS_REL)
    _close(got, np.asarray(ref, np.float32), REF_REL)


def test_concat_slots_follow_the_reference_order():
    slots, width = tfe.concat_slots("head", 32, 64)
    assert list(slots) == ["c4", "c3", "c2", "c1", "x5", "x4"]
    assert list(slots.values()) == [0, 64, 128, 192, 256, 288] and width == 320
    slots, width = tfe.concat_slots("backbone", 32, 64)
    assert slots == {"c4": 0, "c2": 64, "x5": 128, "x4": 160} and width == 192


# ------------------------------------------------------------------ K1 ---

def _clustered(rng, k, nc=1, spread=640.0, sigma=20.0):
    centers = rng.uniform(100, spread - 100, (max(k // 8, 1), 2))
    cxy = centers[rng.integers(0, len(centers), k)] + rng.normal(0, sigma, (k, 2))
    wh = rng.uniform(20, 120, (k, 2))
    cls = rng.integers(0, nc, (k, 1)).astype(np.float32)
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], 1) + cls * 4096.0
    return boxes.astype(np.float32)


def _jax_full(boxes, valid, thr):
    """nms_keep_mask_full per image, with invalid rows zeroed first as
    `_nms_tail` does (a zero box suppresses nothing)."""
    boxes = np.where(valid[..., None], boxes, np.float32(0))
    return np.stack([np.asarray(jnms.nms_keep_mask_full(jnp.asarray(b), thr))
                     & v for b, v in zip(boxes, valid)])


@pytest.mark.parametrize("thr", [0.3, 0.45, 0.65])
def test_keep_mask_plain_matches_full_fixpoint(thr):
    """Deep suppression chains with class offsets (coordinates near 3.3e5),
    some invalid rows; the plain version runs to convergence like
    nms_keep_mask_full."""
    rng = np.random.default_rng(int(thr * 100))
    boxes = np.stack([_clustered(rng, 256, nc=3, sigma=8.0) for _ in range(3)])
    boxes[..., :] += np.float32(79 * 4096.0)
    valid = rng.uniform(size=(3, 256)) < 0.9
    want = _jax_full(boxes, valid, thr)
    got = nms_keep.nms_keep_mask(torch.from_numpy(boxes), torch.from_numpy(valid), thr)
    np.testing.assert_array_equal(got.numpy(), want)


def test_keep_mask_plain_matches_pallas_interpret():
    """The Pallas kernel stops after 64 fixpoint passes: compare on inputs
    whose suppression chains are shallower (as tests/test_nms.py does)."""
    rng = np.random.default_rng(5)
    boxes = np.stack([_clustered(rng, 128) for _ in range(4)])
    valid = np.ones((4, 128), bool)
    valid[1, 60:] = False
    want = np.asarray(nms_keep_mask_pallas(jnp.asarray(boxes), jnp.asarray(valid),
                                           0.45, interpret=True))
    got = nms_keep.nms_keep_mask(torch.from_numpy(boxes), torch.from_numpy(valid),
                                 0.45)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _jax_full(boxes, valid, 0.45))


def test_keep_mask_ties_keep_the_lower_index():
    """Exact duplicates (IoU 1) and a box that touches its twin at exactly
    the threshold: the lower index wins, and IoU == thr does not suppress."""
    rng = np.random.default_rng(9)
    base = _clustered(rng, 64)
    boxes = np.concatenate([base, base[::-1]])[None]          # every box twice
    boxes = np.concatenate([boxes, boxes[:, ::-1]])           # both orders
    valid = np.ones(boxes.shape[:2], bool)
    want = _jax_full(boxes, valid, 0.45)
    got = nms_keep.nms_keep_mask(torch.from_numpy(boxes.copy()),
                                 torch.from_numpy(valid), 0.45).numpy()
    np.testing.assert_array_equal(got, want)
    half = np.array([[[0, 0, 10, 10], [0, 0, 10, 5]]], np.float32)  # IoU 0.5
    keep = nms_keep.nms_keep_mask(torch.from_numpy(half),
                                  torch.ones((1, 2), dtype=torch.bool), 0.5)
    assert keep.tolist() == [[True, True]]


def _bitmask_scan(boxes, valid, thr):
    """A numpy model of the keep-mask kernel (csrc/nms_keep.cu) for one
    image: the suppression bitmask as 32-bit words (bit p % 32 of word
    p // 32 of row i is IoU(i, p) > thr for p > i), built for valid rows up
    to the last valid box, then the block-by-block scan: lane w resolves
    block w alone, every later lane ORs the kept rows' words."""
    k = len(boxes)
    nw = (k + 31) // 32
    iou = box_iou(torch.from_numpy(boxes), torch.from_numpy(boxes)).numpy()
    n_eff = int(np.flatnonzero(valid)[-1]) + 1 if valid.any() else 0
    rows = np.zeros((k, nw), np.uint32)
    for i in np.flatnonzero(valid[:n_eff]):
        for p in range(i + 1, n_eff):
            if iou[i, p] > thr:
                rows[i, p // 32] |= np.uint32(1 << (p % 32))
    bits = np.zeros(nw * 32, bool)
    bits[:k] = valid
    removed = [np.uint32(0xFFFFFFFF) ^ np.uint32(sum(1 << t for t in range(32)
                                                     if bits[32 * j + t]))
               for j in range(nw)]
    for w in range((n_eff + 31) // 32):
        r = removed[w]
        for t in range(32):
            i = 32 * w + t
            if not (r >> np.uint32(t)) & np.uint32(1):
                r |= rows[i, w]
        removed[w] = r
        kept = np.uint32(0xFFFFFFFF) ^ r
        for j in range(w + 1, nw):
            for t in range(32):
                if (kept >> np.uint32(t)) & np.uint32(1):
                    removed[j] |= rows[32 * w + t, j]
    return np.array([not (removed[p // 32] >> np.uint32(p % 32)) & np.uint32(1)
                     for p in range(k)])


@pytest.mark.parametrize("case,k", [("chain", 1), ("chain", 31), ("chain", 33),
                                    ("chain", 1000), ("clusters", 33),
                                    ("clusters", 1000), ("ties", 64),
                                    ("invalid", 31), ("invalid", 1000),
                                    ("chain_boxes", 1000)])
def test_keep_mask_bitmask_scan_model_matches_plain_and_jax(case, k):
    """The kernel's algorithm (words, bit order, block scan, invalid boxes
    starting removed, work cut at the last valid box) equals the plain
    version and JAX's nms_keep_mask_full on chains (with class offsets),
    clusters, exact duplicates and rows with no valid box."""
    rng = np.random.default_rng(k)
    if case == "chain":
        boxes = np.stack([nms_chain(k), nms_chain(k, 79 * 4096.0)])
        valid = np.ones((2, k), bool)
        valid[1, k // 2:] = False
    elif case == "chain_boxes":   # chip_smoke.py's K1 input: chains and clusters
        import chip_smoke

        boxes = chip_smoke.chain_boxes(rng, 2, k)
        valid = np.arange(k)[None] < np.array([[k], [k - 200]])
    elif case == "ties":
        base = _clustered(rng, k // 2, nc=2, sigma=8.0)
        boxes = np.stack([np.concatenate([base, base[::-1]])] * 2)
        valid = np.ones((2, k), bool)
    else:
        boxes = np.stack([_clustered(rng, k, nc=3, sigma=8.0) for _ in range(3)])
        valid = rng.uniform(size=(3, k)) < 0.8
        if case == "invalid":
            valid[0] = False
            valid[2, : k // 2] = False
    got = np.stack([_bitmask_scan(b, v, 0.45) for b, v in zip(boxes, valid)])
    plain = nms_keep.nms_keep_mask(torch.from_numpy(boxes), torch.from_numpy(valid), 0.45)
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(got, _jax_full(boxes, valid, 0.45))
    if case == "chain":
        assert got[0].tolist() == [i % 2 == 0 for i in range(k)]


# ------------------------------------------------------------------ K4 ---

K4B_SHAPES = ((12800, 1024, 512), (3200, 2048, 1024), (8192, 1024, 1024))


@pytest.mark.parametrize("sms", [132, 114])
def test_k4_tile_choice_fills_the_card(sms):
    """The tile `ops/int8_mm.pick_tile` gives each of the 41 K4 launches of
    a batch-8, 640 px forward and each K4b bench shape: one the kernel
    takes, whose columns divide N, the largest that gives every SM a tile
    (three quarters of them where K >= 1024), else the smallest; and so one
    that gives every SM a tile or runs the whole output in one wave of the
    persistent CTAs."""
    import chip_smoke
    from yolo_series_tpu_torch.ops import int8_mm

    shapes = chip_smoke.k4_shapes(tgraph.compile_graph(deploy_cfg(1.0)), 8, 640)
    assert len(shapes) == 41
    for m, k, n in shapes + list(K4B_SHAPES):
        least = 3 * sms // 4 if k >= 1024 else sms
        bm, bn = int8_mm.pick_tile(m, k, n, sms)
        assert (bm, bn) in int8_mm.TILES and n % bn == 0
        tiles = -(-m // bm) * (n // bn)
        bigger = int8_mm.TILES[:int8_mm.TILES.index((bm, bn))]
        assert all(-(-m // a) * (n // b) < least for a, b in bigger), (m, n)
        assert tiles >= least or (bm, bn) == int8_mm.TILES[-1], (m, n)
        assert tiles >= sms or tiles <= int8_mm.CTAS_PER_SM * sms, (m, n)
    # the 20 px convs (M = 3200), 50-200 tiles at 128 x 128: a tile for at
    # least three quarters of the SMs, all in one wave
    small = [(m, k, n) for m, k, n in shapes if m == 3200]
    assert len(small) == 14
    for m, k, n in small:
        bm, bn = int8_mm.pick_tile(m, k, n, sms)
        assert 3 * sms // 4 <= -(-m // bm) * (n // bn) <= int8_mm.CTAS_PER_SM * sms, (m, n)


@pytest.mark.parametrize("thr", [0.45, 0.5, 0.65, 0.3, 0.0, 1.0, 1e-30])
def test_keep_mask_threshold_test_without_division(thr):
    """The keep-mask kernel decides IoU > thr as inter > mid * d (or >= where
    mid rounds up), mid the midpoint between thr and the next float up,
    in exact double products, instead of rounding inter / d. A numpy model
    of that test equals float32 division and comparison: at the threshold,
    one float either side of it, and away from it."""
    rng = np.random.default_rng(int(thr * 1000) + 1)
    t = np.float32(thr)
    up = np.nextafter(t, np.float32(np.inf))
    mid = 0.5 * (np.float64(t) + np.float64(up))
    mid_up = np.float32(mid) != t
    n = 200_000
    d = rng.uniform(1, 1e6, n).astype(np.float32)
    at = (np.float64(t) * d.astype(np.float64)).astype(np.float32)
    for inter in (at, np.nextafter(at, np.float32(np.inf)), np.nextafter(at, np.float32(0)),
                  (at * (1 + rng.normal(0, 1e-6, n))).astype(np.float32),
                  rng.uniform(0, 1e6, n).astype(np.float32)):
        inter = np.maximum(inter, np.float32(0))
        x, md = inter.astype(np.float64), mid * d.astype(np.float64)
        got = (x >= md) if mid_up else (x > md)
        np.testing.assert_array_equal(got, (inter / d) > t)


# ----------------------------------------------------------------- K1L ---

def _large_k_model(boxes, valid, thr, cluster=8, warps=8, seed=0, prefetch=None,
                   reads=None):
    """A numpy model of the large-K keep-mask (csrc/nms_keep.cu, K1L) for
    one image.

    Mask kernel: the upper-triangular 64 x 64 tiles (rb, cb), cb >= rb, in
    the packed order of `nms_keep.large_tile_index`; word t of a tile is row
    64 rb + t, bit c is IoU(i, p) > thr for p = 64 cb + c > i with row and
    column valid. A tile with no valid row or no valid column is skipped:
    reading it fails the model.

    Scan: word j of `removed` (the invalid boxes and the bits past K to
    start) belongs to warp (j // cluster) % warps of CTA j % cluster. Each
    warp runs as its own coroutine, interleaved at random, and waits where
    the kernel waits on a block's barrier. The owner of w + 1, on kept_w, ORs tile
    (w, w + 1)'s kept rows, resolves block w + 1 and publishes it; then every later word it owns ORs tile (w, j). Asserted as
    it runs: every block < w has been ORed into word w before w resolves.

    Ring: block v's slot holds the tiles of the warp's first `prefetch`
    words at or after v (all of them if None); a later word reads its tile
    from device memory. Asserted: the critical path's tiles, (w, w + 1)
    and (w + 1, w + 1), are always in the ring. `reads`, if given, counts
    the tile reads from each ("ring", "global")."""
    k = len(boxes)
    nw = -(-k // 64)
    full = (1 << 64) - 1
    vpad = np.zeros(64 * nw, bool)
    vpad[:k] = valid
    vword = [int.from_bytes(np.packbits(vpad[64 * j:64 * j + 64], bitorder="little").tobytes(),
                            "little") for j in range(nw)]
    iou = np.zeros((64 * nw, 64 * nw), np.float32)
    iou[:k, :k] = box_iou(torch.from_numpy(boxes), torch.from_numpy(boxes)).numpy()
    sup = (iou > thr) & np.triu(np.ones_like(vpad[:, None] & vpad), 1) & vpad[:, None] & vpad
    words = np.packbits(sup.reshape(64 * nw, nw, 64), axis=-1,
                        bitorder="little").view("<u8")[..., 0]
    workspace = [None] * nms_keep.large_tiles(k)
    for rb in range(nw):
        for cb in range(rb, nw):
            if vword[rb] and vword[cb]:
                workspace[nms_keep.large_tile_index(rb, cb, k)] = [
                    int(x) for x in words[64 * rb:64 * rb + 64, cb]]

    def tile(rb, cb, critical=False):
        t = workspace[nms_keep.large_tile_index(rb, cb, k)]
        assert t is not None, f"the scan read tile ({rb}, {cb}), which was skipped"
        # the owner's words are cb - cluster * warps * i; block rb's slot
        # starts at its first word >= rb
        first = cb - (cb - rb) // (cluster * warps) * cluster * warps
        where = ("ring" if prefetch is None or (cb - first) // (cluster * warps) < prefetch
                 else "global")
        assert where == "ring" or not critical, f"tile ({rb}, {cb}) is not in the ring"
        if reads is not None:
            reads[where] = reads.get(where, 0) + 1
        return t

    nwe = max((j + 1 for j in range(nw) if vword[j]), default=0)
    removed = [full ^ vword[j] for j in range(nw)]
    applied = [set() for _ in range(nw)]
    kept = {}   # block -> kept bits, once published

    def resolve(w):
        assert applied[w] == set(range(w)), (w, sorted(applied[w]))
        r, live = removed[w], full ^ removed[w]
        while live:
            t = (live & -live).bit_length() - 1
            r |= tile(w, w, critical=True)[t]
            live = (full ^ r) & (full << (t + 1))
        removed[w] = r
        kept[w] = full ^ r

    def apply(w, j, kw):
        if kw and vword[j]:
            rows = tile(w, j, critical=j == w + 1)
            for t in range(64):
                if (kw >> t) & 1:
                    removed[j] |= rows[t]
        applied[j].add(w)

    def warp(r, g):
        mine = [j for j in range(nwe) if j % cluster == r and (j // cluster) % warps == g]
        if mine and mine[0] == 0:
            resolve(0)
        for w in range(mine[-1] if mine else 0):
            while w not in kept:
                yield
            for j in mine:
                if j > w:
                    apply(w, j, kept[w])
                    if j == w + 1:
                        resolve(j)

    rng = np.random.default_rng(seed)
    running = [warp(r, g) for r in range(cluster) for g in range(warps)]
    while running:
        i = int(rng.integers(len(running)))
        try:
            next(running[i])
        except StopIteration:
            running.pop(i)
    assert sorted(kept) == list(range(nwe))
    return np.array([not (removed[p // 64] >> (p % 64)) & 1 for p in range(k)])


def _jax_tiled(boxes, valid, thr):
    """The JAX package's tiled keep-mask (`_nms_tail` above 1024), invalid
    rows zeroed first as `_nms_tail` zeroes them."""
    boxes = np.where(valid[..., None], boxes, np.float32(0))
    return np.stack([np.asarray(jnms.nms_keep_mask(jnp.asarray(b), thr)) & v
                     for b, v in zip(boxes, valid)])


@pytest.mark.parametrize("case,k", [("chain", 1025), ("chain", 1300), ("chain", 65),
                                    ("clusters", 1089), ("clusters", 130),
                                    ("invalid", 1100), ("ties", 1030),
                                    ("chain_boxes", 1025)])
def test_large_k_keep_mask_model_matches_plain_and_jax_tiled(case, k):
    """K1L's algorithm (64-bit words, the packed upper-triangular tiles
    with the skipped ones never read, the owners' lookahead scan, invalid
    boxes starting removed, the scan cut at the last valid box) equals the
    plain version and the JAX package's tiled keep-mask on deep chains
    (with class offsets), clusters, ragged K (not a multiple of 64), rows
    with no valid box and exact duplicates."""
    rng = np.random.default_rng(k)
    if case == "chain":
        boxes = np.stack([nms_chain(k), nms_chain(k, 79 * 4096.0)])
        valid = np.ones((2, k), bool)
        valid[1, k // 3:] = False
    elif case == "chain_boxes":   # chip_smoke.py's K1L input
        import chip_smoke

        boxes = chip_smoke.chain_boxes(rng, 2, k)
        valid = np.arange(k)[None] < np.array([[k], [k - 300]])
    elif case == "ties":
        base = _clustered(rng, k // 2, nc=2, sigma=8.0)
        boxes = np.stack([np.concatenate([base, base[::-1]])] * 2)
        valid = np.ones((2, k), bool)
    else:
        boxes = np.stack([_clustered(rng, k, nc=3, sigma=8.0) for _ in range(3)])
        valid = rng.uniform(size=(3, k)) < 0.8
        if case == "invalid":
            valid[0] = False
            valid[2, : k // 2] = False
    got = np.stack([_large_k_model(b, v, 0.45) for b, v in zip(boxes, valid)])
    plain = nms_keep.nms_keep_mask_plain(torch.from_numpy(boxes), torch.from_numpy(valid),
                                         0.45)
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(got, _jax_tiled(boxes, valid, 0.45))
    if case == "chain":
        assert got[0].tolist() == [i % 2 == 0 for i in range(k)]


@pytest.mark.parametrize("case,k,cluster", [
    ("chain", 1100, 8), ("chain", 1100, 16), ("clusters", 1089, 16),
    ("prefix", 1300, 8), ("prefix", 1300, 16), ("holes", 1500, 8), ("holes", 1500, 16)])
def test_large_k_model_owners_and_skipped_tiles(case, k, cluster):
    """K1L's model with 8 and 16 owner CTAs, at K whose word count is not a
    multiple of the cluster (K = 1100, 1089: 18 and 18 words; 1300: 21;
    1500: 24, a multiple of 8 but not of 16), on valid boxes that stop in
    the middle of a tile (the score-sorted prefix that `_nms_tail` gives)
    and on whole 64-row tiles with no valid box in the middle (their tiles
    skipped by the mask kernel): equal to the plain version and the JAX
    package's tiled keep-mask, for several interleavings of the warps."""
    rng = np.random.default_rng(k + cluster)
    if case == "chain":
        boxes = np.stack([nms_chain(k), nms_chain(k, 79 * 4096.0)])
        valid = np.ones((2, k), bool)
        valid[1, 64 * 9 + 17:] = False
    else:
        boxes = np.stack([_clustered(rng, k, nc=3, sigma=8.0) for _ in range(2)])
        valid = np.ones((2, k), bool)
        if case == "clusters":
            valid = rng.uniform(size=(2, k)) < 0.8
        elif case == "prefix":
            valid[0, 64 * 7 + 23:] = False
            valid[1, 64 * 15 + 40:] = False
        else:   # holes: tiles 2-4 and 9 of image 0, tile 0 of image 1, invalid
            valid[0, 64 * 2:64 * 5] = False
            valid[0, 64 * 9:64 * 10] = False
            valid[0, 64 * 20 + 5:] = False
            valid[1, :64] = False
    plain = nms_keep.nms_keep_mask_plain(torch.from_numpy(boxes), torch.from_numpy(valid),
                                         0.45).numpy()
    for seed in range(2):
        got = np.stack([_large_k_model(b, v, 0.45, cluster=cluster, seed=seed)
                        for b, v in zip(boxes, valid)])
        np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(plain, _jax_tiled(boxes, valid, 0.45))
    if case == "chain":
        assert got[0].tolist() == [i % 2 == 0 for i in range(k)]


@pytest.mark.parametrize("case,prefetch", [("chain", 1), ("clusters", 1),
                                           ("clusters", 2), ("prefix", 1)])
def test_large_k_model_ring_shorter_than_the_words(case, prefetch):
    """K1L's model where a warp's ring holds fewer tiles a block than it has
    words (the scan above K = 32768: later words read their tiles from
    device memory), scaled down to a cluster of 2 CTAs of 2 warps, 5-6
    words a warp: the critical path's tiles still come from the ring, some
    tiles come from device memory, and the mask equals the plain version's
    and the JAX package's tiled keep-mask."""
    k = 1300
    rng = np.random.default_rng(prefetch)
    if case == "chain":
        boxes = np.stack([nms_chain(k), nms_chain(k, 79 * 4096.0)])
    else:
        boxes = np.stack([_clustered(rng, k, nc=3, sigma=8.0) for _ in range(2)])
    valid = np.ones((2, k), bool)
    if case == "clusters":
        valid = rng.uniform(size=(2, k)) < 0.8
    elif case == "prefix":
        valid[0, 64 * 13 + 23:] = False
        valid[1, 64 * 4:64 * 6] = False
    plain = nms_keep.nms_keep_mask_plain(torch.from_numpy(boxes), torch.from_numpy(valid),
                                         0.45).numpy()
    reads = {}
    got = np.stack([_large_k_model(b, v, 0.45, cluster=2, warps=2, prefetch=prefetch,
                                   reads=reads) for b, v in zip(boxes, valid)])
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(plain, _jax_tiled(boxes, valid, 0.45))
    assert reads["ring"] > 0 and reads["global"] > 0, reads


@pytest.mark.parametrize("k", [1, 63, 64, 65, 1025, 4096, 8192, 8193])
def test_large_tile_index_is_a_bijection(k):
    """The packed order of K1L's tiles maps the upper triangle (rb <= cb)
    one to one onto range(nw (nw + 1) / 2), row block by row block, and the
    workspace holds B of those 512-byte tiles: 33.8 MB at B = 8, K = 8192
    (the (B, K, nw) layout before it was 67.1 MB)."""
    nw = -(-k // 64)
    idx = [nms_keep.large_tile_index(rb, cb, k) for rb in range(nw) for cb in range(rb, nw)]
    assert idx == list(range(nw * (nw + 1) // 2)) == list(range(nms_keep.large_tiles(k)))
    for b in (1, 8):
        assert nms_keep.large_workspace_bytes(b, k) == b * nw * (nw + 1) // 2 * 512
    if nw > 1:
        with pytest.raises(ValueError):
            nms_keep.large_tile_index(1, 0, k)
    if k == 8192:
        assert nms_keep.large_workspace_bytes(8, k) == 33_816_576
        assert 8 * k * nw * 8 == 67_108_864


def test_keep_mask_routes_by_k_and_device():
    """On the CPU both wrappers take the plain version at every K and count
    no launch; the plain version stops its matrices at the batch's last
    valid box and still matches the whole fixpoint."""
    rng = np.random.default_rng(1)
    boxes = torch.from_numpy(np.stack([_clustered(rng, 1200, nc=2) for _ in range(2)]))
    valid = torch.from_numpy(rng.uniform(size=(2, 1200)) < 0.9)
    valid[:, 700:] = False
    before = (nms_keep.nms_keep_mask.launches, nms_keep.nms_keep_mask_large.launches)
    got = nms_keep.nms_keep_mask(boxes, valid, 0.45)
    assert torch.equal(got, nms_keep.nms_keep_mask_large(boxes, valid, 0.45))
    assert before == (nms_keep.nms_keep_mask.launches,
                      nms_keep.nms_keep_mask_large.launches)
    assert not got[:, 700:].any()
    np.testing.assert_array_equal(got.numpy(), _jax_full(boxes.numpy(), valid.numpy(), 0.45))
    none = nms_keep.nms_keep_mask(boxes, torch.zeros_like(valid), 0.45)
    assert not none.any()
