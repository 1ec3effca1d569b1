"""The port's serving path against the JAX package on the CPU:
`fused_head_nms` on the same features, `ServingEngine` against the JAX
engine with its Pallas-stem and Pallas-ELAN transforms on, and the
`DynamicBatcher` contract, mapping and shutdown cases of tests/test_infer.py."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import feature_error, image_rows, match_fraction
from tests._torch_port_util import deploy_cfg, jax_model
from yolo_series_tpu.models import reparam as jreparam
from yolo_series_tpu.ops import nms as jnms
from yolo_series_tpu_torch.infer.serving import DynamicBatcher, ServingEngine
from yolo_series_tpu_torch.models import graph as tgraph
from yolo_series_tpu_torch.models.model import apply_model
from yolo_series_tpu_torch.models import reparam as treparam
from yolo_series_tpu_torch.models.convert import from_jax_params
from yolo_series_tpu_torch.ops import fused_elan, fused_stem, nms_keep
from yolo_series_tpu_torch.ops import nms as tnms

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    """Width-0.5 deploy yolov7, fused, in both packages, same weights."""
    plan, params, state = jax_model(0.5, seed=1)
    jp, js = jreparam.fuse_model(plan, jax.tree_util.tree_map(jnp.asarray, params),
                                 jax.tree_util.tree_map(jnp.asarray, state))
    tplan = tgraph.compile_graph(deploy_cfg(0.5))
    tp, ts = treparam.fuse_model(tplan, *from_jax_params(tplan, params, state))
    return plan, jp, js, tplan, tp, ts


def _feats(rng, head, size, const=False):
    out = []
    for c, s in zip(head.ch, head.strides):
        n = int(size / s)
        f = rng.normal(0, 1.0, (2, n, n, c)).astype(np.float32)
        if const:  # every cell equal: every anchor of a level ties
            f[:] = f[:, :1, :1]
        out.append(f)
    return out


@pytest.mark.parametrize("const", [False, True])
def test_fused_head_nms_matches_jax(models, const):
    """Same numpy features, fp32: num_dets and classes equal, boxes and
    scores to 1e-5 (fp32 sigmoid/exp of two libraries). With const=True
    every anchor of a level ties in score: the stable sort must keep the
    lower index first, as jax.lax.top_k does."""
    plan, jp, _, tplan, tp, _ = models
    feats = _feats(np.random.default_rng(int(const)), plan.head, 128, const)
    kw = dict(conf_thres=0.25, iou_thres=0.45, max_det=300, max_nms=256)
    want = jnms.fused_head_nms(plan.head, jp["layers"][-1],
                               [jnp.asarray(f) for f in feats],
                               compute_dtype=jnp.float32, **kw)
    got = tnms.fused_head_nms(tplan.head, tp["layers"][-1],
                              [torch.from_numpy(f) for f in feats],
                              compute_dtype=torch.float32, **kw)
    num = np.asarray(want[0])
    assert num.max() > 5, num
    np.testing.assert_array_equal(got.num_dets.numpy(), num)
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-5 * 128)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want[2]),
                               rtol=1e-5, atol=1e-5)


def test_serving_engine_matches_jax(models, monkeypatch):
    """Both engines at 128 px, batch 2, fp32 working dtype, with every
    kernel-backed transform on; the JAX side runs its Pallas stem and ELAN
    kernels in interpret mode, which round to bf16 where the port's plain
    versions do. The sums still run in another order, so a bf16 rounding
    may flip; over ~50 fused stages that comes to ~1% RMS at the head
    inputs (measured): they must agree to 3%. Detections are random boxes
    packed densely in score, where such changes reorder greedy NMS now and
    then: compare matched detections (same class, IoU >= 0.5, score within
    0.1), >= 90% of each image's both ways (0.98 measured)."""
    monkeypatch.setenv("YOLO_TPU_PALLAS_STEM", "1")
    monkeypatch.setenv("YOLO_TPU_PALLAS_ELAN", "1")
    monkeypatch.setenv("YOLO_TPU_PALLAS_INTERPRET", "1")
    from yolo_series_tpu.infer.serving import ServingEngine as JaxEngine
    from yolo_series_tpu.models.model import apply_model as japply

    plan, jp, js, tplan, tp, ts = models
    kw = dict(batch_size=2, img_size=128, max_det=100, max_nms=512)
    jeng = JaxEngine(plan, jp, js, dtype=jnp.float32, **kw)
    teng = ServingEngine(tplan, tp, ts, dtype=torch.float32, device="cpu", **kw)
    names = [type(layer.block).__name__ for layer in teng.plan.layers]
    assert names.count("FusedStem") == 1 and names.count("FusedELAN") == 8
    assert [type(la.block).__name__ for la in jeng.plan.layers] == names
    x = np.random.default_rng(4).integers(0, 255, (2, 128, 128, 3), np.uint8)
    launches = (nms_keep.nms_keep_mask.launches, fused_stem.fused_stem.launches,
                fused_elan.fused_elan.launches)
    want = jeng.infer(x)
    got = teng.infer(x)
    # the CPU runs the plain versions: no kernel launch is counted
    assert launches == (nms_keep.nms_keep_mask.launches,
                        fused_stem.fused_stem.launches,
                        fused_elan.fused_elan.launches)
    assert set(got) == {"num_dets", "det_boxes", "det_scores", "det_classes"}
    assert got["num_dets"].shape == (2, 1) and got["det_boxes"].shape == (2, 100, 4)

    xf = x.astype(np.float32) / 255.0
    jfeats, _ = japply(jeng.plan, jeng._params, jeng._state, jnp.asarray(xf),
                       return_head_inputs=True)
    with torch.inference_mode():
        tfeats, _ = apply_model(teng.plan, teng._params, teng._state,
                                torch.from_numpy(xf), return_head_inputs=True)
    assert feature_error(tfeats, [torch.from_numpy(np.array(f)) for f in jfeats]) < 0.03
    for i in range(2):
        a, b = image_rows(got, i), image_rows(want, i)
        assert len(b["scores"]) > 5
        assert abs(len(a["scores"]) - len(b["scores"])) <= 0.1 * len(b["scores"]) + 1
        assert match_fraction(a, b) >= 0.9
        assert match_fraction(b, a) >= 0.9


@pytest.fixture(scope="module")
def small_engine(models):
    """Port engine at 64 px, batch 4 (plus a batch-1 engine) for the
    batcher's host-side contract."""
    _, _, _, tplan, tp, ts = models
    kw = dict(img_size=64, max_det=20, dtype=torch.float32, device="cpu")
    return (ServingEngine(tplan, tp, ts, batch_size=4, **kw),
            ServingEngine(tplan, tp, ts, batch_size=1, **kw),
            ServingEngine(tplan, tp, ts, batch_size=2, pack_output=True, **kw))


def _frames(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (64, 64, 3), dtype=np.uint8) for _ in range(n)]


def test_engine_partial_batch_and_packed_output(small_engine):
    eng, _, packed = small_engine
    x = np.stack(_frames(0, 2))
    full = eng.infer(np.concatenate([x, x]))
    part = eng.infer(x[:1])
    assert part["det_boxes"].shape == (1, 20, 4)
    np.testing.assert_allclose(part["det_boxes"], full["det_boxes"][:1], atol=1e-3)
    p = packed.infer(x)
    assert p["num_dets"].dtype == np.int32 and p["det_classes"].dtype == np.int32
    np.testing.assert_array_equal(p["num_dets"], full["num_dets"][:2])
    np.testing.assert_allclose(p["det_boxes"], full["det_boxes"][:2], atol=1e-3)
    with pytest.raises(ValueError):
        packed.infer(np.stack(_frames(1, 3)))


def test_dynamic_batcher(small_engine):
    eng, _, _ = small_engine
    batcher = DynamicBatcher(eng, max_delay_ms=20)
    slots = [batcher.submit(f) for f in _frames(1, 6)]
    for s in slots:
        res = DynamicBatcher.wait(s, timeout=60)
        assert res is not None and res["det_boxes"].shape == (20, 4)
    batcher.close()


def test_dynamic_batcher_low_latency_bs1(small_engine):
    """A lone request on an idle batcher dispatches at once on the bs1
    engine instead of waiting max_delay_ms for co-batching."""
    eng, eng1, _ = small_engine
    batcher = DynamicBatcher(eng, max_delay_ms=2000, bs1_engine=eng1)
    t0 = time.perf_counter()
    for f in _frames(3, 3):
        res = DynamicBatcher.wait(batcher.submit(f), timeout=60)
        want = eng1.infer(f[None])
        assert int(res["num_dets"][0]) == int(want["num_dets"][0, 0])
        np.testing.assert_allclose(res["det_boxes"], want["det_boxes"][0], atol=1e-3)
    elapsed = time.perf_counter() - t0
    batcher.close()
    assert elapsed < 4.0, f"{elapsed:.1f}s for 3 lone requests"


def test_dynamic_batcher_concurrent_mapping(small_engine):
    """16 client threads: every client gets the detections for its own
    frame, equal to a direct single-image engine call."""
    eng, _, _ = small_engine
    batcher = DynamicBatcher(eng, max_delay_ms=10)
    frames = _frames(7, 16)
    expected = [eng.infer(f[None]) for f in frames]
    results = [None] * 16

    def client(i):
        results[i] = DynamicBatcher.wait(batcher.submit(frames[i]), timeout=120)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    batcher.close()
    for i in range(16):
        assert results[i] is not None, i
        np.testing.assert_array_equal(results[i]["num_dets"],
                                      expected[i]["num_dets"][0])
        np.testing.assert_allclose(results[i]["det_boxes"],
                                   expected[i]["det_boxes"][0], atol=1e-3)


def test_dynamic_batcher_close_wakes_stranded(small_engine):
    """close() ends the pipeline promptly and wakes every waiter; requests
    stranded in the queues resolve with result None."""
    eng, _, _ = small_engine

    def slow_stage(frames):  # pile up undispatched submissions
        time.sleep(0.25)
        return np.stack(frames)

    batcher = DynamicBatcher(eng, max_delay_ms=1, inflight=1,
                             stage_fn=slow_stage, completers=1)
    slots = [batcher.submit(f) for f in _frames(0, 12)]
    time.sleep(0.2)
    t0 = time.perf_counter()
    batcher.close()
    assert time.perf_counter() - t0 < 15, "close() wedged"
    for i, s in enumerate(slots):
        assert s["event"].wait(5), f"waiter {i} left hanging across close()"
        if s["result"] is not None:
            assert s["result"]["det_boxes"].shape == (20, 4)
    assert not batcher.worker.is_alive()
    assert not any(t.is_alive() for t in batcher.completer_pool)


def test_serving_engine_ingest_hw_matches_jax(models, monkeypatch):
    """ingest_hw: raw (B, h, w, 3) camera frames letterboxed on the device,
    boxes back in source pixels. Against the JAX engine with the same
    ingest_hw (fp32, Pallas kernels interpreted, as above): detections
    match as in test_serving_engine_matches_jax, and every box lies inside
    the source frame. The port's ingest engine also equals its own
    letterbox + the plain engine + the rescale."""
    monkeypatch.setenv("YOLO_TPU_PALLAS_STEM", "1")
    monkeypatch.setenv("YOLO_TPU_PALLAS_ELAN", "1")
    monkeypatch.setenv("YOLO_TPU_PALLAS_INTERPRET", "1")
    from yolo_series_tpu.infer.serving import ServingEngine as JaxEngine
    from yolo_series_tpu_torch.data.device_aug import make_device_letterbox

    plan, jp, js, tplan, tp, ts = models
    hw = (96, 200)
    kw = dict(batch_size=2, img_size=128, max_det=100, max_nms=512)
    jeng = JaxEngine(plan, jp, js, dtype=jnp.float32, ingest_hw=hw, **kw)
    teng = ServingEngine(tplan, tp, ts, dtype=torch.float32, device="cpu",
                         ingest_hw=hw, **kw)
    assert teng.in_shape == (2, *hw, 3)
    x = np.random.default_rng(6).integers(0, 255, (2, *hw, 3), np.uint8)
    want, got = jeng.infer(x), teng.infer(x)
    for i in range(2):
        a, b = image_rows(got, i), image_rows(want, i)
        assert len(b["scores"]) > 5
        assert match_fraction(a, b) >= 0.9 and match_fraction(b, a) >= 0.9
        assert (a["boxes"] >= 0).all()
        assert (a["boxes"][:, [0, 2]] <= hw[1]).all() and (a["boxes"][:, [1, 3]] <= hw[0]).all()

    plain = ServingEngine(tplan, tp, ts, dtype=torch.float32, device="cpu", **kw)
    lb, (r, _), (dw, dh) = make_device_letterbox(hw, 128)
    ref = plain.infer(lb(torch.from_numpy(x)).numpy())
    np.testing.assert_array_equal(got["num_dets"], ref["num_dets"])
    np.testing.assert_array_equal(got["det_classes"], ref["det_classes"])
    back = np.clip((ref["det_boxes"] - np.float32([dw, dh, dw, dh])) / np.float32(r), 0,
                   np.float32([hw[1], hw[0], hw[1], hw[0]]))
    np.testing.assert_allclose(got["det_boxes"], back, rtol=1e-6, atol=1e-4)
    with pytest.raises(ValueError, match="takes"):
        teng.infer(np.zeros((2, 128, 128, 3), np.uint8))


def test_engine_counts_forwards_and_stays_eager_on_cpu(small_engine):
    """On the CPU the engine runs end2end eagerly: no graph, no replay;
    `batches` counts the forwards that `infer` dispatched."""
    eng = small_engine[0]
    before = eng.batches
    eng.capture()
    eng.infer(np.stack(_frames(3, 2)))
    assert eng.batches == before + 1 and eng.replays == 0 and not eng.captured
