"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc: it is marked `cuda` and skips
without a card. On a machine with one (and no jax), run

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

`--noconftest` skips tests/conftest.py, which configures jax. This file
imports no jax.
"""

import gc

import numpy as np
import pytest
import torch

from yolo_series_tpu_torch.infer import quant
from yolo_series_tpu_torch.ops import conv_silu
from yolo_series_tpu_torch.ops import fused_elan as fe
from yolo_series_tpu_torch.ops import fused_stem as fs
from yolo_series_tpu_torch.ops import int8_mm, nms_keep
from yolo_series_tpu_torch.ops.boxes import box_iou

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def _boxes_with_classes(rng, b, k, nc=80, spread=640.0):
    """Score-sorted xyxy boxes in overlapping clusters, shifted by
    class * 4096 as `_nms_tail` shifts them (coordinates up to ~3.3e5)."""
    centers = rng.uniform(50, spread - 50, (b, max(k // 16, 1), 2))
    idx = rng.integers(0, centers.shape[1], (b, k))
    cxy = np.take_along_axis(centers, idx[..., None], 1) + rng.normal(0, 6, (b, k, 2))
    wh = rng.uniform(20, 90, (b, k, 2))
    cls = rng.integers(0, nc, (b, k, 1)).astype(np.float32)
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1) + cls * 4096.0
    return boxes.astype(np.float32)


@pytest.mark.parametrize("k", [1024, 256, 37])
def test_nms_keep_kernel_equals_plain(cuda, k):
    rng = np.random.default_rng(k)
    boxes = torch.from_numpy(_boxes_with_classes(rng, 4, k, nc=3)).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=(4, k)) < 0.9).to(cuda)
    before = nms_keep.nms_keep_mask.launches
    got = nms_keep.nms_keep_mask(boxes, valid, 0.45)
    torch.cuda.synchronize()
    assert nms_keep.nms_keep_mask.launches == before + 1
    want = nms_keep.nms_keep_mask_plain(boxes, valid, 0.45)
    assert torch.equal(got, want)


def nms_chain(k, offset=0.0):
    """One suppression chain of k boxes: each overlaps the next at IoU 0.54
    and the one after at 0.25, so greedy keeps every other box and the
    fixpoint needs k passes. (As tests/_torch_port_util.py's: this file
    imports nothing from the tests directory, so that it runs on its own
    on a machine with a card.)"""
    x0 = np.arange(k, dtype=np.float64) * 18.0
    b = np.stack([x0, np.full(k, 100.0), x0 + 60.0, np.full(k, 160.0)], -1)
    return (b + offset).astype(np.float32)


def _nms_case(name, rng, k):
    """(boxes (B, K, 4), valid (B, K)) of one kernel edge case."""
    if name == "clusters":
        return _boxes_with_classes(rng, 4, k, nc=3), rng.uniform(size=(4, k)) < 0.9
    if name == "all_invalid_rows":
        valid = rng.uniform(size=(4, k)) < 0.7
        valid[1] = False
        valid[3] = False
        return _boxes_with_classes(rng, 4, k, nc=2), valid
    if name == "chain":
        return nms_chain(k)[None], np.ones((1, k), bool)
    if name == "ties":
        base = _boxes_with_classes(rng, 1, k // 2, nc=2)[0]
        boxes = np.concatenate([base, base[::-1]])[None]      # every box twice
        return np.concatenate([boxes, boxes[:, ::-1]]), np.ones((2, k), bool)
    # class offsets: coordinates near 3.3e5, a chain and clusters
    boxes = np.stack([nms_chain(k, 79 * 4096.0), _boxes_with_classes(rng, 1, k, nc=1)[0]
                      + np.float32(79 * 4096.0)])
    return boxes, rng.uniform(size=(2, k)) < 0.95


NMS_CASES = ([("clusters", k) for k in (1, 31, 33, 256, 1000, 1024)]
             + [("all_invalid_rows", 100), ("all_invalid_rows", 1024),
                ("chain", 1024), ("chain", 33), ("ties", 1024), ("ties", 64),
                ("far_coords", 1024), ("far_coords", 300)])


@pytest.mark.parametrize("name,k", NMS_CASES, ids=[f"{n}_{k}" for n, k in NMS_CASES])
def test_nms_keep_kernel_edges_equal_plain(cuda, name, k):
    """The bitmask + word-scan kernel at its edges: K not a multiple of 32
    (1, 31, 33, 1000), a whole word of boxes and the largest K, rows with
    no valid box, a 1024-long suppression chain, exact duplicates, and
    coordinates near 3.3e5; bit-equal to the plain version."""
    rng = np.random.default_rng(k)
    boxes, valid = _nms_case(name, rng, k)
    boxes, valid = torch.from_numpy(boxes).to(cuda), torch.from_numpy(valid).to(cuda)
    before = nms_keep.nms_keep_mask.launches
    got = nms_keep.nms_keep_mask(boxes, valid, 0.45)
    torch.cuda.synchronize()
    assert nms_keep.nms_keep_mask.launches == before + 1
    want = nms_keep.nms_keep_mask_plain(boxes, valid, 0.45)
    assert torch.equal(got, want)
    if name == "chain":   # every other box kept
        assert got[0].tolist() == [i % 2 == 0 for i in range(k)]


def test_nms_keep_kernel_rejects_large_k(cuda):
    """K1's own entry point takes K <= 1024 only; the wrapper sends larger K
    to K1L (counted there, not as a K1 launch)."""
    boxes = torch.zeros((1, 1025, 4), device=cuda)
    valid = torch.ones((1, 1025), dtype=torch.bool, device=cuda)
    keep = torch.empty_like(valid)
    err = nms_keep._entry()(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), 1, 1025,
                            0.45, nms_keep._build.stream_ptr())
    assert err != 0
    before = (nms_keep.nms_keep_mask.launches, nms_keep.nms_keep_mask_large.launches)
    nms_keep.nms_keep_mask(boxes, valid, 0.45)
    assert (nms_keep.nms_keep_mask.launches, nms_keep.nms_keep_mask_large.launches) == \
        (before[0], before[1] + 1)


def _chain_groups(rng, b, k, nc=80):
    """chip_smoke.chain_boxes' layout (half the boxes in overlapping
    64-long chains, half in clusters, class offsets), without importing
    the script."""
    out = np.zeros((b, k, 4), np.float32)
    for i in range(b):
        n = k // 2
        w = rng.uniform(40, 80)
        j = np.arange(n)
        x0 = 20 + (j % 64) * 0.3 * w + 40 * (j // 64)
        y0 = rng.uniform(20, 500) + 0 * j
        chain = np.stack([x0, y0, x0 + w, y0 + w], -1)
        rand = _boxes_with_classes(rng, 1, k - n, nc=nc)[0] - 0.0
        cls = rng.integers(0, nc)
        out[i] = np.concatenate([chain + cls * 4096.0, rand])
    return out


def _large_case(name, rng, b, k):
    if name == "chain":          # one k-deep chain an image
        return np.stack([nms_chain(k, 4096.0 * i) for i in range(b)]), np.ones((b, k), bool)
    if name == "chain_groups":
        return _chain_groups(rng, b, k), rng.uniform(size=(b, k)) < 0.95
    if name == "all_invalid_rows":
        valid = rng.uniform(size=(b, k)) < 0.7
        valid[::2] = False
        return _boxes_with_classes(rng, b, k, nc=2), valid
    if name == "tile_holes":     # whole 64-row tiles with no valid box; ends mid-tile
        valid = rng.uniform(size=(b, k)) < 0.9
        valid[:, 64 * 3:64 * 6] = False
        valid[::2, 64 * 20:64 * 21] = False
        valid[1::2, :64] = False
        valid[:, k - 64 * 5 - 17:] = False
        return _boxes_with_classes(rng, b, k, nc=3), valid
    if name == "threshold_ties":  # pairs at IoU exactly 0.5, and duplicates
        x = rng.uniform(0, 600, (b, k // 2, 1)).astype(np.float32)
        y = rng.uniform(0, 600, (b, k // 2, 1)).astype(np.float32)
        full = np.concatenate([x, y, x + 10, y + 10], -1)
        half = np.concatenate([x, y, x + 10, y + 5], -1)
        boxes = np.stack([full, half], 2).reshape(b, -1, 4)
        boxes = np.concatenate([boxes, boxes[:, : k - boxes.shape[1]]], 1)
        return boxes, np.ones((b, k), bool)
    return _boxes_with_classes(rng, b, k, nc=3), rng.uniform(size=(b, k)) < 0.9


LARGE_CASES = ([("chain", 1, k) for k in (1025, 2047, 4096)]
               + [("chain_groups", b, k) for b in (1, 8) for k in (1025, 4096, 8192)]
               + [("clusters", 8, 2047), ("clusters", 1, 8192),
                  ("all_invalid_rows", 8, 2047), ("all_invalid_rows", 8, 8192),
                  ("threshold_ties", 8, 1025), ("threshold_ties", 1, 4096),
                  ("chain_groups", 32, 8192), ("chain_groups", 1, 32768),
                  ("tile_holes", 8, 4096), ("tile_holes", 8, 8192),
                  ("chain_groups", 1, 65536), ("tile_holes", 2, 65536),
                  ("chain_groups", 1, nms_keep.MAX_K_LARGE)])


def _plain_by_chunks(boxes, valid, thr, chunk=8192):
    """Sequential greedy NMS a chunk of boxes at a time, for K whose (K, K)
    matrices the plain version cannot hold: the boxes of a chunk that a
    kept box of an earlier chunk suppresses (`box_iou` > thr, as the plain
    version tests it) start invalid, then the plain version resolves the
    chunk."""
    b, k = valid.shape
    keep = torch.zeros_like(valid)
    for s in range(0, k, chunk):
        e = min(s + chunk, k)
        v = valid[:, s:e].clone()
        for i in range(b):
            prev = boxes[i, :s][keep[i, :s]]
            for q in range(0, len(prev), chunk):
                v[i] &= ~(box_iou(prev[q:q + chunk], boxes[i, s:e]) > thr).any(0)
        keep[:, s:e] = nms_keep.nms_keep_mask_plain(boxes[:, s:e], v, thr)
    return keep


@pytest.mark.parametrize("name,b,k", LARGE_CASES,
                         ids=[f"{n}_B{b}_K{k}" for n, b, k in LARGE_CASES])
def test_nms_keep_large_kernel_equals_plain(cuda, name, b, k):
    """K1L at K = 1025, 2047, 4096, 8192, 32768 (the largest whose scan
    prefetches every tile), 65536 and MAX_K_LARGE (384000: the scan's later
    words read their tiles from device memory), B = 1, 2, 8 and 32 (more
    clusters than the card holds at once): deep chains (one K-deep, and the
    64-long overlapping chains of chip_smoke.py), rows with no valid box,
    whole 64-row tiles with no valid box (the tiles the mask kernel skips),
    and pairs at exactly the threshold; bit-equal to the plain version, one
    K1L launch each (the threshold case at thr 0.5). Above K = 32768 the
    plain version runs a chunk at a time (`_plain_by_chunks`, itself held
    to the plain version on the first 8192 boxes, with which greedy's mask
    starts whatever follows)."""
    rng = np.random.default_rng(k + b)
    boxes, valid = _large_case(name, rng, b, k)
    thr = 0.5 if name == "threshold_ties" else 0.45
    boxes, valid = torch.from_numpy(boxes).to(cuda), torch.from_numpy(valid).to(cuda)
    before = nms_keep.nms_keep_mask_large.launches
    got = nms_keep.nms_keep_mask(boxes, valid, thr)
    torch.cuda.synchronize()
    assert nms_keep.nms_keep_mask_large.launches == before + 1
    if k > 32768:
        head = nms_keep.nms_keep_mask_plain(boxes[:, :8192], valid[:, :8192], thr)
        assert torch.equal(got[:, :8192], head)
        assert torch.equal(_plain_by_chunks(boxes[:, :8192], valid[:, :8192], thr,
                                            chunk=2048), head)
        want = _plain_by_chunks(boxes, valid, thr)
    else:
        # the plain version 8 images at a time: its (B, K, K) matrices of
        # 32 images at K = 8192 do not fit the card
        want = torch.cat([nms_keep.nms_keep_mask_plain(boxes[i:i + 8], valid[i:i + 8], thr)
                          for i in range(0, b, 8)])
    assert torch.equal(got, want)
    if name == "chain":
        assert got[0].tolist() == [i % 2 == 0 for i in range(k)]


@pytest.mark.parametrize("k", [1, 63, 64, 65, 256, 1000, 1024])
def test_nms_keep_k1_and_k1l_agree(cuda, k):
    """Where both kernels run (K <= 1024), K1 and K1L give the same mask."""
    rng = np.random.default_rng(k)
    boxes = torch.from_numpy(_boxes_with_classes(rng, 4, k, nc=3)).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=(4, k)) < 0.9).to(cuda)
    a = nms_keep.nms_keep_mask(boxes, valid, 0.45)
    b = nms_keep.nms_keep_mask_large(boxes, valid, 0.45)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_nms_keep_large_rejects_k_above_its_limit(cuda):
    """K1L takes K <= MAX_K_LARGE: the wrapper raises above it before it
    allocates, and the C entry point refuses it."""
    k = nms_keep.MAX_K_LARGE + 1
    boxes = torch.zeros((1, k, 4), device=cuda)
    valid = torch.ones((1, k), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="largest K1L takes"):
        nms_keep.nms_keep_mask_large(boxes, valid, 0.45)
    keep = torch.empty_like(valid)
    err = nms_keep._entry_large()(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                                  boxes.data_ptr(), 1, k, 0.45, nms_keep._build.stream_ptr())
    assert err != 0


def test_nms_keep_large_graph_replay_equals_eager(cuda):
    """K1L captured in a CUDA graph (its workspace allocated by torch inside
    the capture) replays to the eager call's mask, and to the new inputs'
    mask after they are copied into the captured buffers."""
    rng = np.random.default_rng(5)
    boxes = torch.from_numpy(_chain_groups(rng, 8, 4096)).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=(8, 4096)) < 0.95).to(cuda)
    eager = nms_keep.nms_keep_mask_large(boxes, valid, 0.45)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        nms_keep.nms_keep_mask_large(boxes, valid, 0.45)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = nms_keep.nms_keep_mask_large(boxes, valid, 0.45)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    boxes.copy_(torch.from_numpy(_boxes_with_classes(rng, 8, 4096, nc=3)))
    valid.copy_(torch.from_numpy(rng.uniform(size=(8, 4096)) < 0.8))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, nms_keep.nms_keep_mask_plain(boxes, valid, 0.45))
    assert not torch.equal(out, eager)


@pytest.mark.parametrize("b,k", [(8, 8192), (8, 4096), (2, 1025)])
def test_nms_keep_large_peak_memory_is_the_packed_workspace(cuda, b, k):
    """One K1L call allocates its packed workspace (33.8 MB at B = 8, K =
    8192, against the 67.1 MB of a (B, K, K / 64) layout) and the keep
    mask, nothing else. The caching allocator rounds each block up to 512
    bytes and may leave a remainder of up to 1 MiB of a fresh segment
    unsplit, so the peak is that sum, at most 1 MiB over."""
    rng = np.random.default_rng(k)
    boxes = torch.from_numpy(_chain_groups(rng, b, k)).to(cuda)
    valid = torch.ones((b, k), dtype=torch.bool, device=cuda)
    nms_keep.nms_keep_mask_large(boxes, valid, 0.45)   # built, opted in
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    keep = nms_keep.nms_keep_mask_large(boxes, valid, 0.45)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    rounded = nms_keep.large_workspace_bytes(b, k) + -(-b * k // 512) * 512
    assert rounded <= peak <= rounded + (1 << 20), (peak, rounded)
    if (b, k) == (8, 8192):
        assert nms_keep.large_workspace_bytes(b, k) == 33_816_576
    assert keep.shape == (b, k)


def test_evaluate_fp32_ignores_global_tf32(cuda):
    """`evaluate` in fp32 gives the same map50, map, mp and mr with the
    global TF32 flags on (torch's default for cuDNN) and off: it pins full
    fp32 itself."""
    import chip_smoke
    from yolo_series_tpu_torch.eval.evaluator import evaluate

    m = chip_smoke.make_model(cuda, width=0.5, img=256)
    batches = chip_smoke.eval_batches(m, batch=2, n_images=4)
    got = {}
    for tf32 in (True, False):
        with chip_smoke.global_tf32(tf32):
            got[tf32] = evaluate(m.plan, m.params, m.state, batches, device=cuda)
            assert torch.backends.cudnn.allow_tf32 == tf32
    for key in ("map50", "map", "mp", "mr"):
        assert got[True][key] == got[False][key], key
    assert 0.0 < got[False]["map50"] < 1.0


@pytest.fixture(scope="module")
def graph_engine():
    """A width-0.5 yolov7 deploy engine (batch 2, 256 px, bf16) on the card,
    with random weights made to detect (chip_smoke.liven)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    import chip_smoke
    from yolo_series_tpu_torch.infer.serving import ServingEngine

    m = chip_smoke.make_model(torch.device("cuda"), width=0.5, img=256)
    return ServingEngine(m.plan, m.params, m.state, batch_size=2, img_size=256,
                         device="cuda")


def _frames(seed, n=2, size=256):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), np.uint8)


def test_graph_engine_equals_eager(cuda, graph_engine):
    """The captured end2end replays to the eager end2end's detections bit
    for bit; a replay after new frames gives the new frames' detections."""
    eng = graph_engine
    for seed in (0, 1, 0):
        x = _frames(seed)
        got = eng.infer(x)
        with torch.inference_mode():
            want = eng.to_host(eng.end2end(torch.from_numpy(x).to(cuda)))
        assert eng.captured and eng.replays >= 1
        assert int(want["num_dets"].sum()) > 0
        for key in want:
            assert np.array_equal(got[key], want[key]), key


def test_graph_engine_outputs_survive_the_next_replay(cuda, graph_engine):
    """infer_async clones the graph's outputs: the first batch's result is
    unchanged after a second replay with other frames."""
    eng = graph_engine
    a, _ = eng.infer_async(_frames(2))
    a_host = eng.to_host(a)
    b, _ = eng.infer_async(_frames(3))
    torch.cuda.synchronize()
    for key, v in eng.to_host(a).items():
        assert np.array_equal(v, a_host[key])
    assert any(not np.array_equal(v, a_host[k]) for k, v in eng.to_host(b).items())


# cycles of torch.cuda._sleep: about 0.2 s at the H100's clocks
_LONG_SLEEP = 400_000_000


def test_graph_engine_fetch_waits_for_its_own_batch(cuda, graph_engine):
    """A fetch waits for its own batch's event and copies on the engine's
    fetch stream: it returns while a batch queued after it on the compute
    stream is still unfinished, with the arrays of a stream-wide `.cpu()`
    fetch bit for bit, and the tracer counts it as a fetch that left the
    card busy."""
    from yolo_series_tpu_torch.obs import trace

    eng = graph_engine
    eng.capture()
    trace.enable(True)
    try:
        c0 = dict(trace.snapshot()["counters"])
        a, _ = eng.infer_async(_frames(5))
        torch.cuda._sleep(_LONG_SLEEP)        # on the compute stream, before B
        b, _ = eng.infer_async(_frames(6))
        b_ready = eng._events[-1]             # B's own event
        got = eng.to_host(a)
        assert not b_ready.query()
        c1 = dict(trace.snapshot()["counters"])
        torch.cuda.synchronize()
        eng.to_host(b)
    finally:
        trace.enable(False)
    want = {k: v.cpu().numpy() for k, v in a.items()}
    for key in want:
        assert np.array_equal(got[key], want[key]), key
    fetches = c1["engine.fetches"] - c0.get("engine.fetches", 0)
    drained = c1.get("engine.fetches_drained", 0) - c0.get("engine.fetches_drained", 0)
    assert fetches == 1 and drained == 0


def test_graph_engine_fetch_falls_back_and_serves_threads(cuda, graph_engine):
    """An eager `end2end` output carries no event and takes the stream-wide
    `.cpu()`, with the graph's answers; two threads that fetch two in-flight
    outputs of one engine at once each get their own batch's answers."""
    import threading

    eng = graph_engine
    frames = [_frames(7), _frames(8)]
    want = [eng.infer(x) for x in frames]
    with torch.inference_mode():
        eager = eng.end2end(torch.from_numpy(frames[0]).to(cuda))
    assert eng._event_of(eager) is None
    for key, v in eng.to_host(eager).items():
        assert np.array_equal(v, want[0][key]), key

    torch.cuda._sleep(_LONG_SLEEP)            # both batches still in flight at the fetch
    outs = [eng.infer_async(x)[0] for x in frames]
    got = [None, None]
    start = threading.Barrier(2, timeout=30)

    def fetch(i):
        start.wait()
        got[i] = eng.to_host(outs[i])

    threads = [threading.Thread(target=fetch, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    for i in range(2):
        for key, v in want[i].items():
            assert np.array_equal(got[i][key], v), (i, key)


def test_tensor_parallel_row_fetch_equals_its_eager_forward(cuda):
    """A tensor-parallel row (eager, no graph; here a 1 x 2 grid on one
    card) ties its event to its outputs too: with two batches in flight, its
    fetches give the answers of the stream-wide fetch of its own eager
    `end2end`."""
    import chip_smoke
    from yolo_series_tpu_torch.infer.serving import ShardedServingEngine
    from yolo_series_tpu_torch.parallel.mesh import make_mesh

    m = chip_smoke.make_model(cuda, width=0.25, img=128)
    eng = ShardedServingEngine(m.plan, m.params, m.state, make_mesh(1, 2, [cuda, cuda]),
                               batch_size=2, img_size=128)
    (row,) = eng.rows
    frames = [_frames(9, size=128), _frames(10, size=128)]
    with torch.inference_mode():
        want = [row.to_host(row.end2end(torch.from_numpy(x).to(cuda))) for x in frames]
    torch.cuda._sleep(_LONG_SLEEP)
    outs = [eng.infer_async(x)[0] for x in frames]
    assert row._event_of(outs[0][0]) is not None
    for out, w in zip(outs, want):
        got = eng.to_host(out)
        assert int(w["num_dets"].sum()) > 0
        for key in w:
            assert np.array_equal(got[key], w[key]), key


def _bf16(rng, shape, scale):
    return torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32)).to(
        torch.bfloat16)


def _close(got, want):
    """bf16 outputs of the same fp32-accumulated math: summation order
    differs, so a stage output may round to the neighbouring bf16 value and
    the difference compounds through the chained stages — a few bf16 ulps
    of the output scale."""
    d = (got.float() - want.float()).abs().max().item()
    scale = max(want.float().abs().max().item(), 1.0)
    assert d <= 2e-2 * scale, (d, scale)


def test_fused_stem_kernel_equals_plain(cuda):
    rng = np.random.default_rng(0)
    c1, cm, co, hx, w = 128, 64, 128, 32, 48
    p = {"wk2": _bf16(rng, (2, 2, c1, cm), 0.05), "b1": _bf16(rng, (cm,), 0.1),
         "ws2": _bf16(rng, (3, 3, cm, cm), 0.05), "b2": _bf16(rng, (cm,), 0.1),
         "ws3": _bf16(rng, (3, 3, cm, co), 0.05), "b3": _bf16(rng, (co,), 0.1)}
    x = _bf16(rng, (2, hx + 2 * fs._PAD, w, c1), 1.0)  # halo rows non-zero
    pc = {k: v.to(cuda) for k, v in p.items()}
    before = conv_silu.launch.launches
    got = fs.fused_stem(x.to(cuda), pc)
    torch.cuda.synchronize()
    assert conv_silu.launch.launches == before + 3
    want = fs.fused_stem_plain(x.to(cuda), pc)
    assert got.shape == want.shape == (2, hx // 2, w // 2, co)
    _close(got, want)


@pytest.mark.parametrize("order", ["backbone", "head"])
def test_fused_elan_kernel_equals_plain(cuda, order):
    rng = np.random.default_rng(1)
    cin, ct, cc, cout, h, w = 64, 32, 64, 96, 20, 24
    _, cat = fe.concat_slots(order, ct, cc)
    p = {"w4": _bf16(rng, (1, 1, cin, ct), 0.1), "b4": _bf16(rng, (ct,), 0.1),
         "w5": _bf16(rng, (1, 1, cin, ct), 0.1), "b5": _bf16(rng, (ct,), 0.1),
         "wc0": _bf16(rng, (3, 3, ct, cc), 0.05), "bc0": _bf16(rng, (cc,), 0.1),
         "wc": _bf16(rng, (3, 3, 3, cc, cc), 0.05), "bc": _bf16(rng, (3, cc), 0.1),
         "w11": _bf16(rng, (1, 1, cat, cout), 0.05), "b11": _bf16(rng, (cout,), 0.1)}
    pc = fe.merge_x45({k: v.to(cuda) for k, v in p.items()})
    x = _bf16(rng, (2, h, w, cin), 1.0).to(cuda)
    before = conv_silu.launch.launches
    got = fe.fused_elan(x, pc, order)
    torch.cuda.synchronize()
    assert conv_silu.launch.launches == before + 6  # x4 and x5 in one launch
    want = fe.fused_elan_plain(x, pc, order)
    assert got.shape == want.shape == (2, h, w, cout)
    _close(got, want)


def test_fused_elan_kernel_wants_merged_weights(cuda):
    rng = np.random.default_rng(2)
    cin, ct, cc, cout = 64, 32, 32, 64
    _, cat = fe.concat_slots("backbone", ct, cc)
    p = {"w4": _bf16(rng, (1, 1, cin, ct), 0.1), "b4": _bf16(rng, (ct,), 0.1),
         "w5": _bf16(rng, (1, 1, cin, ct), 0.1), "b5": _bf16(rng, (ct,), 0.1),
         "wc0": _bf16(rng, (3, 3, ct, cc), 0.05), "bc0": _bf16(rng, (cc,), 0.1),
         "wc": _bf16(rng, (3, 3, 3, cc, cc), 0.05), "bc": _bf16(rng, (3, cc), 0.1),
         "w11": _bf16(rng, (1, 1, cat, cout), 0.05), "b11": _bf16(rng, (cout,), 0.1)}
    pc = {k: v.to(cuda) for k, v in p.items()}
    with pytest.raises(ValueError, match="w45"):
        fe.fused_elan(_bf16(rng, (1, 8, 8, cin), 1.0).to(cuda), pc, "backbone")


# One conv + SiLU launch against the plain version at the kernel's edges:
# (name, B, rows, W, x channels, x_coff, c, x_row0, h, KH, stride, (pad t, b,
# l, r), co, y channels, y_coff, the (GEMM rows, N) tile the kernel picks).
# Ragged tiles (W = 20, 24), a 32-channel input (half of a 64-channel TMA
# box), stride 2, the stem's k2 pad (1, 0, 1, 0) read past 3 non-zero halo
# rows, channel slices at non-zero offsets on both sides, and the widest N
# (1024) and K (4608) of the yolov7 path, each on the tile of its size: the
# kernel takes N = 128 where CO > 64 and those tiles still cover the SMs
# (partial N tiles at CO = 96 and 192), and 256-row tiles at N = 64 where
# there are two for every CTA slot (two CTAs an SM). The sizes are chosen
# to pick the same tile on every Hopper card of 114 to 132 SMs.
SAME, ONE = (1, 1, 1, 1), (0, 0, 0, 0)
CONV_EDGES = [
    ("ragged_w20", 2, 20, 20, 64, 0, 64, 0, 20, 3, 1, SAME, 64, 64, 0, (128, 64)),
    ("ragged_w24_c32", 2, 12, 24, 32, 0, 32, 0, 12, 3, 1, SAME, 48, 48, 0, (128, 64)),
    ("stride2", 2, 24, 24, 64, 0, 64, 0, 24, 3, 2, SAME, 128, 128, 0, (128, 64)),
    ("stride2_odd", 1, 21, 19, 64, 0, 64, 0, 21, 3, 2, SAME, 64, 64, 0, (128, 64)),
    ("k2_halo", 2, 22, 20, 128, 0, 128, 3, 16, 2, 1, (1, 0, 1, 0), 64, 64, 0, (128, 64)),
    ("slices", 2, 16, 24, 160, 64, 64, 0, 16, 3, 1, SAME, 96, 192, 32, (128, 64)),
    ("slice_c32", 1, 10, 20, 96, 32, 32, 0, 10, 1, 1, ONE, 32, 96, 64, (128, 64)),
    ("widest_n", 1, 20, 20, 512, 0, 512, 0, 20, 1, 1, ONE, 1024, 1024, 0, (128, 64)),
    ("widest_k", 2, 20, 20, 512, 0, 512, 0, 20, 3, 1, SAME, 256, 256, 0, (128, 64)),
    ("n128_w24_co96_slices", 12, 48, 24, 160, 64, 64, 0, 48, 3, 1, SAME, 96, 192, 32,
     (128, 128)),
    ("n128_w20_co192_c32", 20, 40, 20, 96, 32, 32, 0, 40, 3, 1, SAME, 192, 288, 64,
     (128, 128)),
    ("n128_stride2_halo", 14, 54, 48, 64, 0, 64, 3, 48, 3, 2, SAME, 192, 192, 0,
     (128, 128)),
    ("m256_w24", 48, 96, 24, 64, 0, 64, 0, 96, 3, 1, SAME, 64, 64, 0, (256, 64)),
    ("m256_w20_c32_slices", 66, 88, 20, 96, 32, 32, 0, 88, 3, 1, SAME, 64, 128, 32,
     (256, 64)),
    ("m256_k2_halo", 48, 134, 20, 128, 0, 128, 3, 128, 2, 1, (1, 0, 1, 0), 64, 64, 0,
     (256, 64)),
    ("m256_1x1_c32", 76, 40, 40, 96, 32, 32, 0, 40, 1, 1, ONE, 64, 128, 64, (256, 64)),
    ("m256_stride2", 176, 48, 48, 64, 0, 64, 0, 48, 3, 2, SAME, 64, 64, 0, (256, 64)),
]


@pytest.mark.parametrize("case", CONV_EDGES, ids=[c[0] for c in CONV_EDGES])
def test_conv_silu_kernel_edges_equal_plain(cuda, case):
    (_, bsz, rows, wid, xcs, x_coff, c, x_row0, h, k, stride, pad, co, ycs,
     y_coff, tile) = case
    rng = np.random.default_rng(len(case[0]))
    kw = 2 if pad == (1, 0, 1, 0) else k
    x = _bf16(rng, (bsz, rows, wid, xcs), 1.0).to(cuda)
    w = _bf16(rng, (k, kw, c, co), 1.0 / np.sqrt(k * kw * c)).to(cuda)
    b = _bf16(rng, (co,), 0.1).to(cuda)
    want = conv_silu.conv_silu_plain(
        x[:, x_row0:x_row0 + h, :, x_coff:x_coff + c], w, b, stride, pad)
    # a sentinel in the channels outside the output slice: they stay untouched
    y = torch.full((bsz,) + tuple(want.shape[1:3]) + (ycs,), 7.0,
                   dtype=torch.bfloat16, device=cuda)
    before = conv_silu.launch.launches
    conv_silu.launch(x, w, b, y, h=h, c=c, stride=stride, pad_t=pad[0],
                     pad_l=pad[2], x_row0=x_row0, x_coff=x_coff, y_coff=y_coff)
    torch.cuda.synchronize()
    assert conv_silu.launch.launches == before + 1
    assert conv_silu.launch.tile == tile
    _close(y[..., y_coff:y_coff + co], want)
    outside = torch.cat([y[..., :y_coff], y[..., y_coff + co:]], -1)
    assert bool((outside == 7.0).all())


def test_conv_silu_launch_refuses_what_the_kernel_does_not_take(cuda):
    rng = np.random.default_rng(3)

    def t(*shape):
        return _bf16(rng, shape, 1.0).to(cuda)

    x, w, b, y = t(1, 8, 8, 64), t(3, 3, 64, 64), t(64), t(1, 8, 8, 64)
    ok = dict(h=8, c=64, stride=1, pad_t=1, pad_l=1)
    bad = [
        (t(1, 8, 8, 48), t(3, 3, 48, 64), b, y, dict(ok, c=48)),       # c % 32
        (x, t(3, 3, 64, 24), t(24), t(1, 8, 8, 24), ok),                 # co % 16
        (t(1, 8, 8, 72), w, b, y, dict(ok, x_coff=4)),                   # x_coff % 8
        (x, w, b, t(1, 8, 8, 72), dict(ok, y_coff=4)),                   # y_coff % 8
        (x, w, b, t(1, 8, 8, 100), ok),                                  # y stride % 8
        (x, w, b, t(1, 3, 3, 64), dict(ok, stride=3)),                   # stride 3
        (x, w, b, t(1, 8, 8, 96), dict(ok, y_coff=64)),                  # y slice out
        (t(1, 8, 8, 96), w, b, y, dict(ok, x_coff=64)),                  # x slice out
        (x, w, b, y, dict(ok, x_row0=1)),                                # rows out
        (x, w, t(32), y, ok),                                            # bias shape
        (x.float(), w, b, y, ok),                                        # dtype
        (x.transpose(1, 2), w, b, y, ok),                                # layout
        (x.cpu(), w, b, y, ok),                                          # device
    ]
    for i, (xi, wi, bi, yi, kw) in enumerate(bad):
        before = conv_silu.launch.launches
        with pytest.raises(ValueError):
            conv_silu.launch(xi, wi, bi, yi, **kw)
        assert conv_silu.launch.launches == before, i


def _int8(rng, shape, cuda):
    return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).to(cuda)


# M not a multiple of the 128-row tile, a one-row M, and the widest K and N
# of the yolov7 path
@pytest.mark.parametrize("m,k,n", [(320, 256, 128), (1, 128, 128), (3200, 2048, 1024),
                                   (20000, 128, 384)])
def test_int8_matmul_dequant_kernel_equals_plain(cuda, m, k, n):
    rng = np.random.default_rng(m)
    xq, w = _int8(rng, (m, k), cuda), _int8(rng, (n, k), cuda).t()
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, n).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(cuda)
    before = int8_mm.int8_matmul_dequant.launches
    got = int8_mm.int8_matmul_dequant(xq, w, scale, bias)
    torch.cuda.synchronize()
    assert int8_mm.int8_matmul_dequant.launches == before + 1
    assert torch.equal(got, int8_mm.int8_matmul_dequant_plain(xq, w, scale, bias))


# (M, K, N, the tile the wrapper picks on a Hopper card of 114 to 132 SMs):
# M = 1, ragged M, the 20 px convs at the widest K (M = 3200 with N = 256,
# 512, 1024) and a large ragged M whose tiles outnumber the persistent CTAs
K4_AUTO = [(1, 128, 128, (64, 64)), (333, 256, 128, (64, 64)),
           (3200, 2048, 256, (128, 64)), (3200, 2048, 512, (128, 128)),
           (3200, 2048, 1024, (128, 128)), (20037, 256, 384, (128, 128))]


@pytest.mark.parametrize("m,k,n,tile", K4_AUTO, ids=[f"{m}x{k}x{n}" for m, k, n, _ in K4_AUTO])
def test_int8_matmul_dequant_kernel_picks_its_tile(cuda, m, k, n, tile):
    rng = np.random.default_rng(m + n)
    xq, w = _int8(rng, (m, k), cuda), _int8(rng, (n, k), cuda).t()
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, n).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(cuda)
    got = int8_mm.int8_matmul_dequant(xq, w, scale, bias)
    torch.cuda.synchronize()
    assert int8_mm.int8_matmul_dequant.tile == tile
    assert torch.equal(got, int8_mm.int8_matmul_dequant_plain(xq, w, scale, bias))


@pytest.mark.parametrize("tile", int8_mm.TILES)
def test_int8_matmul_dequant_kernel_every_tile_large_m(cuda, tile):
    """Each tile forced on a large ragged M (many tiles a persistent CTA,
    the ring running on across them) and a K that wraps the ring."""
    rng = np.random.default_rng(tile[0] + tile[1])
    m, k, n = 40037, 1024, 256
    xq, w = _int8(rng, (m, k), cuda), _int8(rng, (n, k), cuda).t()
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, n).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(cuda)
    got = int8_mm.int8_matmul_dequant(xq, w, scale, bias, tile=tile)
    torch.cuda.synchronize()
    assert int8_mm.int8_matmul_dequant.tile == tile
    assert torch.equal(got, int8_mm.int8_matmul_dequant_plain(xq, w, scale, bias))


@pytest.mark.parametrize("tile", int8_mm.TILES)
def test_matmul_kernel_every_tile(cuda, tile):
    """K4b on each tile: int8 equal, bf16 within K * 2^-22 * sum|x w|."""
    rng = np.random.default_rng(7 + tile[1])
    m, k, n = 5000, 512, 256
    x, w = _int8(rng, (m, k), cuda), _int8(rng, (n, k), cuda).t()
    got = int8_mm.matmul(x, w, torch.int32, tile=tile)
    torch.cuda.synchronize()
    assert int8_mm.matmul.tile == tile
    assert torch.equal(got, int8_mm.matmul_plain(x, w, torch.int32))
    xb = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(cuda, torch.bfloat16)
    wb = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32) / k ** 0.5).to(
        cuda, torch.bfloat16).t()
    gotb = int8_mm.matmul(xb, wb, torch.float32, tile=tile)
    torch.cuda.synchronize()
    assert int8_mm.matmul.tile == tile
    err = (gotb - int8_mm.matmul_plain(xb, wb, torch.float32)).abs()
    assert bool((err <= k * 2.0 ** -22 * (xb.float().abs() @ wb.float().abs())).all())


@pytest.mark.parametrize("m,k,n", [(12800, 1024, 512), (3200, 2048, 1024), (200, 128, 256)])
def test_matmul_kernel_equals_plain(cuda, m, k, n):
    """K4b: int8 -> int32 equal; bf16 -> fp32 within K * 2^-22 * sum|x w|
    (two fp32 sums of K terms in different orders)."""
    rng = np.random.default_rng(n)
    x, w = _int8(rng, (m, k), cuda), _int8(rng, (n, k), cuda).t()
    got = int8_mm.matmul(x, w, torch.int32)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32
    assert torch.equal(got, int8_mm.matmul_plain(x, w, torch.int32))
    xb = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(cuda, torch.bfloat16)
    wb = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32) / k ** 0.5).to(
        cuda, torch.bfloat16).t()
    gotb = int8_mm.matmul(xb, wb, torch.float32)
    torch.cuda.synchronize()
    err = (gotb - int8_mm.matmul_plain(xb, wb, torch.float32)).abs()
    assert bool((err <= k * 2.0 ** -22 * (xb.float().abs() @ wb.float().abs())).all())


def test_int8_mm_wrappers_refuse_unaligned_or_transposed(cuda):
    rng = np.random.default_rng(0)
    x, w = _int8(rng, (256, 96), cuda), _int8(rng, (128, 96), cuda).t()
    s = torch.ones(128, device=cuda)
    with pytest.raises(ValueError, match="multiples of 128"):
        int8_mm.int8_matmul_dequant(x, w, s, s)
    x, w = _int8(rng, (256, 128), cuda), _int8(rng, (64, 128), cuda).t()
    with pytest.raises(ValueError, match="multiples of 128"):
        int8_mm.matmul(x, w, torch.int32)
    x, w = _int8(rng, (256, 128), cuda), _int8(rng, (128, 128), cuda)  # row-major (K, N)
    with pytest.raises(ValueError, match="column-major"):
        int8_mm.int8_matmul_dequant(x, w, s, s)
    x, w = _int8(rng, (256, 128), cuda), _int8(rng, (128, 128), cuda).t()
    for tile in ((64, 128), (128, 32), (256, 128)):   # tiles the kernel has not
        with pytest.raises(ValueError, match="tile"):
            int8_mm.int8_matmul_dequant(x, w, s, s, tile=tile)


@pytest.mark.parametrize("k,s,c,n", [(1, 1, 128, 256), (3, 1, 32, 64), (3, 2, 3, 32),
                                     (1, 1, 96, 128)])
def test_int8_conv_on_card_equals_cpu(cuda, k, s, c, n):
    """`quant.int8_conv` on the card (K4, or the im2col product through
    torch._int_mm) gives the CPU's result bit for bit."""
    rng = np.random.default_rng(k * 10 + c)
    x = torch.from_numpy(rng.normal(size=(2, c, 20, 20)).astype(np.float32)).contiguous(
        memory_format=torch.channels_last)
    w = torch.from_numpy(rng.normal(size=(n, c, k, k)).astype(np.float32))
    wq, sw = quant.quantize_weight(w)
    b = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    want = quant.int8_conv(x, wq, sw, b, s, k // 2, 1)
    got = quant.int8_conv(x.to(cuda), wq.to(cuda), sw.to(cuda), b.to(cuda), s, k // 2, 1)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("k,s,c,n,g", [(3, 1, 64, 64, 32), (3, 2, 256, 256, 32),
                                       (1, 1, 128, 128, 32), (3, 1, 48, 96, 3)])
def test_grouped_int8_conv_on_card_equals_cpu(cuda, k, s, c, n, g):
    """`quant.int8_conv` with groups on the card (one torch._int_mm a group;
    x50-csp's ResX 3 x 3s have 2-16 channels a group) gives the CPU's
    result bit for bit."""
    rng = np.random.default_rng(k * 10 + c + g)
    x = torch.from_numpy(rng.normal(size=(2, c, 20, 20)).astype(np.float32)).contiguous(
        memory_format=torch.channels_last)
    w = torch.from_numpy(rng.normal(size=(n, c // g, k, k)).astype(np.float32))
    wq, sw = quant.quantize_weight(w)
    b = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    want = quant.int8_conv(x, wq, sw, b, s, k // 2, g)
    got = quant.int8_conv(x.to(cuda), wq.to(cuda), sw.to(cuda), b.to(cuda), s, k // 2, g)
    assert torch.equal(got.cpu(), want)


def test_graph_capture_failure_raises(cuda, graph_engine):
    """A capture that fails raises; the engine does not fall back to eager.
    The card stays usable (`device.graph_capture`): the caller's stream is
    current again, the capture's pool is given back, and an emptied cache
    holds no free segment."""
    from yolo_series_tpu_torch.infer.serving import ServingEngine

    eng = ServingEngine(graph_engine.plan, graph_engine._params, graph_engine._state,
                        batch_size=1, img_size=256, device="cuda")
    real = eng.end2end
    calls = []

    def syncing(x):
        out = real(x)
        calls.append(int(out["num_dets"].sum().item()))   # a host sync
        return out

    eng.end2end = syncing
    stream = torch.cuda.current_stream()
    torch.cuda.empty_cache()
    pools = {tuple(g["segment_pool_id"]) for g in torch.cuda.memory._snapshot()["segments"]}
    with pytest.raises(Exception):
        eng.infer(_frames(4, n=1))
    assert not eng.captured and eng.replays == 0
    assert torch.cuda.current_stream() == stream
    # what the capture allocated is freed with its traceback, which a
    # reference cycle (through contextlib's frames) holds until a collection
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    segments = torch.cuda.memory._snapshot()["segments"]
    assert {tuple(g["segment_pool_id"]) for g in segments} <= pools
    assert not [g for g in segments if tuple(g["segment_pool_id"]) == (0, 0)
                and g["allocated_size"] == 0]


# ------------------------------------------------------------ train step ---

def test_train_step_fp32_card_equals_cpu(cuda):
    """One fp32 step (OTA, SGD) of yolov7's training form at width 0.25,
    320 px, batch 2 on the card (TF32 off) against the same step on the
    CPU: the relative L2 distance of the updates, the BN stats and the EMA
    within chip_smoke's limits (phase 7 (b))."""
    import chip_smoke

    got = chip_smoke.check_fp32_step(cuda)
    assert got["update_rel_l2"] <= chip_smoke.STEP_UPDATE_L2
    assert max(got["bn_state_rel_err"], got["ema_rel_err"]) <= chip_smoke.STEP_STATE_REL


def test_ota_card_equals_cpu(cuda):
    """The OTA loss and assignment on the card against the CPU on the same
    fp32 raw maps (a bf16 training forward of yolov7 at width 0.5, 320 px,
    batch 4) and labels padded to 256 rows: chip_smoke's limits (phase 7
    (a))."""
    import chip_smoke
    from yolo_series_tpu_torch.models.model import apply_model

    m = chip_smoke.train_model(cuda, 0.5)
    images, labels, mask = chip_smoke.train_batch(np.random.default_rng(0), 4, 320)
    x = torch.from_numpy(images).to(cuda).float() / 255.0
    with torch.no_grad():
        out, _ = apply_model(m.plan, m.params, m.state, x, training=True,
                             dtype=torch.bfloat16)
    got = chip_smoke.check_ota(cuda, m.plan, [r.float() for r in out["raw"]],
                               torch.from_numpy(labels).to(cuda),
                               torch.from_numpy(mask).to(cuda))
    assert got["same_columns"] >= chip_smoke.OTA_COLUMN_SHARE and got["fg"] > 0


def test_bf16_train_step_grads_finite(cuda):
    """Two bf16 steps at width 0.5, 320 px, batch 2: finite losses, params,
    momentum buffer (the sum of every grad) and BN stats; the first
    momentum buffer is the first step's grads (+ weight decay), all finite
    and not all zero."""
    import chip_smoke
    from yolo_series_tpu_torch.losses import LossHyp, make_compute_loss_ota
    from yolo_series_tpu_torch.train.optim import OptimConfig
    from yolo_series_tpu_torch.train.step import init_train_state, make_train_step
    from yolo_series_tpu_torch.models.model import tree_leaves as leaves

    m = chip_smoke.train_model(cuda, 0.5)
    opt = OptimConfig()
    step = make_train_step(m.plan, make_compute_loss_ota(m.plan.head, LossHyp()), opt)
    ts = init_train_state(m.params, m.state, opt, device=cuda)
    batch = chip_smoke.train_batch(np.random.default_rng(1), 2, 320)
    lr, mom = chip_smoke.lr_after_warmup(opt)
    for _ in range(2):
        ts, metrics = step(ts, *batch, lr, mom)
        assert all(torch.isfinite(v) for v in metrics.values())
        v = leaves(ts.opt_state["v"])
        assert all(bool(torch.isfinite(t).all()) for t in v + leaves(ts.params)
                   + leaves(ts.state))
        assert any(bool(t.any()) for t in v)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tiled_max_pool_ties_card_equals_cpu(cuda, dtype):
    """The tiled 2x2/2 max pool on tied inputs (values in {0, 1/2, 1}):
    output and gradient on the card bit-equal to the CPU's (a window's
    gradient split equally among its tied maxima)."""
    from yolo_series_tpu_torch.models.layers import max_pool

    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(0, 3, (4, 64, 40, 48)) / 2).to(dtype)
    g = torch.from_numpy(rng.normal(0, 1, (4, 64, 20, 24))).to(dtype)
    out = {}
    for where in (cuda, torch.device("cpu")):
        xt = x.to(where).contiguous(memory_format=torch.channels_last).requires_grad_()
        y = max_pool(xt, 2, 2, 0)
        gx, = torch.autograd.grad(y, xt, g.to(where))
        out[where.type] = (y.detach().cpu(), gx.cpu())
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    assert (out["cpu"][1] != 0).sum() > y.numel()      # ties split the gradient


# ------------------------------------------------------------ trainer ---

# The trainer's step card against CPU: the update and the momentum slot by
# relative L2, within PR 7's step limit for two implementations
# (tests/test_torch_port_train.py STEP_UPDATE_L2): the synthetic set's
# flat regions (the mosaic's grey border, filled rectangles, blocky noise)
# make near-ties in the max pools, which the two devices' roundings route
# to different inputs (phase 7 (b)'s 1e-3 holds on noise frames, with few
# ties). A wrong batch, upload or lr moves it by 10-100%.
TRAINER_UPDATE_L2 = 1e-2

def test_trainer_upload_equals_loader_batches(cuda, tmp_path):
    """The trainer's uploads (`BatchUpload`: pinned staging buffers, an
    asynchronous copy) of the loader's batches, two micro-batches stacked
    a step with the loader's pooled buffers cycling at hold = 2 and two
    workers: each uploaded tensor equals the batches as the loader yielded
    them, though their buffers are overwritten as soon as the upload
    returns."""
    import chip_smoke
    from yolo_series_tpu_torch.data.datasets import DetectionDataset, create_loader
    from yolo_series_tpu_torch.train.trainer import BatchUpload, load_hyp

    chip_smoke.write_dataset(tmp_path, n_train=24, n_val=0, size=256)
    ds = DetectionDataset(str(tmp_path / "train" / "images"), img_size=256, augment=True,
                          hyp=load_hyp(None), seed=0)
    upload = BatchUpload(cuda)
    got, want, micro = [], [], []
    for b in create_loader(ds, batch_size=4, hold=2, workers=2, prefetch=1):
        micro.append(b)
        if len(micro) < 2:
            continue
        for key in ("images", "labels", "label_mask"):
            want.append(np.stack([m[key] for m in micro]))
            got.append(upload([m[key] for m in micro]))
        want.append(micro[0]["images"].copy())
        got.append(upload([micro[0]["images"]]))
        for m in micro:   # the loader's buffers are the loader's again
            m["images"][...] = 0
        micro = []
    torch.cuda.synchronize()
    assert len(got) == 3 * 4
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), torch.from_numpy(w))


def test_trainer_card_step_equals_cpu(cuda, tmp_path):
    """One optimizer step of the trainer (yolov7 training form at width
    0.25, 320 px, batch 2, fp32 with TF32 off) on the card and on the CPU
    from the same seed on the same synthetic set, with no warmup, so every
    group steps at lr0: the params' update and the momentum slot (the
    whole gradient) within TRAINER_UPDATE_L2, the BN stats, the EMA
    params and the EMA's BN stats within chip_smoke.STEP_STATE_REL
    (relative L2 of each tree, phase 7 (b)'s limit)."""
    import yaml

    import chip_smoke
    from yolo_series_tpu_torch.models.graph import compile_graph
    from yolo_series_tpu_torch.models.model import init_model, tree_map
    from yolo_series_tpu_torch.train.trainer import TrainConfig, train

    data = chip_smoke.write_dataset(tmp_path / "data", n_train=2, n_val=0, size=320)
    cfg = tmp_path / "model.yaml"
    cfg.write_text(yaml.safe_dump(chip_smoke._cfg(0.25, chip_smoke.TRAIN_CFG)))
    snaps = {}
    for dev in ("cuda", "cpu"):
        tc = TrainConfig(cfg=str(cfg), data=data, epochs=1, batch_size=2, img_size=320,
                         nominal_batch_size=2, compute_dtype=torch.float32, noval=True,
                         max_labels=64, seed=0, device=dev, save_dir=str(tmp_path / dev),
                         hyp={"warmup_epochs": 0}, warmup_min_steps=0)
        train(tc, callbacks={"on_epoch_end": lambda e, r, ts, d=dev: snaps.__setitem__(d, ts)})
    card, cpu = snaps["cuda"], snaps["cpu"]
    init, _ = init_model(compile_graph(str(cfg), nc=80), torch.Generator().manual_seed(0))
    du_card = chip_smoke.tree_update(card.params, tree_map(lambda t: t.to(cuda), init))
    du_cpu = chip_smoke.tree_update(cpu.params, init)
    err = {"update": float((du_card - du_cpu).norm() / du_cpu.norm()),
           "v": chip_smoke.tree_rel_l2(card.opt_state["v"], cpu.opt_state["v"])}
    err |= {name: chip_smoke.tree_rel_l2(getattr(card, name), getattr(cpu, name))
            for name in ("state", "ema_state", "ema_params")}
    print(f"trainer step, card against CPU, relative L2: {err}")
    assert max(err["update"], err["v"]) <= TRAINER_UPDATE_L2, err
    assert max(err["state"], err["ema_state"], err["ema_params"]) <= \
        chip_smoke.STEP_STATE_REL, err
