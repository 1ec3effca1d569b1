"""Serving on a ('data', 'model') grid in the port against the JAX package
on the CPU: `parallel/mesh.param_partition_specs` leaf by leaf against
JAX's rule, and `infer/serving.ShardedServingEngine` over 2x1, 1x4 and 2x2
grids of CPU devices against JAX's single-device fused serving function,
the one `tests/test_parallel_train.py` holds its data- and tensor-parallel
serving against (counts, classes and scores at JAX's rtol 1e-5, atol 1e-4;
boxes at `BOX_ATOL`), and bit for bit against the port's one-device
engine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from chip_smoke import _leaves_any, liven
from tests._torch_port_util import deploy_cfg, port_drawn_model
from yolo_series_tpu.models import reparam as jreparam
from yolo_series_tpu.models.model import apply_model as japply
from yolo_series_tpu.ops.nms import fused_head_nms as jfused_head_nms
from yolo_series_tpu.parallel.mesh import param_partition_specs as jspecs
from yolo_series_tpu_torch.infer.serving import (DynamicBatcher, ServingEngine,
                                                 ShardedServingEngine)
from yolo_series_tpu_torch.models import reparam as treparam
from yolo_series_tpu_torch.models.convert import to_jax_params, to_jax_tree
from yolo_series_tpu_torch.models.model import tree_leaves
from yolo_series_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

TINY = "yolo_series_tpu/models/cfg/deploy/yolov7-tiny.yaml"
V7 = "yolo_series_tpu/models/cfg/deploy/yolov7.yaml"
SIZE = 160
BATCH = 4
NMS = dict(conf_thres=0.25, iou_thres=0.45, max_det=50, max_nms=256)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("fused", [False, True], ids=["bn", "fused"])
@pytest.mark.parametrize("cfg", [TINY, V7], ids=["tiny", "yolov7"])
def test_partition_specs_match_jax(cfg, fused, n_model):
    """Every leaf the port cuts (OIHW dim 0) is one JAX cuts (HWIO axis 3
    over 'model'), and every other leaf is replicated in both, on the
    unfused and the fused deploy trees."""
    _, _, _, tplan, tp, ts = port_drawn_model(deploy_cfg(path=cfg), seed=1)
    if fused:
        tp, ts = treparam.fuse_model(tplan, tp, ts)
    got = tmesh.param_partition_specs(tp, n_model)
    want = jspecs(to_jax_tree(tp), n_model)
    g = jax.tree_util.tree_leaves(got, is_leaf=lambda v: v is None)
    w = jax.tree_util.tree_leaves(want, is_leaf=lambda v: isinstance(v, P))
    assert len(g) == len(w) == len(tree_leaves(tp))
    assert [0 if s == P(None, None, None, "model") else None for s in w] == g
    cut = [t for t, s in zip(tree_leaves(tp), g) if s == 0]
    assert cut and all(t.ndim == 4 and t.shape[0] % n_model == 0 for t in cut)
    # the head's 255-channel convs stay whole
    assert all(s is None for s in jax.tree_util.tree_leaves(
        got["layers"][-1], is_leaf=lambda v: v is None))
    shards = tmesh.shard_params(tp, got, ["cpu"] * n_model)
    for k, tree in enumerate(shards):
        for t, s, whole in zip(tree_leaves(tree), g, tree_leaves(tp)):
            want_t = whole.chunk(n_model, 0)[k] if s == 0 else whole
            assert torch.equal(t, want_t)


@pytest.fixture(scope="module")
def served():
    """Livened yolov7-tiny deploy weights, fused by both packages, the
    port's trees, and JAX's single-device fused serving output on 4 uint8
    frames (the function of tests/test_parallel_train.py:341,423)."""
    _, _, _, tplan, tp, ts = port_drawn_model(deploy_cfg(path=TINY), seed=3)
    calib = np.random.default_rng(3).integers(0, 256, (2, SIZE, SIZE, 3)) / 255.0
    liven(tplan, tp, ts, torch.from_numpy(calib).float(), candidates=60)
    params, state = to_jax_params(tplan, tp, ts)
    from yolo_series_tpu.models.graph import compile_graph as jcompile
    jplan = jcompile(deploy_cfg(path=TINY))
    jp, js = jreparam.fuse_model(jplan, _jax(params), _jax(state))
    head = jplan.head

    def serve(x):
        xf = x.astype(jnp.float32) / 255.0
        feats, _ = japply(jplan, jp, js, xf, training=False, return_head_inputs=True)
        return jfused_head_nms(head, jp["layers"][-1], feats, compute_dtype=jnp.float32,
                               **NMS)

    x = np.random.default_rng(1).integers(0, 255, (BATCH, SIZE, SIZE, 3)).astype(np.uint8)
    want = [np.asarray(a) for a in jax.jit(serve)(jnp.asarray(x))]
    fp, fs = treparam.fuse_model(tplan, tp, ts)
    return tplan, fp, fs, x, want


def _engine(served, n_data, n_model, **kw):
    tplan, fp, fs, _, _ = served
    grid = tmesh.make_mesh(n_data, n_model, ["cpu"] * 4)
    return ShardedServingEngine(tplan, fp, fs, grid, batch_size=BATCH, img_size=SIZE,
                                dtype=torch.float32, **NMS, **kw)


# the decoded boxes of XLA's fp32 forward and the port's differ by up to
# 1.5e-3 px on the CPU: ~1e-6 relative rounding of the two backends' convs,
# amplified by the (2 sigmoid)^2 x anchor width decode. Scores, classes and
# counts hold JAX's own tolerances; a grid against the port's one-device
# engine is held bit for bit.
BOX_ATOL = 2e-3


@pytest.mark.parametrize("grid", [(2, 1), (1, 4), (2, 2)], ids=["2x1", "1x4", "2x2"])
def test_sharded_engine_matches_jax(served, grid):
    """Each grid's detections equal the port's single-device engine's bit
    for bit, and JAX's single-device serving: counts and classes exactly,
    scores at rtol 1e-5, atol 1e-4, boxes at rtol 1e-5, atol BOX_ATOL. A
    grid with a model axis cuts its convs: each row's cut weights are
    `ShardedWeight`s over its devices."""
    tplan, fp, fs, x, want = served
    eng = _engine(served, *grid)
    got = eng.infer(x)
    assert len(eng.rows) == grid[0]
    assert int(want[0].sum()) > 10
    n_cut = [sum(isinstance(v, tmesh.ShardedWeight) for v in _leaves_any(r._params))
             for r in eng.rows]
    assert all(n == (0 if grid[1] == 1 else n_cut[0]) for n in n_cut)
    if grid[1] > 1:
        assert n_cut[0] > 20
    one = ServingEngine(tplan, fp, fs, batch_size=BATCH, img_size=SIZE, dtype=torch.float32,
                        device="cpu", **NMS).infer(x)
    for key in one:
        np.testing.assert_array_equal(got[key], one[key], err_msg=key)
    for key, w in zip(("num_dets", "det_boxes", "det_scores", "det_classes"), want):
        g = got[key].reshape(w.shape)
        atol = BOX_ATOL if key == "det_boxes" else 1e-4
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=atol, err_msg=key)


def test_sharded_engine_refuses_and_batches(served):
    """A global batch that the rows do not divide raises, as a batch
    sharding over 'data' does; a grid larger than its devices raises, and
    so does split_concat on a tensor-parallel row (it runs the plan without
    the serving rewrites); a partial batch is padded and trimmed; a
    `DynamicBatcher` in front of a 2x2 grid answers each frame with the
    grid's own rows."""
    tplan, fp, fs, x, _ = served
    with pytest.raises(ValueError, match="does not split over 3 rows"):
        ShardedServingEngine(tplan, fp, fs, tmesh.make_mesh(3, 1, ["cpu"] * 3),
                             batch_size=BATCH, img_size=SIZE, dtype=torch.float32)
    with pytest.raises(ValueError, match="needs 6 devices"):
        tmesh.make_mesh(3, 2, ["cpu"] * 4)
    with pytest.raises(ValueError, match="runs without its rewrites"):
        _engine(served, 2, 2, split_concat=True)
    eng = _engine(served, 2, 2)
    full = eng.infer(x)
    part = eng.infer(x[:3])
    assert part["det_boxes"].shape[0] == 3
    for k in full:
        np.testing.assert_array_equal(part[k], full[k][:3])
    batcher = DynamicBatcher(eng, max_delay_ms=20.0)
    try:
        slots = [batcher.submit(f) for f in x]
        res = [DynamicBatcher.wait(s, timeout=60) for s in slots]
    finally:
        batcher.close()
    for i, r in enumerate(res):
        n = int(r["num_dets"][0])
        assert n == int(full["num_dets"][i, 0])
        np.testing.assert_allclose(r["det_boxes"][:n], full["det_boxes"][i, :n], atol=1e-4)
