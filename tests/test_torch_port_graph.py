"""Port graph compiler, weight bridge, re-parameterization and forward
against the JAX package on the same weights (CPU, fp32)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_util import (PORT_DEPLOY_CFG, PORT_TRAINING_CFG, deploy_cfg,
                                    jax_model, to_numpy, training_cfg)
from yolo_series_tpu.models import faststem as jfs
from yolo_series_tpu.models import graph as jgraph
from yolo_series_tpu.models import model as jmodel
from yolo_series_tpu.models import reparam as jreparam
from yolo_series_tpu_torch.models import faststem as tfs
from yolo_series_tpu_torch.models import graph as tgraph
from yolo_series_tpu_torch.models import model as tmodel
from yolo_series_tpu_torch.models import reparam as treparam
from yolo_series_tpu_torch.models.convert import from_jax_params

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def half_width():
    """JAX yolov7 deploy at width 0.5 (unfused, livened) and the port's
    plan with the same weights."""
    plan, params, state = jax_model(0.5, seed=0)
    tplan = tgraph.compile_graph(deploy_cfg(0.5))
    tp, ts = from_jax_params(tplan, params, state)
    return plan, params, state, tplan, tp, ts


def _block_fields(block):
    return type(block).__name__, dataclasses.asdict(block)


def test_compile_graph_matches_jax_full_width():
    jp = jgraph.compile_graph(deploy_cfg(1.0))
    tp = tgraph.compile_graph(PORT_DEPLOY_CFG)
    assert tp.save == jp.save and tp.nc == jp.nc and tp.names == jp.names
    assert len(tp.layers) == len(jp.layers) == 106
    for a, b in zip(tp.layers, jp.layers):
        assert (a.index, a.frm, a.cout, a.stride, a.is_head, a.n_seq) == \
            (b.index, b.frm, b.cout, b.stride, b.is_head, b.n_seq)
        assert _block_fields(a.block) == _block_fields(b.block), a.index
    np.testing.assert_array_equal(tp.head.anchors_grid(), jp.head.anchors_grid())
    assert tp.strides == jp.strides == (8.0, 16.0, 32.0)


def test_port_cfg_is_the_jax_cfg():
    import yaml

    with open(PORT_DEPLOY_CFG) as f:
        assert yaml.safe_load(f) == deploy_cfg(1.0)
    with open(PORT_TRAINING_CFG) as f:
        assert yaml.safe_load(f) == training_cfg(1.0)


@pytest.mark.parametrize("name", ["IDetect", "idetect"])
def test_compile_training_graph_matches_jax(name):
    """yolov7's training form: the same plan as the JAX package's, with an
    IDetect head (the reference's name or the canonical one)."""
    cfg = training_cfg(1.0)
    cfg["head"][-1] = [[102, 103, 104], 1, name, ["nc", "anchors"]]
    jp, tp = jgraph.compile_graph(cfg), tgraph.compile_graph(cfg)
    assert type(tp.head).__name__ == type(jp.head).__name__ == "IDetect"
    assert len(tp.layers) == len(jp.layers) == 106 and tp.save == jp.save
    for a, b in zip(tp.layers, jp.layers):
        assert (a.index, a.frm, a.cout, a.stride) == (b.index, b.frm, b.cout, b.stride)
        assert _block_fields(a.block) == _block_fields(b.block), a.index


def test_implicit_layers_compile_from_the_dsl():
    """ImplicitA / ImplicitM rows take their width from their input."""
    from yolo_series_tpu_torch.models import layers as tlayers

    cfg = deploy_cfg(1.0)
    cfg["backbone"].insert(1, [-1, 1, "ImplicitA", []])
    cfg["backbone"].insert(2, [-1, 1, "ImplicitM", []])
    for row in cfg["backbone"][3:] + cfg["head"]:   # two rows added: shift refs
        f = row[0]
        row[0] = ([x + 2 if x > 0 else x for x in f] if isinstance(f, list)
                  else f + 2 if f > 0 else f)
    tp = tgraph.compile_graph(cfg)
    assert tp.layers[1].block == tlayers.ImplicitA(32)
    assert tp.layers[2].block == tlayers.ImplicitM(32)
    assert len(tp.layers) == 108


@pytest.mark.parametrize("module", ["IBin", "GhostCSPA", "Focus", "NoSuchBlock"])
def test_unported_module_raises(module):
    """The modules once refused here compile now as the JAX package
    compiles them (the IBin head, item 15; GhostCSPA and Focus, item 16
    (c): tests/test_torch_port_heads_tail.py, test_torch_port_zoo_tail.py):
    the same blocks, channels and strides. A name that neither package
    knows still raises NotImplementedError, naming no ROADMAP item."""
    cfg = deploy_cfg(1.0)
    if module == "IBin":
        cfg["head"][-1] = [[102, 103, 104], 1, "IBin", ["nc", "anchors"]]
    else:
        cfg["backbone"][1] = [-1, 1, module, [64]]
    if module == "NoSuchBlock":
        with pytest.raises(NotImplementedError, match="no ROADMAP item: neither package knows"):
            tgraph.compile_graph(cfg)
        with pytest.raises(NotImplementedError):
            jgraph.compile_graph(cfg)
        return
    tp, jp = tgraph.compile_graph(cfg), jgraph.compile_graph(cfg)
    assert [repr(s.block) for s in tp.layers] == [repr(s.block) for s in jp.layers]
    assert [(s.cout, s.stride) for s in tp.layers] == [(s.cout, s.stride) for s in jp.layers]


def test_fuse_model_matches_jax(half_width):
    plan, params, state, tplan, tp, ts = half_width
    jfp, jfs_ = jreparam.fuse_model(plan, jax.tree_util.tree_map(jnp.asarray, params),
                                    jax.tree_util.tree_map(jnp.asarray, state))
    want, _ = from_jax_params(tplan, to_numpy(jfp), to_numpy(jfs_))
    got, _ = treparam.fuse_model(tplan, tp, ts)
    n = _assert_trees_close(got, want)
    assert n > 150


def _assert_trees_close(a, b, path="", rtol=1e-6, atol=1e-6):
    """Compare two param trees key by key; returns the number of leaves."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        return sum(_assert_trees_close(a[k], b[k], f"{path}/{k}") for k in a)
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        return sum(_assert_trees_close(x, y, f"{path}/{i}")
                   for i, (x, y) in enumerate(zip(a, b)))
    assert a.shape == b.shape, path
    torch.testing.assert_close(a, b, rtol=rtol, atol=atol, msg=path)
    return 1


def _jax_forward(plan, params, state, x):
    feats, _ = jmodel.apply_model(plan, params, state, jnp.asarray(x),
                                  return_head_inputs=True)
    out, _ = jmodel.apply_model(plan, params, state, jnp.asarray(x))
    return [np.asarray(f) for f in feats], np.asarray(out["pred"])


@pytest.mark.parametrize("fast_stem", [False, True])
@pytest.mark.parametrize("size", [64, 128])
def test_apply_model_matches_jax(half_width, fast_stem, size):
    """fp32 forward on the fused deploy graph, with and without the fast-stem
    fold. Tolerance: the same fp32 math in another summation order (oneDNN
    vs XLA convs) through ~100 layers — relative 1e-4 of each tensor's
    scale."""
    plan, params, state, tplan, tp, ts = half_width
    jp, js = jreparam.fuse_model(plan, jax.tree_util.tree_map(jnp.asarray, params),
                                 jax.tree_util.tree_map(jnp.asarray, state))
    fp, fs_ = treparam.fuse_model(tplan, tp, ts)
    if fast_stem:
        plan, jp, js = jfs.make_fast_stem(plan, jp, js, max_pairs=2)
        tplan, fp, fs_ = tfs.make_fast_stem(tplan, fp, fs_, max_pairs=2)
        assert isinstance(tplan.layers[0].block, tfs.PhasedConv)
        assert isinstance(tplan.layers[3].block, tfs.PhasedConv)
    x = np.random.default_rng(size).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    want_feats, want_pred = _jax_forward(plan, jp, js, x)
    with torch.inference_mode():
        feats, _ = tmodel.apply_model(tplan, fp, fs_, torch.from_numpy(x),
                                      return_head_inputs=True)
        out, _ = tmodel.apply_model(tplan, fp, fs_, torch.from_numpy(x))
    for f, w in zip(feats, want_feats):
        assert f.shape == w.shape
        np.testing.assert_allclose(f.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())
    pred = out["pred"].numpy()
    assert pred.shape == want_pred.shape
    np.testing.assert_allclose(pred[..., :4], want_pred[..., :4], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(pred[..., 4:], want_pred[..., 4:], rtol=0,
                               atol=1e-4)
    assert np.abs(want_pred[..., 4]).std() > 0.01  # the weights do vary


def test_model_owner_runs_on_cpu():
    m = tmodel.Model.from_yaml(PORT_DEPLOY_CFG, seed=1, device="cpu")
    assert m.num_params() > 36_000_000
    assert m.strides == (8.0, 16.0, 32.0)
    out = m(torch.rand(1, 64, 64, 3))
    assert out["pred"].shape == (1, 3 * (64 + 16 + 4), 85)
