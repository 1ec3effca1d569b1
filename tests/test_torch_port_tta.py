"""The port's TTA and ensembles (`models/tta.py`) against the JAX package on
the CPU: `apply_model_tta` and `apply_ensemble` on yolov7-tiny (fused) at
128 px and 128 x 192 and yolov7 at width 0.25 (fused) at 160 px, and the
Detector with augment=True (with and without extra_models, which TTA
ignores). `evaluate(augment=True)` and the CLIs' --augment:
tests/test_torch_port_tta_eval.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_util import deploy_cfg, jax_model, port_drawn_model, zoo_cfg
from tests.test_torch_port_detect import _same_rows
from yolo_series_tpu.infer.detector import Detector as JDetector
from yolo_series_tpu.models import reparam as jreparam
from yolo_series_tpu.models import tta as jtta
from yolo_series_tpu_torch.infer.detector import Detector
from yolo_series_tpu_torch.models import graph as tgraph
from yolo_series_tpu_torch.models import reparam as treparam
from yolo_series_tpu_torch.models import tta
from yolo_series_tpu_torch.models.convert import from_jax_params

torch.set_num_threads(2)

SHAPES = ((100, 150), (160, 160), (90, 200))


def _fused_pair(plan, params, state, cfg):
    """A model in both packages with the same numbers, fused."""
    jp, js = jreparam.fuse_model(plan, jax.tree_util.tree_map(jnp.asarray, params),
                                 jax.tree_util.tree_map(jnp.asarray, state))
    tplan = tgraph.compile_graph(cfg)
    tp, ts = treparam.fuse_model(tplan, *from_jax_params(tplan, params, state))
    return (plan, jp, js), (tplan, tp, ts)


@pytest.fixture(scope="module")
def tiny():
    """yolov7-tiny deploy (LeakyReLU) drawn by the port, fused in both
    packages."""
    cfg = zoo_cfg("yolov7-tiny", "deploy")
    return _fused_pair(*port_drawn_model(cfg, seed=0)[:3], cfg)


@pytest.fixture(scope="module")
def w025():
    """yolov7 deploy at width 0.25, livened on 160 px noise, fused."""
    cfg = deploy_cfg(0.25)
    return _fused_pair(*jax_model(0.25, seed=5, size=160, candidates=60), cfg)


def _close_preds(got, want):
    """Concatenated TTA predictions against JAX's: the forwards' tolerance
    (tests/test_torch_port_detect.py: boxes 1e-4 of the largest, obj and
    class 1e-4), the resize's fp32 sums adding ~1e-7 at the inputs."""
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0,
                               atol=1e-4 * np.abs(want[..., :4]).max())
    np.testing.assert_allclose(got[..., 4:], want[..., 4:], rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", ["tiny_128", "tiny_128x192", "w025_160"])
def test_tta_matches_jax(case, tiny, w025):
    """apply_model_tta (fp32): three passes (1, 0.83 flipped, 0.67), their
    anchors, scale and flip undone, equal to JAX's within _close_preds."""
    (jm, tm), hw = {"tiny_128": (tiny, (128, 128)), "tiny_128x192": (tiny, (128, 192)),
                    "w025_160": (w025, (160, 160))}[case]
    x = np.random.default_rng(1).random((2, *hw, 3)).astype(np.float32)
    want = jax.jit(lambda x: jtta.apply_model_tta(*jm, x))(jnp.asarray(x))
    got = tta.apply_model_tta(*tm, torch.from_numpy(x))
    gs = 32
    side = [(-(-hw[0] * r // gs) * gs, -(-hw[1] * r // gs) * gs) if r != 1.0 else hw
            for r in tta.TTA_SCALES]
    assert got.shape[1] == sum(3 * int(h // s) * int(w // s) for h, w in side
                               for s in tm[0].strides)
    _close_preds(got, want)


def test_ensemble_matches_jax(tiny, w025):
    """apply_ensemble of tiny and yolov7 at width 0.25 at 128 px, equal to
    JAX's within _close_preds."""
    x = np.random.default_rng(2).random((2, 128, 128, 3)).astype(np.float32)
    want = jax.jit(lambda x: jtta.apply_ensemble([tiny[0], w025[0]], x))(jnp.asarray(x))
    got = tta.apply_ensemble([tiny[1], w025[1]], torch.from_numpy(x))
    _close_preds(got, want)


def _images(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*hw, 3), np.uint8) for hw in SHAPES]


@pytest.mark.parametrize("extra", [False, True], ids=["tta", "tta_ignores_ensemble"])
def test_detector_tta_matches_jax(w025, tiny, extra):
    """Detector(augment=True) in fp32 on images of three sizes: the rows of
    JAX's Detector(augment=True), in original pixels (_same_rows). With
    extra_models both Detectors ignore the ensemble (the JAX Detector's
    `if augment ... elif extra`): the same rows."""
    (jm, tm) = w025
    jx = [(jm[0], *jm[1:])] if extra else []
    tx = [(tm[0], *tm[1:])] if extra else []
    jdet = JDetector(*jm, img_size=160, dtype=jnp.float32, augment=True, extra_models=jx)
    tdet = Detector(*tm, img_size=160, dtype=torch.float32, augment=True, extra_models=tx,
                    device="cpu")
    imgs = _images(3)
    want, got = jdet(imgs), tdet(imgs)
    assert sum(len(w) for w in want) > 3
    for g, w in zip(got, want):
        _same_rows(g, w)
