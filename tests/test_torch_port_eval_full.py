"""The port's fp32 eval at full size against the JAX package on the CPU:
the `pred` of `eval/evaluator.evaluate`'s forward (yolov7 training form,
IDetect, full width, one 640 x 640 frame, fp32 under `device.full_fp32`)
against JAX's `apply_model` on the same weights and frame. Boxes within
1e-5 of the largest |box| (2.4e-7 measured), objectness and class scores
within 1e-5 of their largest (4.8e-7 measured): fp32 sums of two
backends over 100+ layers."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from chip_smoke import first_pred
from tests._torch_port_util import port_drawn_model, training_cfg
from yolo_series_tpu.models.model import apply_model as japply
from yolo_series_tpu_torch.eval.evaluator import evaluate

torch.set_num_threads(4)


def test_full_size_fp32_eval_pred_matches_jax():
    jplan, params, state, tplan, tp, ts = port_drawn_model(training_cfg(1.0), seed=21,
                                                           stats_seed=22)
    imgs = np.random.default_rng(0).integers(0, 256, (1, 640, 640, 3), np.uint8)
    batch = {"images": imgs, "labels": np.zeros((1, 1, 5), np.float32),
             "label_mask": np.zeros((1, 1), bool), "shapes": [None], "paths": ["0.jpg"]}
    with first_pred() as pred:
        evaluate(tplan, tp, ts, [batch], device="cpu")
    got = pred[0].numpy()
    want, _ = japply(jplan, jax.tree_util.tree_map(jnp.asarray, params),
                     jax.tree_util.tree_map(jnp.asarray, state),
                     jnp.asarray(imgs.astype(np.float32) / 255.0))
    want = np.asarray(want["pred"])
    assert got.shape == want.shape == (1, 25200, 85)
    for part in (slice(0, 4), slice(4, 5), slice(5, None)):
        w = want[..., part]
        np.testing.assert_allclose(got[..., part], w, rtol=0, atol=1e-5 * np.abs(w).max())
