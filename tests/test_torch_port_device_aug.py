"""The port's device-augment tail against the JAX package on the CPU: the
resampling helpers, the host-side geometry and label math, the mosaic
compose, the HSV pair and `make_device_augment` (separable and gather,
plain and mosaic) on the same inputs; the loader's device-tail batches
(bit-equal for a seed); one trainer step with `device_aug=True` from the
same state."""

import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import yolo_series_tpu.data.datasets as JD
import yolo_series_tpu.data.device_aug as J
import yolo_series_tpu_torch.data.datasets as PD
import yolo_series_tpu_torch.data.device_aug as P
from tests._torch_port_util import training_cfg
from tests.test_torch_port_train import STEP_STATE_REL, STEP_UPDATE_L2
from tests.test_torch_port_trainer import (LOSS_RTOL, NC, SIZE, WIDTH, _snapshot,
                                           _tree_rel_l2, _update_l2, _write_set)
from yolo_series_tpu.models.model import Model as JModel
from yolo_series_tpu.train import checkpoints as jck
from yolo_series_tpu.train import optim as joptim
from yolo_series_tpu.train import step as jstep
from yolo_series_tpu.train import trainer as jtrainer
from yolo_series_tpu_torch.train import checkpoints as ck
from yolo_series_tpu_torch.train import trainer

torch.set_num_threads(2)

S, B = 64, 3
# One level of the uint8 warp output: the port and JAX sum the same taps in
# another order (or with another fused multiply-add), so a value within an
# ulp of .5 may round the other way.
LEVEL = 1 / 255 + 1e-6
# After the HSV jitter a one-level difference of an input channel moves an
# output channel by up to the S or V gain (at most 1.7 with the default
# hyps) levels: two levels.
TAIL_TOL = 2 / 255 + 1e-6
# Away from those boundary pixels the two agree to float rounding: at most
# 1% of the values differ by more than 1e-5.
NOISE, NOISE_SHARE = 1e-5, 0.01
# The device-aug step's loss items and update against JAX's on the same
# images. The mosaics' flat 114 borders put the step on max-pool ties and
# OTA assignments that float rounding flips: on this batch the port's own
# step moves its update by 0.89% (relative L2) and a loss item by 2e-5
# when 1e-6 of noise is added to the images, and JAX's step differs from
# the port's by 1.48% and 1.5e-4 (obj, 1.2e-3 absolute). So the update is
# held at twice test_torch_port_train's STEP_UPDATE_L2 and the loss items
# at 5x test_torch_port_trainer's LOSS_RTOL; a wrong image, label or
# parameter moves them by 1% or more.
AUG_LOSS_RTOL, AUG_UPDATE_L2 = 5 * LOSS_RTOL, 2 * STEP_UPDATE_L2


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def test_resize_and_scale_and_translate_match_jax():
    """`resize_bilinear` against jax.image.resize (bilinear, no antialias)
    at TTA's ratios on a non-square input, and `scale_and_translate`
    against JAX's on a scale and a fractional shift: the same weights, so
    within 1e-6 (fp32 sums of 2 x 2 taps in another order)."""
    rng = np.random.default_rng(0)
    x = rng.random((2, 128, 192, 3)).astype(np.float32)
    for r in (0.83, 0.67):
        hw = (int(128 * r), int(192 * r))
        want = jax.image.resize(jnp.asarray(x), (2, *hw, 3), "bilinear", antialias=False)
        got = P.resize_bilinear(torch.from_numpy(x), hw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    img = rng.integers(0, 256, (64, 80, 3)).astype(np.float32) - 114
    sc, tr = np.array([1 / 0.7, 1 / 1.3], np.float32), np.array([3.3, -5.1], np.float32)
    want = jax.image.scale_and_translate(jnp.asarray(img), (50, 60, 3), (0, 1), sc, tr,
                                         "linear", antialias=False)
    got = P.scale_and_translate(*_t(img), (50, 60), *_t(sc, tr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_geometry_and_label_math_equal_jax():
    """sample_perspective_params, warp_labels, mosaic4_geometry and
    invert_affine: equal to JAX's, bit for bit, from generators seeded
    alike."""
    rng = np.random.default_rng(1)
    for seed in range(4):
        args = (10.0 * (seed % 2), 0.2, 0.9, 2.0 * (seed % 2), 0.0, (-S // 2, -S // 2),
                (2 * S, 2 * S))
        jm, js, jhw = J.sample_perspective_params(*args, rng=random.Random(seed))
        pm, ps, phw = P.sample_perspective_params(*args, rng=random.Random(seed))
        np.testing.assert_array_equal(pm, jm)
        assert (ps, phw) == (js, jhw)
        xy = rng.uniform(0, 2 * S, (6, 2, 2))
        tg = np.concatenate([rng.integers(0, 3, (6, 1)), xy.min(1), xy.max(1)], 1)
        np.testing.assert_array_equal(P.warp_labels(tg.copy(), pm, ps, phw),
                                      J.warp_labels(tg.copy(), jm, js, jhw))
        np.testing.assert_array_equal(P.invert_affine(pm), J.invert_affine(jm))
        hw = [tuple(int(v) for v in rng.integers(S // 2, S + 1, 2)) for _ in range(4)]
        yc, xc = (int(v) for v in rng.integers(S // 2, 3 * S // 2, 2))
        for g, w in zip(P.mosaic4_geometry(hw, S, yc, xc), J.mosaic4_geometry(hw, S, yc, xc)):
            np.testing.assert_array_equal(g, w)
    assert len(P.warp_labels(np.zeros((0, 5)), pm, ps, phw)) == 0


def _mosaic_inputs(seed=2):
    """B samples of 4 noise tiles placed as mosaic4_geometry places them."""
    rng = np.random.default_rng(seed)
    tiles = rng.integers(0, 256, (B, 4, S, S, 3)).astype(np.uint8)
    origins = np.zeros((B, 4, 2), np.float32)
    centers = np.zeros((B, 2), np.float32)
    for b in range(B):
        hw = [tuple(int(v) for v in rng.integers(S // 2, S + 1, 2)) for _ in range(4)]
        yc, xc = (int(v) for v in rng.integers(S // 2, 3 * S // 2, 2))
        origins[b] = J.mosaic4_geometry(hw, S, yc, xc)[0]
        centers[b] = (yc, xc)
    return tiles, origins, centers


def test_mosaic_compose_uint8_equal_to_jax():
    ins = _mosaic_inputs()
    want = np.asarray(J.make_mosaic_compose(S)(*ins))
    got = P.make_mosaic_compose(S)(*_t(*ins))
    assert got.dtype == torch.uint8 and got.shape == (B, 2 * S, 2 * S, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_hsv_pair_matches_jax():
    """The cv2-convention HSV pair on float RGB (grey pixels included):
    within 1e-4 of JAX's (fp32 division and remainder, values up to 255)."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (32, 32, 3)).astype(np.float32)
    img[0, :4] = 77.0   # grey: no chroma
    want = J._rgb_to_hsv_cv(jnp.asarray(img))
    got = P.rgb_to_hsv_cv(torch.from_numpy(img))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)
    back = P.hsv_to_rgb_cv(*got)
    np.testing.assert_allclose(back.numpy(), np.asarray(J._hsv_to_rgb_cv(*want)),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(back.numpy(), img, rtol=0, atol=1e-3)


def _aug_params(separable, seed=4):
    rng = np.random.default_rng(seed)
    minv = np.stack([J.invert_affine(J.sample_perspective_params(
        0.0 if separable else 10.0, 0.2, 0.9, 0.0 if separable else 3.0, 0.0,
        (-S // 2, -S // 2), (2 * S, 2 * S), rng=random.Random(seed + b))[0])
        for b in range(B)])
    hsv = (rng.uniform(-1, 1, (B, 3)) * [0.015, 0.7, 0.4] + 1).astype(np.float32)
    flips = np.array([[True, False], [False, True], [True, True]])
    return minv, hsv, flips, np.array([1, 0, 2], np.int32), np.array([0.4, 0.6, 1.0],
                                                                    np.float32)


def _check_close(got, want, tol):
    d = np.abs(got - want)
    assert d.max() <= tol, d.max()
    assert (d > NOISE).mean() <= NOISE_SHARE, (d > NOISE).mean()


@pytest.mark.parametrize("mosaic", [False, True], ids=["plain", "mosaic"])
@pytest.mark.parametrize("separable", [True, False], ids=["separable", "gather"])
def test_device_augment_matches_jax(separable, mosaic):
    """make_device_augment in its four forms on the same inputs: first with
    identity HSV gains, no flips and no mixup, where the output is the
    rounded warp through the HSV round trip (within LEVEL of JAX's), then
    with the drawn gains, flips and mixup (within TAIL_TOL); values off by
    more than NOISE stay under NOISE_SHARE."""
    tiles, origins, centers = _mosaic_inputs()
    ins = (tiles, origins, centers) if mosaic else (
        np.asarray(J.make_mosaic_compose(S)(tiles, origins, centers)),)
    jfn = J.make_device_augment(S, 2 * S, separable=separable, mosaic=mosaic)
    pfn = P.make_device_augment(S, 2 * S, separable=separable, mosaic=mosaic)
    minv, hsv, flips, mix_idx, mix_w = _aug_params(separable)
    plain = (minv, np.ones_like(hsv), np.zeros_like(flips), np.arange(B, dtype=np.int32),
             np.ones_like(mix_w))
    for params, tol in ((plain, LEVEL), ((minv, hsv, flips, mix_idx, mix_w), TAIL_TOL)):
        want = np.asarray(jfn(*ins, *params))
        got = pfn(*_t(*ins, *params))
        assert got.dtype == torch.float32 and got.shape == (B, S, S, 3)
        _check_close(got.numpy(), want, tol)


# -- the loader's device tail --------------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("device_tail")
    _write_set(root, 6, 5, ((96, 128), (128, 80), (100, 100)))
    return root


TAIL_CASES = {
    # 80% 4-tile mosaics composed on the device, 20% mosaic9 on the host
    "mosaic": {"mixup": 1.0},
    "letterbox": {"mosaic": 0.0, "flipud": 0.5},
    "copy_paste": {"copy_paste": 0.5, "degrees": 5.0},
}


@pytest.mark.parametrize("case", sorted(TAIL_CASES))
def test_device_batches_bit_equal_to_jax(tree, case):
    """Two epochs of batches of 3 from the JAX loader (global random and
    np.random seeded) and the port's (its dataset's generators seeded
    alike): every field equal, bit for bit."""
    random.seed(6)
    np.random.seed(6)
    kw = dict(img_size=S, augment=True, hyp=TAIL_CASES[case], device_tail=True)
    jds = JD.DetectionDataset(str(tree / "images"), **kw)
    pds = PD.DetectionDataset(str(tree / "images"), seed=6, **kw)
    want = [{k: np.array(v) for k, v in b.items()} for _ in range(2)
            for b in JD.create_loader(jds, batch_size=3, max_labels=24, seed=1)]
    got = [{k: np.array(v) for k, v in b.items()} for _ in range(2)
           for b in PD.create_loader(pds, batch_size=3, max_labels=24, seed=1)]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"tiles", "origins", "centers", "minv", "hsv",
                                        "flips", "mix_idx", "mix_w", "labels", "label_mask"}
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert pds.rng.random() == random.random()


# -- one trainer step ------------------------------------------------------


@pytest.fixture(scope="module")
def step_set(tmp_path_factory):
    """Two training images, a data.yaml (no val), the model cfg and a
    checkpoint the JAX package wrote from its own init (seed 4)."""
    root = tmp_path_factory.mktemp("aug_step")
    _write_set(root / "train", 2, 7, ((96, 128), (128, 112)))
    data = root / "data.yaml"
    data.write_text(yaml.dump({"train": str(root / "train" / "images"), "nc": NC,
                               "names": ["a", "b", "c"]}))
    cfg = training_cfg(WIDTH, nc=NC)
    (root / "cfg.yaml").write_text(yaml.dump(cfg))
    m = JModel.from_yaml(cfg, key=jax.random.PRNGKey(4))
    ts = jstep.init_train_state(m.params, m.state, joptim.OptimConfig())
    jck.save_checkpoint(str(root / "init.ckpt"), ts, cfg)
    return root, str(data), str(root / "cfg.yaml"), str(root / "init.ckpt")


def _spy_steps(monkeypatch, module, fn):
    """Wrap every step `module.make_train_step` builds: its images pass
    through fn(images) first."""
    real = module.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)
        return lambda ts, images, *rest: step(ts, fn(images), *rest)

    monkeypatch.setattr(module, "make_train_step", make)


def test_device_aug_train_step_matches_jax(step_set, tmp_path, monkeypatch):
    """The first optimizer step of both trainers with device_aug=True (one
    epoch of one batch of 2, fp32, the default hyp: the separable warp on
    mosaics). The batch's tiles and parameters are the same draws, and the
    images each trainer's device tail makes agree within TAIL_TOL; the
    port's step then takes JAX's images, and from the same state on the
    same batch the loss items are within AUG_LOSS_RTOL, BN state within
    STEP_STATE_REL and the update within AUG_UPDATE_L2."""
    root, data, cfg, weights = step_set
    common = dict(cfg=cfg, data=data, epochs=1, batch_size=2, img_size=SIZE,
                  nominal_batch_size=2, weights=weights, max_labels=16, noval=True,
                  seed=0, device_aug=True, autoanchor=False)
    snaps, images = {}, {}

    def keep(x):
        images.setdefault("jax", np.array(x))
        return x

    def swap(x):
        images.setdefault("port", x.numpy().copy())
        return torch.from_numpy(images["jax"])

    random.seed(0)
    np.random.seed(0)
    _spy_steps(monkeypatch, jtrainer, keep)
    jout = jtrainer.train(
        jtrainer.TrainConfig(save_dir=str(tmp_path / "j"), compute_dtype=jnp.float32,
                             fast_stem=False, **common),
        callbacks={"on_epoch_end": lambda e, r, ts: snaps.setdefault("jax", _snapshot(ts))})
    _spy_steps(monkeypatch, trainer, swap)
    pout = trainer.train(
        trainer.TrainConfig(save_dir=str(tmp_path / "p"), compute_dtype=torch.float32,
                            device="cpu", **common),
        callbacks={"on_epoch_end": lambda e, r, ts: snaps.setdefault("port", _snapshot(ts))})
    assert images["port"].dtype == images["jax"].dtype == np.float32
    assert images["port"].shape == images["jax"].shape == (2, SIZE, SIZE, 3)
    _check_close(images["port"], images["jax"], TAIL_TOL)
    for k in ("box", "obj", "cls", "total"):
        np.testing.assert_allclose(pout["results"][0][f"train/{k}"],
                                   jout["results"][0][f"train/{k}"], rtol=AUG_LOSS_RTOL)
    got, want = snaps["port"], snaps["jax"]
    assert got["step"] == int(want["step"]) == 1
    for k in ("state", "ema_state"):
        assert _tree_rel_l2(got[k], want[k]) <= STEP_STATE_REL, k
    blob = jck.load_checkpoint(weights)
    before = jax.tree_util.tree_map(lambda a: a.astype(np.float32), blob["params"])
    err = _update_l2(ck.from_jax_tree(got["params"]), want["params"], before)
    assert err <= AUG_UPDATE_L2, err
    assert Path(pout["save_dir"], "weights", "last.ckpt").exists()
