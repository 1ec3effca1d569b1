"""The port's losses against the JAX package on the CPU: the box geometry
of `ops/boxes`, `find_positive`, the plain YOLO loss and the SimOTA loss
(items, total, the assignment, the grads of the raw maps). Same numpy
inputs on both sides, fp32, 128 px maps of the yolov7 head, batch 2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_series_tpu.losses import LossHyp as JHyp
from yolo_series_tpu.losses import make_compute_loss as jloss
from yolo_series_tpu.losses import make_compute_loss_ota as jloss_ota
from yolo_series_tpu.losses.ota import _top_k_iter as jtop_k
from yolo_series_tpu.losses.ota import ota_assign_batch as jassign
from yolo_series_tpu.losses.targets import find_positive as jfind
from yolo_series_tpu.models.heads import IDetect as JIDetect
from yolo_series_tpu.ops import boxes as jboxes
from yolo_series_tpu_torch.losses import LossHyp, make_compute_loss, make_compute_loss_ota
from yolo_series_tpu_torch.losses.ota import _top_k_iter, ota_assign_batch
from yolo_series_tpu_torch.losses.targets import find_positive
from yolo_series_tpu_torch.models.heads import IDetect
from yolo_series_tpu_torch.ops import boxes as tboxes

torch.set_num_threads(2)

ANCHORS = ((12, 16, 19, 36, 40, 28), (36, 75, 76, 55, 72, 146),
           (142, 110, 192, 243, 459, 401))
STRIDES = (8.0, 16.0, 32.0)
IMG, BS, M = 128, 2, 24


def _heads(nc):
    an = tuple(tuple(a / s for a in row) for row, s in zip(ANCHORS, STRIDES))
    kw = dict(nc=nc, anchors=an, ch=(32, 64, 128), strides=STRIDES)
    return JIDetect(**kw), IDetect(**kw)


def _case(seed, nc=80, dup=True, pad_out=False):
    """Random raw maps (N(0, 1.5) logits) and up to 14 labels an image,
    padded to M rows. dup: rows 0 and 1 of an image share a centre (their
    candidates land on the same cells). pad_out: image 1 has no label."""
    rng = np.random.default_rng(seed)
    raw = [rng.normal(0, 1.5, (BS, 3, IMG // int(s), IMG // int(s), nc + 5)).astype(np.float32)
           for s in STRIDES]
    labels = np.zeros((BS, M, 5), np.float32)
    mask = np.zeros((BS, M), bool)
    for b in range(BS):
        if pad_out and b == 1:
            continue
        k = int(rng.integers(3, 15))
        xy = rng.uniform(0.05, 0.95, (k, 2))
        wh = rng.uniform(0.02, 0.6, (k, 2))
        if dup:
            xy[1], wh[1] = xy[0], wh[0] * 1.05
        labels[b, :k] = np.concatenate([rng.integers(0, nc, (k, 1)), xy, wh], 1)
        mask[b, :k] = True
        # padded rows hold stray values, which the mask must hide
        labels[b, k:] = rng.uniform(0, 1, (M - k, 5)) * [0, 1, 1, 1, 1]
    return raw, labels, mask


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------------ boxes ---

def _boxes(rng, n):
    xy = rng.uniform(0, 100, (n, 2))
    wh = rng.uniform(1, 60, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("name", ["xywh2xyxy", "xyxy2xywh", "xywhn2xyxy", "xyn2xy",
                                  "box_area", "box_iou", "wh_iou", "bbox_ioa",
                                  "scale_coords", "clip_coords"])
def test_box_functions_match_jax(name):
    """Each box function on the same inputs, within 1e-6 relative (the same
    fp32 operations)."""
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    args = {"xywh2xyxy": (a,), "xyxy2xywh": (a,), "xywhn2xyxy": (a / 100, 320, 240, 3, 5),
            "xyn2xy": (a[:, :2] / 100, 320, 240, 3, 5), "box_area": (a,),
            "box_iou": (a, b), "wh_iou": (a[:, 2:] - a[:, :2], b[:, 2:] - b[:, :2]),
            "bbox_ioa": (a[0], b), "scale_coords": ((128, 160), a, (300, 500)),
            "clip_coords": (a, (60, 80))}[name]
    want = getattr(jboxes, name)(*[jnp.asarray(x) if isinstance(x, np.ndarray) else x
                                   for x in args])
    got = getattr(tboxes, name)(*[_t(x) if isinstance(x, np.ndarray) else x for x in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("kind", ["iou", "giou", "diou", "ciou"])
def test_bbox_iou_values_and_grads_match_jax(kind):
    """bbox_iou on aligned xywh boxes (some disjoint, some touching, one
    pair identical, where CIoU's v is 0): values within 1e-6 and the
    grads of both boxes within 1e-5 of JAX's (CIoU's alpha detached on
    both sides)."""
    rng = np.random.default_rng(1)
    b1 = np.concatenate([rng.uniform(0, 10, (32, 2)), rng.uniform(0.2, 5, (32, 2))], 1)
    b2 = b1 + np.concatenate([rng.normal(0, 2, (32, 2)), rng.normal(0, 0.5, (32, 2))], 1)
    b2[:, 2:] = np.abs(b2[:, 2:]) + 0.1
    b2[0] = b1[0]
    b2[1] = b1[1] + [b1[1, 2], 0, 0, 0]         # touching edge
    b1, b2 = b1.astype(np.float32), b2.astype(np.float32)
    flags = {k: k == kind for k in ("giou", "diou", "ciou")}
    proj = rng.normal(0, 1, 32).astype(np.float32)

    def jf(x, y):
        v = jboxes.bbox_iou(x, y, xywh=True, **flags)
        return jnp.sum(v * proj), v

    (_, want), want_g = jax.value_and_grad(jf, (0, 1), has_aux=True)(jnp.asarray(b1),
                                                                      jnp.asarray(b2))
    x, y = _t(b1).requires_grad_(), _t(b2).requires_grad_()
    got = tboxes.bbox_iou(x, y, xywh=True, **flags)
    got_g = torch.autograd.grad((got * _t(proj)).sum(), (x, y))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(w)).max())


# ---------------------------------------------------------------- targets ---

@pytest.mark.parametrize("g", [0.5, 1.0])
def test_find_positive_matches_jax(g):
    """Every candidate field equal to JAX's (cells and validity exactly, the
    box targets within 1e-6), labels on and near the grid's edges."""
    _, labels, mask = _case(3)
    labels[0, 2, 1:3] = [0.999, 0.001]
    labels[0, 3, 1:3] = [1.0, 0.0]
    anchors = np.asarray(ANCHORS[1], np.float32).reshape(3, 2) / 16.0
    for grid in ((8, 8), (6, 10)):
        want = jfind(jnp.asarray(labels), jnp.asarray(mask), anchors, grid, 4.0, g=g)
        got = find_positive(_t(labels), _t(mask), anchors, grid, 4.0, g=g)
        for f in ("gi", "gj", "valid", "tcls"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
        np.testing.assert_allclose(got.tbox.numpy(), np.asarray(want.tbox), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got.anchors.numpy(), np.asarray(want.anchors))


def test_find_positive_constants_are_cached_with_their_old_values():
    """The loss's constants (the grid gain, the base of the inverted
    centres, the anchors, the offsets) come from a cache on the device:
    each equals, bit for bit, the tensor built from host numbers before,
    and a second call hands back the same objects, so a step copies
    nothing from the host."""
    from yolo_series_tpu_torch.losses.targets import _OFF, const_on
    cpu = torch.device("cpu")
    anchors = np.asarray(ANCHORS[1], np.float32).reshape(3, 2) / 16.0
    pairs = {"gain": ([10, 6, 10, 6], torch.tensor([10, 6, 10, 6], dtype=torch.float32)),
             "inv": ([10, 6], torch.tensor([10, 6], dtype=torch.float32)),
             "anchors": (anchors, torch.as_tensor(np.asarray(anchors, np.float32))),
             "off": (_OFF * np.float32(0.5), torch.as_tensor(_OFF * np.float32(0.5)))}
    for name, (x, want) in pairs.items():
        got = const_on(x, cpu)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), name
        assert const_on(x, cpu) is got, name
    _, labels, mask = _case(3)
    a, b = (find_positive(_t(labels), _t(mask), anchors, (6, 10), 4.0) for _ in range(2))
    assert a.anchors is b.anchors is const_on(anchors, cpu)


def test_top_k_iter_ties_match_jax():
    """The masked-argmax top-k on rows with ties: values and indices equal
    to JAX's (the first index wins each tie)."""
    x = np.random.default_rng(4).integers(0, 5, (6, 40)).astype(np.float32)
    x[2] = 1.0
    wv, wi = jtop_k(jnp.asarray(x), 10)
    gv, gi = _top_k_iter(_t(x), 10)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


# ------------------------------------------------------------------ losses ---

CASES = {
    # name: (seed, nc, hyp overrides, case options)
    "seed0": (0, 80, {}, {}),
    "seed1": (1, 80, {}, {}),
    "seed2_no_dup": (2, 80, {}, {"dup": False}),
    "padded_out": (3, 80, {}, {"pad_out": True}),
    "label_smoothing": (4, 80, {"label_smoothing": 0.1}, {}),
    "focal": (5, 80, {"fl_gamma": 1.5}, {}),
    "nc1": (6, 1, {}, {}),
    "gr_half_pw": (7, 80, {"gr": 0.5, "obj_pw": 1.3, "cls_pw": 0.8}, {}),
}


def _loss_case(name, ota):
    seed, nc, hyp, opts = CASES[name]
    jhead, thead = _heads(nc)
    raw, labels, mask = _case(seed, nc=nc, **opts)
    jf = (jloss_ota if ota else jloss)(jhead, JHyp(**hyp))
    tf = (make_compute_loss_ota if ota else make_compute_loss)(thead, LossHyp(**hyp))
    return raw, labels, mask, jf, tf


@pytest.mark.parametrize("ota", [False, True], ids=["plain", "ota"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_matches_jax(name, ota):
    """Loss items and total within 1e-5 relative of JAX's, and the grads of
    the raw maps within 1e-5 of each map's largest |grad|."""
    raw, labels, mask, jf, tf = _loss_case(name, ota)

    def jtotal(r):
        return jf(r, jnp.asarray(labels), jnp.asarray(mask))

    (want, witems), want_g = jax.value_and_grad(jtotal, has_aux=True)(
        [jnp.asarray(r) for r in raw])
    rt = [_t(r).requires_grad_() for r in raw]
    got, items = tf(rt, _t(labels), _t(mask))
    got_g = torch.autograd.grad(got, rt)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert set(items) == set(witems) == {"box", "obj", "cls"}
    for k in items:
        np.testing.assert_allclose(float(items[k].detach()), float(witems[k]), rtol=1e-5,
                                   atol=1e-7)
    for g, w in zip(got_g, want_g):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
    assert float(items["box"].detach()) > 0 or name == "padded_out"


@pytest.mark.parametrize("name", sorted(CASES))
def test_ota_assignment_equals_jax(name):
    """ota_assign_batch's fg and matched_gt equal to JAX's on every
    candidate column."""
    raw, labels, mask, _, _ = _loss_case(name, True)
    nc = raw[0].shape[-1] - 5
    anchors = np.asarray(_heads(nc)[0].anchors, np.float32).reshape(3, 3, 2)
    strides = np.asarray(STRIDES, np.float32)
    jfg, jmg, joffs = jassign([jnp.asarray(r) for r in raw], jnp.asarray(labels),
                              jnp.asarray(mask), anchors, strides, JHyp(), 0.5, 10)
    fg, mg, offs = ota_assign_batch([_t(r) for r in raw], _t(labels), _t(mask), anchors,
                                    strides, LossHyp(), 0.5, 10)
    np.testing.assert_array_equal(fg.numpy(), np.asarray(jfg))
    np.testing.assert_array_equal(mg.numpy(), np.asarray(jmg))
    np.testing.assert_array_equal(offs, joffs)
    assert fg.any()
