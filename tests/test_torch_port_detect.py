"""The port's detect slice against the JAX package on the CPU: IDetect and
its implicit layers, `reparam.fuse_head_implicit`, checkpoints written by
the JAX trainer, `Detector`, the detect CLI, the host and device
letterbox, and the input sources. Same numpy inputs and weights on both
sides, fp32, small widths and sizes."""

import shutil
from pathlib import Path
from types import SimpleNamespace

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_util import jax_model, to_numpy, training_cfg
from yolo_series_tpu.data.augment import letterbox as jletterbox
from yolo_series_tpu.data.device_aug import make_device_letterbox as jdevice_letterbox
from yolo_series_tpu.infer.detector import Detector as JDetector
from yolo_series_tpu.models import reparam as jreparam
from yolo_series_tpu.models.model import apply_model as japply
from yolo_series_tpu.train.checkpoints import load_checkpoint_any as jload
from yolo_series_tpu.train.checkpoints import save_checkpoint
from yolo_series_tpu_torch.data.augment import letterbox
from yolo_series_tpu_torch.data.device_aug import make_device_letterbox
from yolo_series_tpu_torch.infer.detector import Detector, draw_detections
from yolo_series_tpu_torch.infer.sources import LoadImages, LoadStreams
from yolo_series_tpu_torch.models import graph as tgraph
from yolo_series_tpu_torch.models import heads as theads
from yolo_series_tpu_torch.models import reparam as treparam
from yolo_series_tpu_torch.models.convert import from_jax_params
from yolo_series_tpu_torch.models.model import apply_model
from yolo_series_tpu_torch.ops import nms_keep
from yolo_series_tpu_torch.train import checkpoints as tckpt

torch.set_num_threads(2)

WIDTH, SIZE = 0.25, 128
# BGR images of several shapes, letterboxed to SIZE by the Detector
SHAPES = ((100, 150), (128, 128), (90, 200))


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def training():
    """yolov7 training form (IDetect) at width 0.25, livened, in both
    packages with the same weights (unfused)."""
    plan, params, state = jax_model(WIDTH, seed=3, size=SIZE, candidates=60,
                                    cfg=training_cfg(WIDTH))
    tplan = tgraph.compile_graph(training_cfg(WIDTH))
    tp, ts = from_jax_params(tplan, params, state)
    return plan, params, state, tplan, tp, ts


@pytest.fixture(scope="module")
def ckpt(training, tmp_path_factory):
    """A checkpoint the JAX trainer's `save_checkpoint` writes (fp16
    weights, EMA weights that differ from the raw ones)."""
    plan, params, state, *_ = training
    ema = jax.tree_util.tree_map(lambda a: np.asarray(a) * np.float32(1.01), params)
    ts = SimpleNamespace(step=7, params=_jax(params), state=_jax(state),
                         ema_params=_jax(ema), ema_state=_jax(state), opt_state={})
    path = tmp_path_factory.mktemp("ckpt") / "last.ckpt"
    save_checkpoint(str(path), ts, training_cfg(WIDTH), epoch=3)
    return str(path)


def _images(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*hw, 3), np.uint8) for hw in SHAPES]


def _close_forward(got, want):
    """A whole-model forward against JAX's: ~100 fp32 convs whose sums run in
    another order (the tolerance of tests/test_torch_port_graph.py)."""
    for g, w in zip(got["raw"], want["raw"]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())
    pred, want_pred = got["pred"].numpy(), np.asarray(want["pred"])
    np.testing.assert_allclose(pred[..., :4], want_pred[..., :4], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(pred[..., 4:], want_pred[..., 4:], rtol=0, atol=1e-4)


def test_idetect_head_matches_jax(training):
    """IDetect alone, with its implicit layers, on the same numpy features:
    raw maps and decoded pred within rtol 1e-5 of each map's largest value
    (a logit near 0 is a sum that cancels)."""
    from yolo_series_tpu.models.layers import Ctx as JCtx
    from yolo_series_tpu_torch.models.layers import Ctx

    plan, params, _, tplan, tp, _ = training
    head, thead = plan.head, tplan.head
    assert type(thead) is theads.IDetect and {"ia", "im"} <= set(tp["layers"][-1])
    rng = np.random.default_rng(0)
    feats = [rng.normal(0, 1, (2, int(SIZE / s), int(SIZE / s), c)).astype(np.float32)
             for c, s in zip(head.ch, head.strides)]
    want, _ = head.apply(_jax(params["layers"][-1]), {}, [jnp.asarray(f) for f in feats],
                         JCtx(dtype=jnp.float32, training=False))
    got, _ = thead.apply(tp["layers"][-1], {},
                         [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats],
                         Ctx(torch.float32))
    for g, w in zip([got["pred"]] + got["raw"], [want["pred"]] + want["raw"]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())


def test_training_model_forward_matches_jax(training):
    """The whole training-form model (IDetect head), unfused."""
    plan, params, state, tplan, tp, ts = training
    x = np.random.default_rng(0).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    want, _ = japply(plan, _jax(params), _jax(state), jnp.asarray(x))
    got, _ = apply_model(tplan, tp, ts, torch.from_numpy(x))
    _close_forward(got, want)


def test_implicit_layers_match_jax():
    from yolo_series_tpu.models import layers as jlayers
    from yolo_series_tpu_torch.models import layers as tlayers

    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 5, 6, 16)).astype(np.float32)       # NHWC
    v = rng.normal(1, 0.1, (16,)).astype(np.float32)
    for jb, tb in ((jlayers.ImplicitA(16), tlayers.ImplicitA(16)),
                   (jlayers.ImplicitM(16), tlayers.ImplicitM(16))):
        want, _ = jb.apply({"v": jnp.asarray(v)}, {}, jnp.asarray(x), None)
        got, _ = tb.apply({"v": torch.from_numpy(v)}, {},
                          torch.from_numpy(x).permute(0, 3, 1, 2), None)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))
    gen = torch.Generator().manual_seed(0)
    assert tlayers.ImplicitA(8).init(gen)[0]["v"].abs().max() < 0.2
    assert (tlayers.ImplicitM(8).init(gen)[0]["v"] - 1).abs().max() < 0.2


def test_fuse_head_implicit_matches_jax(training):
    """fuse_model on the training plan folds ia / im into the head's convs:
    the fused trees equal JAX's fused trees (OIHW against HWIO, rtol
    1e-6), the head keeps no implicit leaves, and the fused forward equals
    the unfused one."""
    plan, params, state, tplan, tp, ts = training
    jp, js = jreparam.fuse_model(plan, _jax(params), _jax(state))
    fp, fs = treparam.fuse_model(tplan, tp, ts)
    head_j, head_t = to_numpy(jp["layers"][-1]), fp["layers"][-1]
    assert set(head_t) == {"m"} and set(head_j) == {"m"}
    for mj, mt in zip(head_j["m"], head_t["m"]):
        np.testing.assert_allclose(mt["w"].permute(2, 3, 1, 0).numpy(), mj["w"],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(mt["b"].numpy(), mj["b"], rtol=1e-6, atol=1e-6)
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (1, SIZE, SIZE, 3)).astype(np.float32))
    unfused, _ = apply_model(tplan, tp, ts, x)
    fused, _ = apply_model(tplan, fp, fs, x)
    np.testing.assert_allclose(fused["pred"].numpy(), unfused["pred"].numpy(),
                               rtol=1e-4, atol=1e-3)
    assert treparam.fuse_head_implicit(tplan.head, head_t) is head_t


def test_checkpoint_params_equal_jax_loader(training, ckpt):
    """The port reads a JAX-written checkpoint: the EMA trees by default
    (the raw ones with prefer_ema=False), fp16 cast to fp32, equal to what
    the JAX loader returns; the same forward."""
    plan, params, state, tplan, *_ = training
    for ema in (True, False):
        jplan, jp, js = jload(ckpt, prefer_ema=ema)
        tplan2, tp, ts = tckpt.load_checkpoint_any(ckpt, prefer_ema=ema)
        assert type(tplan2.head) is theads.IDetect
        want_p, want_s = from_jax_params(tplan2, to_numpy(jp), to_numpy(js))
        for a, b in zip(jax.tree_util.tree_leaves(want_p), jax.tree_util.tree_leaves(tp)):
            assert b.dtype == torch.float32 and torch.equal(a, b)
        for a, b in zip(jax.tree_util.tree_leaves(want_s), jax.tree_util.tree_leaves(ts)):
            assert torch.equal(a, b)
    x = np.random.default_rng(4).uniform(0, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    want, _ = japply(jplan, jp, js, jnp.asarray(x))
    got, _ = apply_model(tplan2, tp, ts, torch.from_numpy(x))
    _close_forward(got, want)


def test_checkpoint_refuses_what_it_cannot_read(tmp_path):
    # a reference .pt reads through the torch importer, which needs the cfg
    # (tests/test_torch_port_bridge.py)
    with pytest.raises(ValueError, match="--cfg is required"):
        tckpt.load_checkpoint_any(str(tmp_path / "yolov7.pt"))
    bad = tmp_path / "x.ckpt"
    import pickle

    bad.write_bytes(pickle.dumps({"format": "other"}))
    with pytest.raises(ValueError, match="not a yolo-series-tpu checkpoint"):
        tckpt.load_checkpoint(str(bad))


def _same_rows(got, want):
    """Detection rows of one image: the same count, order and classes;
    boxes and scores within the whole-model forward's tolerance (pred
    boxes 1e-4 relative; obj and class 1e-4 each, so 2e-4 for their
    product, the score), boxes scaled to the source image (up to 200 px
    here, so 1e-4 x 200 px)."""
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got[:, 5], want[:, 5])
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=1e-4, atol=2e-2)
    np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=0, atol=2e-4)


@pytest.mark.parametrize("kw", [{}, {"classes": (0, 3, 7)}], ids=["default", "classes"])
def test_detector_from_checkpoint_matches_jax(ckpt, kw):
    """A JAX-written checkpoint, fused, through both Detectors (fp32, fast
    stem on both sides, the port on the CPU): the same rows on images of
    several sizes, in original pixels; the CPU runs the plain keep-mask."""
    imgs = _images(5)
    jdet = JDetector.from_checkpoint(ckpt, img_size=SIZE, dtype=jnp.float32, **kw)
    tdet = Detector.from_checkpoint(ckpt, img_size=SIZE, dtype=torch.float32,
                                    device="cpu", **kw)
    assert [type(s.block).__name__ for s in tdet.plan.layers][:2] == ["PhasedConv"] * 2
    launches = (nms_keep.nms_keep_mask.launches, nms_keep.nms_keep_mask_large.launches)
    want, got = jdet(imgs), tdet(imgs)
    assert launches == (nms_keep.nms_keep_mask.launches,
                        nms_keep.nms_keep_mask_large.launches)
    assert sum(len(w) for w in want) > 3
    for g, w, hw in zip(got, want, SHAPES):
        _same_rows(g, w)
        assert (g[:, [0, 2]] <= hw[1]).all() and (g[:, [1, 3]] <= hw[0]).all()
    if "classes" in kw:
        assert set(np.concatenate(got)[:, 5].astype(int)) <= {0, 3, 7}
    single = tdet(imgs[0])
    _same_rows(single, got[0])
    res = tdet.predict(imgs, paths=[f"im{i}.jpg" for i in range(3)])
    assert len(res) == 3 and "detections" in str(res)


def test_detector_refuses_tta(training):
    """TTA refuses the ensemble, as the JAX Detector does: with
    augment=True the Detector runs the three passes of its own model and
    ignores extra_models, and on the CPU it skips the fast stem. (Its
    detections against JAX's: tests/test_torch_port_tta.py.)"""
    *_, tplan, tp, ts = training
    fp, fs = treparam.fuse_model(tplan, tp, ts)
    det = Detector(tplan, fp, fs, img_size=SIZE, dtype=torch.float32, augment=True,
                   extra_models=[(tplan, fp, fs)], device="cpu")
    assert det.extra == []
    assert "PhasedConv" not in {type(s.block).__name__ for s in det.plan.layers}
    pred = det._forward(torch.rand(1, SIZE, SIZE, 3, generator=torch.Generator().manual_seed(0)))
    side = [-(-SIZE * r // 32) * 32 for r in (1.0, 0.83, 0.67)]
    assert pred.shape[1] == sum(3 * (p // st) ** 2 for p in side for st in tplan.strides)


def test_detector_ensemble_concatenates_preds(training):
    """extra_models: the predictions of every model join before NMS, as
    the JAX Detector's ensemble does."""
    plan, params, state, tplan, tp, ts = training
    jp, js = jreparam.fuse_model(plan, _jax(params), _jax(state))
    fp, fs = treparam.fuse_model(tplan, tp, ts)
    imgs = _images(6)[:2]
    jdet = JDetector(plan, jp, js, img_size=SIZE, dtype=jnp.float32,
                     extra_models=[(plan, jp, js)])
    tdet = Detector(tplan, fp, fs, img_size=SIZE, dtype=torch.float32, device="cpu",
                    extra_models=[(tplan, fp, fs)])
    for g, w in zip(tdet(imgs), jdet(imgs)):
        _same_rows(g, w)


def test_cli_detect_on_an_image_folder(ckpt, tmp_path):
    """`python -m yolo_series_tpu_torch.cli.detect --device cpu` on a
    folder of synthetic images: annotated images and txt labels, whose rows
    are the Detector's."""
    from yolo_series_tpu_torch.cli import detect as cli

    src = tmp_path / "imgs"
    src.mkdir()
    imgs = _images(7)
    for i, im in enumerate(imgs):
        cv2.imwrite(str(src / f"img{i}.png"), im)
    save_dir = cli.main(["--weights", ckpt, "--source", str(src), "--img-size",
                         str(SIZE), "--device", "cpu", "--save-txt", "--save-conf", "--project", str(tmp_path / "runs"),
                         "--name", "exp"])
    assert sorted(p.name for p in Path(save_dir).glob("*.png")) == \
        [f"img{i}.png" for i in range(3)]
    det = Detector.from_checkpoint(ckpt, img_size=SIZE, device="cpu")   # bf16, as the CLI
    for i, im in enumerate(imgs):
        rows = det(im)
        txt = (Path(save_dir) / "labels" / f"img{i}.txt").read_text().split("\n")
        lines = [ln for ln in txt if ln]
        assert len(lines) == len(rows)
        for ln, r in zip(lines, rows):
            vals = [float(v) for v in ln.split()]
            h0, w0 = im.shape[:2]
            assert int(vals[0]) == int(r[5]) and abs(vals[5] - r[4]) < 1e-5
            assert abs(vals[1] - (r[0] + r[2]) / 2 / w0) < 1e-5
    # --update strips the weights in place after the run: the same file as
    # the JAX package's strip_checkpoint writes
    from yolo_series_tpu.train.checkpoints import strip_checkpoint as jstrip

    mine, ref = tmp_path / "mine.ckpt", tmp_path / "ref.ckpt"
    shutil.copyfile(ckpt, mine)
    shutil.copyfile(ckpt, ref)
    cli.main(["--weights", str(mine), "--source", str(src), "--img-size", str(SIZE),
              "--device", "cpu", "--nosave", "--update", "--project", str(tmp_path / "runs"),
              "--name", "upd"])
    jstrip(str(ref))
    assert mine.read_bytes() == ref.read_bytes() != Path(ckpt).read_bytes()


@pytest.mark.parametrize("hw,kw", [((100, 150), {}), ((90, 200), {"auto": False}),
                                   ((333, 250), {"auto": False, "scaleup": False}),
                                   ((64, 48), {"auto": False}),
                                   ((70, 130), {"auto": False, "scale_fill": True})])
def test_host_letterbox_equals_jax(hw, kw):
    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), np.uint8)
    got = letterbox(img, SIZE, **kw)
    want = jletterbox(img, SIZE, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


@pytest.mark.parametrize("hw,dst", [((720, 1280), 128), ((100, 37), 64), ((48, 64), 160),
                                    ((333, 250), 128)])
def test_device_letterbox_within_one_of_jax(hw, dst):
    """F.interpolate(bilinear, half-pixel centres) against
    jax.image.resize(bilinear, antialias=False): the same geometry and
    ratio; pixels within 1 (a sum that lands within an ulp of .5 may round
    the other way), on at most 0.1% of them."""
    x = np.random.default_rng(dst).integers(0, 256, (2, *hw, 3), np.uint8)
    jfn, jr, jpad = jdevice_letterbox(hw, dst=dst)
    tfn, tr, tpad = make_device_letterbox(hw, dst=dst)
    assert (tr, tpad) == (jr, jpad)
    want = np.asarray(jfn(jnp.asarray(x))).astype(int)
    got = tfn(torch.from_numpy(x)).numpy().astype(int)
    assert got.shape == want.shape == (2, dst, dst, 3)
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_load_images_letterboxes_each_file(tmp_path):
    from yolo_series_tpu.infer.sources import LoadImages as JLoadImages

    for i, hw in enumerate(SHAPES):
        cv2.imwrite(str(tmp_path / f"a{i}.jpg"),
                    np.random.default_rng(i).integers(0, 256, (*hw, 3), np.uint8))
    (tmp_path / "notes.txt").write_text("not an image")
    got, want = list(LoadImages(str(tmp_path), img_size=SIZE)), \
        list(JLoadImages(str(tmp_path), img_size=SIZE))
    assert len(got) == len(want) == 3
    for (p, img, img0, cap, ratio, dwdh), w in zip(got, want):
        assert p == w[0] and cap is None and (ratio, dwdh) == (w[4], w[5])
        assert img.shape == (SIZE, SIZE, 3) and img.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(img, w[1])
        np.testing.assert_array_equal(img0, w[2])
    with pytest.raises(FileNotFoundError):
        LoadImages(str(tmp_path / "missing"))


def test_load_streams_retrieves_every_fourth_frame(tmp_path):
    """Two streams backed by one video file: the primer read takes frame 0;
    each retrieval is the 4th grabbed frame. Waits are bounded event waits
    on the grabber's frame counter, not sleeps."""
    video = tmp_path / "cam.mp4"
    w = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 48))
    assert w.isOpened()
    for i in range(30):
        f = np.zeros((48, 64, 3), np.uint8)
        f[:, :, 0] = i * 8
        w.write(f)
    w.release()
    txt = tmp_path / "streams.txt"
    txt.write_text(f"{video}\n{video}\n")
    ls = LoadStreams(str(txt), img_size=64, stride=32)
    try:
        assert len(ls.sources) == 2
        # the primer is frame 0 until the stream's grabber retrieves one (it
        # starts as the stream opens, so a loaded host may see stream 0's
        # first retrieval before stream 1 is open): read both under its lock
        with ls._new_frame:
            first = [(int(round(im[:, :, 0].mean() / 8)), n)
                     for im, n in zip(ls.imgs, ls.frames)]
        assert all(x == 0 if n == 0 else x == 4 * n for x, n in first), first
        for i in range(2):
            assert ls.wait_frames(i, 1, timeout=30.0), "no frame retrieved"
        with ls._new_frame:
            idx = [int(round(im[:, :, 0].mean() / 8)) for im in ls.imgs]
            n = list(ls.frames)
        # frame k of a stream is grabbed frame 4 k (frame 0 was the primer)
        assert all(x % 4 == 0 and x > 0 for x in idx), idx
        assert all(x <= 4 * m for x, m in zip(idx, n)), (idx, n)
        srcs, imgs, img0, _cap, ratios, dwdhs = next(iter(ls))
        assert imgs.shape == (2, 64, 64, 3) and imgs.dtype == np.uint8
        assert len(img0) == 2 and img0[0].shape == (48, 64, 3)
        assert len(ratios) == len(dwdhs) == 2
    finally:
        ls.close()
    assert all(not t.is_alive() for t in ls.threads)
    assert not ls.wait_frames(0, 10 ** 6, timeout=0.01)


def test_draw_detections_marks_the_boxes():
    im = np.zeros((64, 64, 3), np.uint8)
    det = np.array([[10, 10, 40, 40, 0.9, 2]], np.float32)
    out = draw_detections(im, det, names=("a", "b", "c"), line_thickness=1)
    assert out is im and im[10, 20].any() and not im[60, 60].any()
