"""The port's eval slice against the JAX package on the CPU: `batched_nms`
at K <= 1024 and K > 1024 (the JAX package's tiled keep-mask; the port's
plain version here, the large-K kernel on the card), the metrics, and
`evaluate` with its txt, hybrid, json and confusion outputs. Same numpy
inputs and weights on both sides, fp32, small sizes."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_util import deploy_cfg, jax_model
from yolo_series_tpu.eval import evaluator as jev
from yolo_series_tpu.eval import metrics as jmet
from yolo_series_tpu.models import reparam as jreparam
from yolo_series_tpu.ops import nms as jnms
from yolo_series_tpu_torch.eval import evaluator as tev
from yolo_series_tpu_torch.eval import metrics as tmet
from yolo_series_tpu_torch.models import graph as tgraph
from yolo_series_tpu_torch.models import reparam as treparam
from yolo_series_tpu_torch.models.convert import from_jax_params
from yolo_series_tpu_torch.models.model import apply_model
from yolo_series_tpu_torch.ops import nms as tnms
from yolo_series_tpu_torch.ops import nms_keep

torch.set_num_threads(2)


def _decoded(rng, b, a, nc, spread=256.0, sigma=6.0):
    """(B, A, 5 + nc) decoded predictions (xywh, obj, class scores) whose
    boxes sit in tight clusters, so that greedy NMS chains run deep."""
    centers = rng.uniform(30, spread - 30, (b, max(a // 24, 1), 2))
    idx = rng.integers(0, centers.shape[1], (b, a))
    cxy = np.take_along_axis(centers, idx[..., None], 1) + rng.normal(0, sigma, (b, a, 2))
    wh = rng.uniform(10, 60, (b, a, 2))
    obj = rng.uniform(0, 1, (b, a, 1)) ** 0.5
    cls = rng.uniform(0, 1, (b, a, nc)) ** 2
    return np.concatenate([cxy, wh, obj, cls], -1).astype(np.float32)


# (A, nc, multi_label, max_nms, conf, classes, agnostic, score dtype)
NMS_CASES = {
    "best_class_small_k": (800, 5, False, 512, 0.05, None, False, "f32"),
    "best_class_large_k": (3000, 5, False, 4096, 0.05, None, False, "f32"),
    "multi_label_large_k": (700, 20, True, 8192, 0.1, None, False, "f32"),
    "multi_label_small_k": (400, 6, True, 1024, 0.05, None, False, "f32"),
    "classes_large_k": (1500, 8, True, 2048, 0.05, (1, 3, 5), False, "f32"),
    "classes_best_class": (900, 8, False, 1024, 0.05, (0, 7), False, "f32"),
    "agnostic_large_k": (2500, 4, False, 2048, 0.05, None, True, "f32"),
    "bf16_scores_large_k": (2000, 10, True, 4096, 0.1, None, False, "bf16"),
}


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_batched_nms_matches_jax(case):
    """num_dets and classes equal, boxes and scores within 1e-5, against
    the JAX function (its whole-matrix keep-mask at K <= 1024, its tiled
    one above). JAX's `agnostic=True` fails in `_nms_tail` (a float offset
    indexed as an array; ROADMAP queue 3), so agnostic is held against
    class-aware NMS with no class offset (max_wh = 0), the same function."""
    a, nc, multi, max_nms, conf, classes, agnostic, sd = NMS_CASES[case]
    pred = _decoded(np.random.default_rng(a + nc), 2, a, nc)
    k = min(max_nms, a * nc if multi else a)
    kw = dict(conf_thres=conf, iou_thres=0.45, multi_label=multi, max_det=300,
              max_nms=max_nms, classes=classes)
    want = jnms.batched_nms(jnp.asarray(pred), agnostic=False,
                            max_wh=0.0 if agnostic else 4096.0,
                            score_dtype=jnp.bfloat16 if sd == "bf16" else jnp.float32,
                            **kw)
    got = tnms.batched_nms(torch.from_numpy(pred), agnostic=agnostic,
                           score_dtype=torch.bfloat16 if sd == "bf16" else torch.float32,
                           **kw)
    num = np.asarray(want.num_dets)
    assert num.min() > 10 and (k > 1024) == case.endswith("large_k"), (num, k)
    np.testing.assert_array_equal(got.num_dets.numpy(), num)
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-5,
                               atol=1e-5)
    if classes is not None:
        assert set(got.classes.numpy()[got.scores.numpy() > 0].tolist()) <= set(classes)
    dets, jdets = tnms.nms_output_to_dets(got), jnms.nms_output_to_dets(want)
    for d, j in zip(dets, jdets):
        assert d.shape == j.shape and d.dtype == np.float32


def test_batched_nms_large_k_takes_the_plain_keep_mask_on_the_cpu():
    """A CPU tensor counts no launch of either kernel at any K."""
    pred = torch.from_numpy(_decoded(np.random.default_rng(0), 1, 1500, 3))
    before = (nms_keep.nms_keep_mask.launches, nms_keep.nms_keep_mask_large.launches)
    out = tnms.batched_nms(pred, conf_thres=0.05, max_nms=2048)
    assert int(out.num_dets[0]) > 0
    assert before == (nms_keep.nms_keep_mask.launches,
                      nms_keep.nms_keep_mask_large.launches)


# ------------------------------------------------------------- metrics ---

def test_metrics_equal_jax_on_random_inputs(tmp_path):
    """ap_per_class, compute_ap (both sentinels), match_predictions,
    ConfusionMatrix and fitness: the same numbers, exactly. With plot=True,
    ap_per_class draws the PR, F1, P and R curves and the confusion matrix
    its panel, the same files as the JAX package's, and returns the same
    numbers."""
    rng = np.random.default_rng(11)
    n, m = 400, 120
    tp = rng.uniform(size=(n, 10)) < np.linspace(0.7, 0.2, 10)
    conf = rng.uniform(size=n)
    pred_cls = rng.integers(0, 6, n).astype(np.float64)
    target_cls = rng.integers(0, 7, m).astype(np.float64)
    for v5 in (False, True):
        for g, w in zip(tmet.ap_per_class(tp, conf, pred_cls, target_cls, v5_metric=v5),
                        jmet.ap_per_class(tp, conf, pred_cls, target_cls, v5_metric=v5)):
            np.testing.assert_array_equal(g, w)
    rec, prec = np.sort(rng.uniform(size=50)), rng.uniform(size=50)
    for v5 in (False, True):
        for g, w in zip(tmet.compute_ap(rec, prec, v5), jmet.compute_ap(rec, prec, v5)):
            np.testing.assert_array_equal(g, w)
    res = rng.uniform(size=(5, 7))
    np.testing.assert_array_equal(tmet.fitness(res), jmet.fitness(res))

    iouv = np.linspace(0.5, 0.95, 10)
    for seed in range(5):
        r = np.random.default_rng(seed)
        xy = r.uniform(0, 200, (40, 2))
        pred = np.concatenate([xy, xy + r.uniform(10, 60, (40, 2)),
                               np.sort(r.uniform(size=(40, 1)))[::-1],
                               r.integers(0, 3, (40, 1))], 1)
        lxy = xy[:15] + r.normal(0, 4, (15, 2))
        labels = np.concatenate([r.integers(0, 3, (15, 1)), lxy,
                                 lxy + r.uniform(10, 60, (15, 2))], 1)
        np.testing.assert_array_equal(tmet.match_predictions(pred, labels, iouv),
                                      jmet.match_predictions(pred, labels, iouv))
        tcm, jcm = tmet.ConfusionMatrix(3), jmet.ConfusionMatrix(3)
        tcm.process_batch(pred, labels)
        jcm.process_batch(pred, labels)
        np.testing.assert_array_equal(tcm.matrix, jcm.matrix)
    files = {}
    for side, met, cm in (("port", tmet, tcm), ("jax", jmet, jcm)):
        d = tmp_path / side
        d.mkdir()
        got = met.ap_per_class(tp, conf, pred_cls, target_cls, plot=True, save_dir=d,
                               names=[f"c{i}" for i in range(7)])
        for g, w in zip(got, jmet.ap_per_class(tp, conf, pred_cls, target_cls)):
            np.testing.assert_array_equal(g, w)
        cm.plot(save_dir=str(d), names=("a", "b", "c"))
        files[side] = sorted(f.name for f in d.iterdir() if f.stat().st_size > 0)
    assert files["port"] == files["jax"] == ["F1_curve.png", "PR_curve.png", "P_curve.png",
                                             "R_curve.png", "confusion_matrix.png"]


def test_scale_coords_and_coco_ids_equal_jax():
    rng = np.random.default_rng(3)
    coords = rng.uniform(0, 128, (20, 4)).astype(np.float32)
    for ratio_pad in (None, ((0.64, 0.64), (0.0, 19.5))):
        np.testing.assert_array_equal(
            tev.scale_coords_np((128, 128), coords, (100, 200), ratio_pad),
            jev.scale_coords_np((128, 128), coords, (100, 200), ratio_pad))
    assert tev.coco80_to_coco91() == jev.coco80_to_coco91()


# ------------------------------------------------------------ evaluate ---

NC = 4


@pytest.fixture(scope="module")
def eval_setup():
    """Width-0.25 deploy yolov7 with 4 classes, livened and fused, in both
    packages; two rect batches of two images (128 x 128 and 96 x 128) whose
    labels are the model's own confident detections, jittered, plus one
    label it does not find (so mAP is neither 0 nor 1)."""
    cfg = deploy_cfg(0.25, nc=NC)
    plan, params, state = jax_model(0.25, seed=2, size=128, candidates=40, cfg=cfg)
    jp, js = jreparam.fuse_model(plan, jax.tree_util.tree_map(jnp.asarray, params),
                                 jax.tree_util.tree_map(jnp.asarray, state))
    tplan = tgraph.compile_graph(cfg)
    tp, ts = treparam.fuse_model(tplan, *from_jax_params(tplan, params, state))
    rng = np.random.default_rng(9)
    batches = []
    for bi, (h, w) in enumerate(((128, 128), (96, 128))):
        imgs = rng.integers(0, 256, (2, h, w, 3), np.uint8)
        with torch.inference_mode():
            out, _ = apply_model(tplan, tp, ts, torch.from_numpy(imgs).float() / 255.0)
            dets = tnms.nms_output_to_dets(tnms.batched_nms(out["pred"], max_det=6))
        labels = np.zeros((2, 8, 5), np.float32)
        mask = np.zeros((2, 8), bool)
        for si, d in enumerate(dets):
            d = d[:6]
            xyxy = d[:, :4] + rng.normal(0, 1.5, (len(d), 4))
            xywh = np.concatenate([(xyxy[:, :2] + xyxy[:, 2:]) / 2,
                                   xyxy[:, 2:] - xyxy[:, :2]], 1)
            rows = np.concatenate([d[:, 5:6], xywh / [w, h, w, h]], 1)
            rows = np.concatenate([rows, [[si % NC, 0.5, 0.5, 0.2, 0.3]]])
            labels[si, :len(rows)] = rows
            mask[si, :len(rows)] = True
        # native sizes that letterbox to (h, w): a rect batch of wider images
        shapes = [((h - 28, w), ((1.0, 1.0), (0.0, 14.0))) if bi else None
                  for _ in range(2)]
        batches.append({"images": imgs, "labels": labels, "label_mask": mask,
                        "shapes": shapes,
                        "paths": [f"/data/{bi}{si}.jpg" for si in range(2)]})
    return plan, jp, js, tplan, tp, ts, batches


def _read_txt(d):
    return {p.name: np.array([[float(v) for v in ln.split()]
                              for ln in p.read_text().splitlines()])
            for p in sorted(d.glob("*.txt"))}


@pytest.mark.parametrize("hybrid", [False, True], ids=["plain", "hybrid"])
def test_evaluate_matches_jax(eval_setup, tmp_path, hybrid):
    """evaluate's map50 / map within 1e-3 of the JAX evaluator's (conf
    0.001 / iou 0.65, multi-label, max_nms 8192: K > 1024, the JAX
    package's tiled keep-mask and the port's plain version), with the
    auto-label txts (and the hybrid labels in NMS), the json and the
    confusion matrix."""
    plan, jp, js, tplan, tp, ts, batches = eval_setup
    out = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        kw = dict(save_txt_dir=str(d), save_conf=True, save_hybrid=hybrid,
                  save_json=str(d / "pred.json"), confusion=True)
        if side == "jax":
            out[side] = jev.evaluate(plan, jp, js, batches, **kw)
        else:
            before = (nms_keep.nms_keep_mask.launches,
                      nms_keep.nms_keep_mask_large.launches)
            out[side] = tev.evaluate(tplan, tp, ts, batches, device="cpu", **kw)
            assert before == (nms_keep.nms_keep_mask.launches,
                              nms_keep.nms_keep_mask_large.launches)
        out[side + "_txt"] = _read_txt(d)
        out[side + "_json"] = json.loads((d / "pred.json").read_text())
    got, want = out["port"], out["jax"]
    assert want["seen"] == got["seen"] == 4
    assert 0.05 < want["map50"] < 0.999, want["map50"]
    for key in ("map50", "map", "mp", "mr", "fitness"):
        assert abs(got[key] - want[key]) <= 1e-3, (key, got[key], want[key])
    np.testing.assert_array_equal(got["ap_class"], want["ap_class"])
    np.testing.assert_allclose(got["confusion"].matrix, want["confusion"].matrix,
                               atol=2)
    assert set(got["speed_ms"]) == {"inference", "nms"}
    gt, wt = out["port_txt"], out["jax_txt"]
    assert sorted(gt) == sorted(wt) and len(gt) == 4
    for name in wt:
        assert gt[name].shape == wt[name].shape
        np.testing.assert_array_equal(gt[name][:, 0], wt[name][:, 0])
        np.testing.assert_allclose(gt[name][:, 1:], wt[name][:, 1:], atol=2e-3)
    assert len(out["port_json"]) == len(out["jax_json"])
    assert [r["category_id"] for r in out["port_json"]] == \
        [r["category_id"] for r in out["jax_json"]]


def test_evaluate_refuses_what_is_not_ported(eval_setup, tmp_path):
    """Nothing of `evaluate` is refused now: plots_dir writes the first
    batches' mosaics as the JAX package's does, the ground-truth mosaics
    bit-equal with JAX's, the prediction mosaics of the same size (the
    detections of the two fp32 forwards differ in rounding only)."""
    plan, jp, js, tplan, tp, ts, batches = eval_setup
    for side in ("port", "jax"):
        (tmp_path / side).mkdir()
    tev.evaluate(tplan, tp, ts, batches, plots_dir=str(tmp_path / "port"), device="cpu")
    jev.evaluate(plan, jp, js, batches, plots_dir=str(tmp_path / "jax"))
    import cv2

    names = [f"test_batch{i}_{k}.jpg" for i in range(2) for k in ("labels", "pred")]
    for name in names:
        got, want = (cv2.imread(str(tmp_path / side / name)) for side in ("port", "jax"))
        assert got is not None and got.shape == want.shape, name
        if name.endswith("labels.jpg"):
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("start", [(True, "high"), (False, "highest"), (True, "medium")],
                         ids=["tf32_on", "tf32_off", "tf32_medium"])
def test_fp32_entry_points_pin_full_fp32(eval_setup, monkeypatch, start):
    """`evaluate(compute_dtype=torch.float32)` and an fp32 `Detector` run
    their forward with cuDNN's TF32 off and the matmul precision at
    "highest", whatever the caller's global flags, and leave cuDNN's flag
    and the matmul precision as they found them (a "medium" precision too,
    which reads as TF32 on through the matmuls' boolean flag); in bf16
    neither touches them."""
    from yolo_series_tpu_torch.infer import detector as tdet

    *_, tplan, tp, ts, batches = eval_setup
    seen = []

    def flags():
        return torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()

    def set_flags(cudnn, matmul):
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(matmul)

    def record(module):
        real = module.apply_model

        def recording(*args, **kwargs):
            seen.append((kwargs["dtype"], *flags()))
            return real(*args, **kwargs)

        monkeypatch.setattr(module, "apply_model", recording)

    record(tev)
    record(tdet)
    image = np.random.default_rng(3).integers(0, 256, (100, 150, 3), np.uint8)
    saved = flags()
    try:
        set_flags(*start)
        for dtype in (torch.float32, torch.bfloat16):
            seen.clear()
            tev.evaluate(tplan, tp, ts, batches[:1], compute_dtype=dtype, device="cpu")
            assert flags() == start
            tdet.Detector(tplan, tp, ts, img_size=128, dtype=dtype, device="cpu")(image)
            assert flags() == start
            inside = (False, "highest") if dtype == torch.float32 else start
            assert seen == [(dtype, *inside)] * 2
    finally:
        set_flags(*saved)


def test_full_fp32_pins_from_several_threads():
    """Pins entered and left in interleaved order from two threads: the
    flags stay pinned until the last one leaves, which restores them as the
    caller set them."""
    import threading

    from yolo_series_tpu_torch.device import full_fp32

    def flags():
        return torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()

    saved = flags()
    entered, release = threading.Event(), threading.Event()
    inside = []

    def other():
        with full_fp32():
            entered.set()
            release.wait(30)
            inside.append(flags())

    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("medium")
        thread = threading.Thread(target=other)
        with full_fp32():
            thread.start()
            assert entered.wait(30)
        assert flags() == (False, "highest")   # the other pin is still in
        release.set()
        thread.join(30)
        assert inside == [(False, "highest")]
        assert flags() == (True, "medium")
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
