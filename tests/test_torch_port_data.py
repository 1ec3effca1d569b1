"""The port's data pipeline, eval COCOeval and autoanchor against the JAX
package on the same inputs: `utils/general`, the label parsers, every
host augmentation, `DetectionDataset` items and `create_loader` batches
(bit-equal for the same seed: the JAX side draws from the global `random`
and `np.random` seeded alike, the port from its own generators), the
label cache, the EXIF-rotated image size, `coco_eval` summaries and
`check_anchors`."""

import json
import random
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import yolo_series_tpu.data.augment as JA
import yolo_series_tpu.data.datasets as JD
import yolo_series_tpu.data.parsers as JP
import yolo_series_tpu.utils.general as JG
import yolo_series_tpu_torch.data.augment as PA
import yolo_series_tpu_torch.data.datasets as PD
import yolo_series_tpu_torch.data.parsers as PP
import yolo_series_tpu_torch.utils.general as PG
from tests.test_coco_eval_cross import _gt, _random_scenario
from yolo_series_tpu.eval.coco_eval import COCOEvaluator as JCOCO
from yolo_series_tpu.utils.autoanchor import check_anchors as jcheck_anchors
from yolo_series_tpu_torch.eval.coco_eval import COCOEvaluator as PCOCO
from yolo_series_tpu_torch.utils.autoanchor import check_anchors as pcheck_anchors

torch.set_num_threads(2)

# image (h, w) of the synthetic tree: landscape, portrait, square, small
SHAPES = ((96, 128), (128, 80), (100, 100), (60, 150), (120, 96), (72, 72),
          (90, 160), (140, 110), (64, 64), (110, 70))


def _polygon(rng, cx, cy, r):
    """A closed 12-point polygon (normalized) around (cx, cy)."""
    t = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    rad = r * rng.uniform(0.7, 1.0, 12)
    return np.stack([cx + rad * np.cos(t), cy + rad * np.sin(t)], 1).clip(0.01, 0.99)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """10 noise JPEGs with filled boxes under images/, YOLO labels under
    labels/: even images with box rows, odd ones with polygon rows (the
    segments paste-in samples from)."""
    root = tmp_path_factory.mktemp("port_data")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate(SHAPES):
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        rows = []
        for _ in range(int(rng.integers(1, 5))):
            cls = int(rng.integers(0, 5))
            cx, cy = rng.uniform(0.3, 0.7, 2)
            r = rng.uniform(0.1, 0.25)
            x1, y1, x2, y2 = int((cx - r) * w), int((cy - r) * h), int((cx + r) * w), int((cy + r) * h)
            cv2.rectangle(img, (x1, y1), (x2, y2), tuple(int(v) for v in rng.integers(0, 256, 3)), -1)
            if i % 2:
                rows.append(" ".join([str(cls)] + [f"{v:.5f}" for v in _polygon(rng, cx, cy, r).ravel()]))
            else:
                rows.append(f"{cls} {cx:.6f} {cy:.6f} {2 * r:.6f} {2 * r:.6f}")
        cv2.imwrite(str(root / "images" / f"im{i}.jpg"), img)
        (root / "labels" / f"im{i}.txt").write_text("\n".join(rows))
    return root


# -- utils/general ----------------------------------------------------------

def _segs():
    rng = np.random.default_rng(3)
    return [rng.uniform(0, 1, (n, 2)).astype(np.float32) for n in (5, 9, 3)]


def _labels():
    rng = np.random.default_rng(4)
    return [np.concatenate([rng.integers(0, 6, (n, 1)), rng.uniform(0, 1, (n, 4))], 1)
            for n in (3, 0, 5, 1)]


HELPERS = {
    "make_divisible": lambda g: [g.make_divisible(x, d) for x, d in ((637, 32), (640, 32), (3, 8))],
    "check_img_size": lambda g: [g.check_img_size(s, 32) for s in (640, 600, 129)],
    "colorstr": lambda g: [g.colorstr("x"), g.colorstr("red", "bold", "y")],
    "labels_to_class_weights": lambda g: g.labels_to_class_weights(_labels(), 8),
    "labels_to_image_weights": lambda g: g.labels_to_image_weights(
        _labels(), 8, g.labels_to_class_weights(_labels(), 8)),
    "clean_str": lambda g: g.clean_str("rtsp://a:b@host/x?y=1&z"),
    "segments2boxes": lambda g: g.segments2boxes(_segs()),
    "resample_segments": lambda g: g.resample_segments(_segs(), n=50),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_general_helper_matches_jax(name):
    got, want = HELPERS[name](PG), HELPERS[name](JG)
    if isinstance(want, list) and want and isinstance(want[0], np.ndarray):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_general_seeds_files_and_dataset_checks(tmp_path, monkeypatch):
    PG.set_seeds(5)
    a = (random.random(), np.random.random(), torch.rand(3))
    JG.set_seeds(5)
    assert (random.random(), np.random.random()) == a[:2]
    PG.set_seeds(5)
    torch.testing.assert_close(torch.rand(3), a[2], rtol=0, atol=0)
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "d.yaml").write_text("x")
    monkeypatch.chdir(tmp_path)
    assert PG.check_file("d.yaml") == JG.check_file("d.yaml")
    assert PG.check_file("") == JG.check_file("") == ""
    with pytest.raises(FileNotFoundError):
        PG.check_file("absent.yaml")
    PG.check_dataset({"train": str(tmp_path / "sub")})
    for check in (PG.check_dataset, JG.check_dataset):
        with pytest.raises(FileNotFoundError, match="val: nowhere"):
            check({"train": str(tmp_path), "val": "nowhere"})


# -- parsers ----------------------------------------------------------------

def test_parsers_yolo_txt_match_jax(tmp_path):
    (tmp_path / "boxes.txt").write_text("0 0.5 0.5 0.2 0.3\n3 0.1 0.2 0.1 0.1\n0 0.5 0.5 0.2 0.3\n")
    (tmp_path / "segs.txt").write_text("1 0.1 0.1 0.4 0.1 0.4 0.5 0.1 0.5\n"
                                       "2 0.6 0.6 0.9 0.6 0.9 0.9 0.6 0.9 0.7 0.95\n")
    (tmp_path / "empty.txt").write_text("")
    for name in ("boxes.txt", "segs.txt", "empty.txt", "absent.txt"):
        (gl, gs), (wl, ws) = (m.parse_yolo_txt(str(tmp_path / name)) for m in (PP, JP))
        np.testing.assert_array_equal(gl, wl)
        assert len(gs) == len(ws) and all(np.array_equal(a, b) for a, b in zip(gs, ws))
    (tmp_path / "bad.txt").write_text("0 0.5 1.5 0.2 0.3\n")
    with pytest.raises(ValueError):
        PP.parse_yolo_txt(str(tmp_path / "bad.txt"))
    paths = ["/d/images/a.jpg", "/d/images/sub/b.PNG", "/x/y.jpeg"]
    assert PP.img2label_paths(paths) == JP.img2label_paths(paths)


def test_parsers_odgt_and_xml_match_jax(tmp_path):
    rows = [{"ID": "ch1", "gtboxes": [
                {"tag": "person", "hbox": [10, 10, 20, 20], "vbox": [5, 5, 60, 320]},
                {"tag": "mask", "hbox": [0, 0, 5, 5], "vbox": [0, 0, 9, 9]}]},
            {"ID": "ch2", "gtboxes": [
                {"tag": "person", "hbox": [30, 10, 20, 20], "vbox": [250, 5, 90, 120]}]}]
    (tmp_path / "a.odgt").write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    got, want = (m.parse_crowdhuman_odgt([str(tmp_path / "a.odgt")]) for m in (PP, JP))
    assert got == want
    for stem in want:
        np.testing.assert_array_equal(PP.crowdhuman_labels(got[stem], 300, 200),
                                      JP.crowdhuman_labels(want[stem], 300, 200))
    (tmp_path / "sh1.xml").write_text(
        "<annotation><filename>sh1.jpg</filename>"
        + "".join(f"<object><name>{n}</name><bndbox><xmin>{x}</xmin><ymin>40</ymin>"
                  f"<xmax>{x + 80}</xmax><ymax>230</ymax></bndbox></object>"
                  for n, x in (("person_with_helmet", -5), ("head", 60), ("dog", 10),
                               ("person_no_helmet", 250)))
        + "</annotation>")
    got, want = (m.parse_shel_xml([str(tmp_path / "sh1.xml")]) for m in (PP, JP))
    assert got == want
    np.testing.assert_array_equal(PP.shel_labels(got["sh1"], 300, 200),
                                  JP.shel_labels(want["sh1"], 300, 200))


# -- augment ----------------------------------------------------------------

def _img(seed, h=96, w=128):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3)).astype(np.uint8)


def _xyxy(seed, n, h=96, w=128):
    rng = np.random.default_rng(seed)
    x1, y1 = rng.uniform(0, w * 0.6, n), rng.uniform(0, h * 0.6, n)
    bw, bh = rng.uniform(8, w * 0.4, n), rng.uniform(8, h * 0.4, n)
    return np.stack([rng.integers(0, 5, n), x1, y1, x1 + bw, y1 + bh], 1).astype(np.float32)


def _aug_case(name, m, rng, nprng):
    """Run augmentation `name` of module m with generator rng (random.Random
    or the `random` module) on fixed inputs; numpy draws from nprng."""
    if name == "augment_hsv":
        img = _img(1)
        return m.augment_hsv(img, 0.015, 0.7, 0.4, rng), img
    if name == "hist_equalize":
        return [m.hist_equalize(_img(2), clahe=c, bgr=b) for c in (True, False)
                for b in (True, False)]
    if name == "box_candidates":
        a, b = _xyxy(3, 20)[:, 1:].T, (_xyxy(4, 20)[:, 1:] * 0.5).T
        return m.box_candidates(a, b)
    if name == "random_perspective":
        out = [m.random_perspective(_img(5), _xyxy(6, 6), degrees=10, translate=0.2,
                                    scale=0.5, shear=5, perspective=p, border=b, rng=rng)
               for p, b in ((0.0, (0, 0)), (0.0005, (-16, -24)))]
        segs = [np.random.default_rng(7).uniform(10, 90, (8, 2)) for _ in range(6)]
        out.append(m.random_perspective(_img(8), _xyxy(6, 6), segs, degrees=5, scale=0.3,
                                        rng=rng))
        return out
    if name in ("mosaic4", "mosaic9"):
        k = 4 if name == "mosaic4" else 9
        # long side 64, as the dataset resizes them
        hw = [(64, 64 - 5 * i) if i % 2 else (64 - 4 * i, 64) for i in range(k)]
        imgs = [_img(10 + i, *hw[i]) for i in range(k)]
        lbs = [_xyxy(30 + i, i % 3, *hw[i]) for i in range(k)]
        return getattr(m, name)(imgs, lbs, 64, rng)
    if name == "mixup":
        return m.mixup(_img(11), _xyxy(12, 3), _img(13), _xyxy(14, 2), nprng)
    if name == "bbox_ioa_np":
        return m.bbox_ioa_np(np.array([10, 10, 60, 50], np.float32), _xyxy(15, 7)[:, 1:])
    if name == "cutout":
        return m.cutout(_img(16), _xyxy(17, 8), rng)
    if name == "copy_paste":
        segs = [np.random.default_rng(19 + j).uniform(10, 90, (8, 2)) for j in range(4)]
        return m.copy_paste(_img(18), _xyxy(20, 4), segs, p=0.5, rng=rng)
    if name == "pastein":
        samples = [(j, _img(21 + j, 20 + 5 * j, 30), (np.random.default_rng(j).random(
            (20 + 5 * j, 30)) > 0.3).astype(np.uint8) * 255) for j in range(3)]
        return m.pastein(_img(22, 160, 200), _xyxy(23, 2, 160, 200), samples, rng)
    if name == "replicate":
        return m.replicate(_img(24), _xyxy(25, 6), rng)
    raise KeyError(name)


AUGMENTS = ("augment_hsv", "hist_equalize", "box_candidates", "random_perspective",
            "mosaic4", "mosaic9", "mixup", "bbox_ioa_np", "cutout", "copy_paste",
            "pastein", "replicate")


def _assert_same(got, want):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("name", AUGMENTS)
def test_augment_bit_equal_to_jax(name):
    """Both draw from random.Random(5) (JAX's mixup from np.random seeded 5,
    the port's from RandomState(5)): the same pixels and labels."""
    np.random.seed(5)
    want = _aug_case(name, JA, random.Random(5), None)
    got = _aug_case(name, PA, random.Random(5), np.random.RandomState(5))
    _assert_same(got, want)


# -- dataset and loader -----------------------------------------------------

ITEM_CASES = {
    "square": dict(augment=False),
    "rect_pad": dict(augment=False, rect=True, pad=0.5, batch_size=3),
    "mosaic_mixup_pastein": dict(augment=True, hyp={"mixup": 1.0, "paste_in": 1.0,
                                                    "flipud": 0.5}),
    "letterbox_warp": dict(augment=True, hyp={"mosaic": 0.0, "degrees": 10.0,
                                              "shear": 3.0, "paste_in": 0.5}),
}


def _both(tree, seed, **kw):
    """JAX dataset (global random / np.random seeded) and the port's
    (seeded) on the same tree."""
    random.seed(seed)
    np.random.seed(seed)
    path = str(tree / "images")
    return JD.DetectionDataset(path, img_size=64, **kw), PD.DetectionDataset(
        path, img_size=64, seed=seed, **kw)


@pytest.mark.parametrize("case", sorted(ITEM_CASES))
def test_dataset_items_bit_equal_to_jax(tree, case):
    jds, pds = _both(tree, 11, **ITEM_CASES[case])
    assert pds.im_files == jds.im_files
    want = [jds[i] for i in range(len(jds)) for _ in range(2)]
    got = [pds[i] for i in range(len(pds)) for _ in range(2)]
    for (gi, gl, gp, gs), (wi, wl, wp, ws) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
        assert (gp, gs) == (wp, ws)
    if case == "rect_pad":
        np.testing.assert_array_equal(pds.batch_shapes, jds.batch_shapes)
    if ITEM_CASES[case]["augment"]:   # the draws moved both generators alike
        assert pds.rng.random() == random.random()


def _batches(loader, epochs=1):
    return [{k: (np.array(v) if isinstance(v, np.ndarray) else v) for k, v in b.items()}
            for _ in range(epochs) for b in loader]


LOADER_CASES = {
    "shuffle_two_epochs": (dict(augment=False), dict(batch_size=3), 2),
    "no_drop_last": (dict(augment=False), dict(batch_size=3, drop_last=False,
                                               shuffle=False), 1),
    "quad": (dict(augment=False), dict(batch_size=4, quad=True, drop_last=False), 1),
    "image_weights": (dict(augment=False), dict(batch_size=2, image_weights=True), 1),
    "augment": (dict(augment=True), dict(batch_size=2), 1),
    "workers2_order": (dict(augment=False), dict(batch_size=2, workers=2, hold=2), 2),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_batches_bit_equal_to_jax(tree, case):
    ds_kw, kw, epochs = LOADER_CASES[case]
    jds, pds = _both(tree, 3, **ds_kw)
    want = _batches(JD.create_loader(jds, max_labels=12, seed=7, **kw), epochs)
    got = _batches(PD.create_loader(pds, max_labels=12, seed=7, **kw), epochs)
    assert len(got) == len(want) == epochs * len(PD.create_loader(pds, **kw))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k], k


def test_loader_stops_its_workers_when_left_early(tree):
    """A consumer that stops after one batch: closing the iterator stops
    and joins its decode threads (the JAX loader leaves them blocked)."""
    import threading

    ds = PD.DetectionDataset(str(tree / "images"), img_size=64)
    before = set(threading.enumerate())
    it = iter(PD.create_loader(ds, batch_size=1, workers=2, prefetch=1))
    next(it)
    started = set(threading.enumerate()) - before
    assert len(started) == 2
    it.close()
    assert not [t for t in started if t.is_alive()]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_label_cache_shared_reused_and_invalidated(tree, tmp_path, writer):
    """One package writes the cache, the other reads it back as is; an
    edited label file invalidates it for both."""
    files = sorted(str(p) for p in (tree / "images").glob("*.jpg"))
    cache = str(tmp_path / "labels.cache")
    first, other = (JD, PD) if writer == "jax" else (PD, JD)
    a = first.build_label_cache(files, cache_path=cache)
    mtime = Path(cache).stat().st_mtime_ns
    b = other.build_label_cache(files, cache_path=cache)
    assert Path(cache).stat().st_mtime_ns == mtime   # reused, not rewritten
    assert a["key"] == b["key"] and a["stats"] == b["stats"]
    for f in files:
        np.testing.assert_array_equal(a["items"][f][0], b["items"][f][0])
    lb = tree / "labels" / "im0.txt"
    old = lb.read_text()
    try:
        lb.write_text("4 0.5 0.5 0.25 0.25")
        got = other.build_label_cache(files, cache_path=cache)
        np.testing.assert_array_equal(got["items"][files[0]][0],
                                      [[4, 0.5, 0.5, 0.25, 0.25]])
        assert got["key"] != a["key"]
        assert first.build_label_cache(files, cache_path=cache)["key"] == got["key"]
    finally:
        lb.write_text(old)


def test_exif_rotated_shape_matches_jax(tmp_path):
    """An EXIF orientation-6 JPEG stored 60 x 40: (w, h) = (40, 60) from
    PIL's header and from the cv2 decode alike, as JAX's `_image_shape`."""
    from PIL import Image

    path = str(tmp_path / "rot.jpg")
    exif = Image.Exif()
    exif[274] = 6
    Image.fromarray(_img(3, 40, 60)).save(path, exif=exif)
    want = JD._image_shape(path)
    assert want == (40, 60)
    assert PD._image_shape_pil(path) == PD._image_shape_cv2(path) == PD._image_shape(path) == want


def test_device_tail_refused(tree):
    """The device tail's guards, as the JAX dataset's: a projective warp
    (hyp perspective != 0) and the quad collate are refused; without
    augment there is no tail."""
    ds = PD.DetectionDataset(str(tree / "images"), augment=True, device_tail=True,
                             hyp={"perspective": 1e-4})
    with pytest.raises(ValueError, match="perspective"):
        ds.device_item(0)
    with pytest.raises(ValueError, match="quad"):
        PD.create_loader(ds, batch_size=4, quad=True)
    assert not PD.DetectionDataset(str(tree / "images"), device_tail=True).device_tail


# -- coco_eval --------------------------------------------------------------

HAND_CASES = {
    "perfect": ([{"id": 1, "image_id": 0, "category_id": 1, "bbox": [10, 10, 50, 50],
                  "area": 2500.0, "iscrowd": 0}],
                [{"image_id": 0, "category_id": 1, "bbox": [10, 10, 50, 50], "score": 0.9}]),
    "half_iou": ([{"id": 1, "image_id": 0, "category_id": 1, "bbox": [0, 0, 100, 100],
                   "area": 10000.0, "iscrowd": 0}],
                 [{"image_id": 0, "category_id": 1, "bbox": [0, 0, 50, 100], "score": 0.9}]),
    "crowd": ([{"id": 1, "image_id": 0, "category_id": 1, "bbox": [0, 0, 100, 100],
                "area": 10000.0, "iscrowd": 1},
               {"id": 2, "image_id": 1, "category_id": 1, "bbox": [0, 0, 100, 100],
                "area": 10000.0, "iscrowd": 0}],
              [{"image_id": 0, "category_id": 1, "bbox": [10, 10, 50, 50], "score": 0.95},
               {"image_id": 1, "category_id": 1, "bbox": [0, 0, 100, 100], "score": 0.9}]),
    "maxdets": ([{"id": 1, "image_id": 0, "category_id": 1, "bbox": [200, 200, 50, 50],
                  "area": 2500.0, "iscrowd": 0}],
                [{"image_id": 0, "category_id": 1, "bbox": [5.0 + 60 * i, 5.0, 20.0, 20.0],
                  "score": 0.9 - 0.05 * i} for i in range(10)]
                + [{"image_id": 0, "category_id": 1, "bbox": [200.0, 200.0, 50.0, 50.0],
                    "score": 0.3}]),
    "area_ignore": ([{"id": 1, "image_id": 0, "category_id": 1, "bbox": [0, 0, 20, 20],
                      "area": 400.0, "iscrowd": 0}],
                    [{"image_id": 0, "category_id": 1, "bbox": [0, 0, 20, 20], "score": 0.9}]),
    "score_tie": ([{"id": 1, "image_id": 0, "category_id": 1, "bbox": [0, 0, 50, 50],
                    "area": 2500.0, "iscrowd": 0}],
                  [{"image_id": 0, "category_id": 1, "bbox": [0, 0, 50, 50], "score": 0.5},
                   {"image_id": 0, "category_id": 1, "bbox": [300, 300, 50, 50],
                    "score": 0.5}]),
}


@pytest.mark.parametrize("case", [f"random{s}" for s in range(8)] + sorted(HAND_CASES))
def test_coco_eval_summary_equals_jax(case, tmp_path):
    """The scenarios of tests/test_coco_eval_cross.py: the port's summary
    equals JAX's, key for key (the port reads the json paths too)."""
    if case.startswith("random"):
        gt, dets = _random_scenario(int(case[6:]))
    else:
        anns, dets = HAND_CASES[case]
        gt = _gt(sorted({a["image_id"] for a in anns}), anns)
    want = JCOCO(gt, dets).summarize(verbose=False)
    (tmp_path / "gt.json").write_text(json.dumps(gt))
    (tmp_path / "dt.json").write_text(json.dumps(dets))
    got = PCOCO(str(tmp_path / "gt.json"), str(tmp_path / "dt.json")).summarize(verbose=False)
    assert got == want


# -- autoanchor -------------------------------------------------------------

@pytest.mark.parametrize("thin", [False, True])
def test_check_anchors_matches_jax(thin):
    """thin=True: extreme-aspect boxes give BPR < 0.98 and both recompute
    by k-means and the genetic step; the same BPR and anchors from
    np.random seeded 9 and RandomState(9)."""
    rng = np.random.default_rng(2)
    labels = []
    for i in range(12):
        w = rng.uniform(0.5, 0.95, 4) if thin else rng.uniform(0.05, 0.3, 4)
        h = rng.uniform(0.02, 0.06, 4) if thin else rng.uniform(0.05, 0.3, 4)
        if thin and i % 2:
            w, h = h, w
        labels.append(np.stack([np.zeros(4), rng.uniform(0.2, 0.8, 4),
                                rng.uniform(0.2, 0.8, 4), w, h], 1).astype(np.float32))
    shapes = rng.integers(100, 400, (12, 2)).astype(np.float64)
    anchors = np.array([[12, 16, 19, 36, 40, 28], [36, 75, 76, 55, 72, 146],
                        [142, 110, 192, 243, 459, 401]], np.float32).reshape(3, 3, 2)
    np.random.seed(9)
    want_bpr, want = jcheck_anchors(labels, shapes, anchors, (8, 16, 32), imgsz=160)
    got_bpr, got = pcheck_anchors(labels, shapes, anchors, (8, 16, 32), imgsz=160,
                                  rng=np.random.RandomState(9))
    assert got_bpr == want_bpr
    if thin:
        assert want is not None
        np.testing.assert_array_equal(got, want)
    else:
        assert want is None and got is None
