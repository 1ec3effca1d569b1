"""Dataset scan, label cache, host augmentation pipeline, batched loader
(counterpart of `yolo_series_tpu/data/datasets.py`; reference
utils/datasets.py).

  * the same on-disk conventions: COCO-YOLO /images/ -> /labels/ txt,
    CrowdHuman .odgt + SHEL VOC xml joint "human" datasets with
    `cut_max_len`, the label cache (same file, same format), rect
    batching, mosaic/mixup/perspective/HSV/paste-in augmentation;
  * batches come out padded and static, as the JAX loader's: `images`
    (B, H, W, 3) uint8 RGB, `labels` (B, max_labels, 5) [cls, x, y, w, h]
    normalized, `label_mask` (B, max_labels), `paths`, `shapes`;
  * background decode threads instead of torch DataLoader workers.

Randomness: the dataset owns a `random.Random` and a numpy `RandomState`,
both seeded with `seed`, where the JAX dataset draws from the global
`random` and `np.random`. The draws are the same calls in the same order,
including those whose results are thrown away, so a seed gives the batches
the JAX loader gives after `random.seed(seed); np.random.seed(seed)`, bit
for bit, with one worker (with several, the workers interleave their draws,
in both packages).

The device-augment tail (`device_tail=True` with `augment`, the JAX
`device_item` and `_make_device_batch`): the host decodes, places the
mosaic tiles, samples the warp, HSV, flip and mixup parameters and
transforms the labels; the batch carries uint8 tiles and those parameters,
and `data/device_aug.make_device_augment` makes the pixels on the card.
Its draws too are the JAX dataset's, so its batches are bit-equal to the
JAX loader's for a seed.

Not carried: the JAX dataset's optional Albumentations hook, which is
active only where that package is installed and draws from its global
generators.
"""

from __future__ import annotations

import glob
import hashlib
import os
import pickle
import queue as queue_mod
import random
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import cv2
import numpy as np

from yolo_series_tpu_torch.data import augment as A
from yolo_series_tpu_torch.data.parsers import (
    crowdhuman_labels, img2label_paths, parse_crowdhuman_odgt, parse_shel_xml,
    parse_yolo_txt, shel_labels,
)
from yolo_series_tpu_torch.parallel.dist import host_local_slice
from yolo_series_tpu_torch.utils.general import (labels_to_class_weights,
                                                 labels_to_image_weights)

IMG_FORMATS = ("bmp", "jpg", "jpeg", "png", "tif", "tiff", "dng", "webp", "mpo")
CACHE_VERSION = "ystpu-0.2"   # the JAX package's: the two read each other's caches

DEFAULT_HYP = {
    "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4, "degrees": 0.0,
    "translate": 0.2, "scale": 0.9, "shear": 0.0, "perspective": 0.0,
    "flipud": 0.0, "fliplr": 0.5, "mosaic": 1.0, "mixup": 0.15,
    "copy_paste": 0.0, "paste_in": 0.15,
}


def _scan_img_files(path) -> List[str]:
    """Dir / txt-list / glob / list-of-those -> sorted image files
    (reference datasets.py:381-400)."""
    files: List[str] = []
    for p in path if isinstance(path, (list, tuple)) else [path]:
        p = Path(p)
        if p.is_dir():
            files += glob.glob(str(p / "**" / "*.*"), recursive=True)
        elif p.is_file() and p.suffix == ".txt":
            parent = str(p.parent) + os.sep
            with open(p) as f:
                for x in f.read().strip().splitlines():
                    x = x.strip()
                    if x.startswith("./"):
                        x = parent + x[2:]
                    files.append(x)
        elif p.is_file():
            files.append(str(p))
        else:
            raise FileNotFoundError(f"{p} does not exist")
    return sorted(x.replace("/", os.sep) for x in files
                  if x.split(".")[-1].lower() in IMG_FORMATS)


def _image_shape_pil(path) -> Tuple[int, int]:
    """(w, h) from the header, EXIF rotation respected (reference
    exif_size), as the JAX package reads it."""
    from PIL import Image

    with Image.open(path) as im:
        s = im.size
        try:
            rot = dict(im.getexif()).get(274)
            if rot in (6, 8):
                s = (s[1], s[0])
        except Exception:  # noqa: BLE001 — unreadable EXIF: the header size
            pass
        return s


def _image_shape_cv2(path) -> Tuple[int, int]:
    """(w, h) of the decoded image: `cv2.imread` applies the EXIF
    orientation, so this equals `_image_shape_pil` (at the cost of a full
    decode)."""
    img = cv2.imread(str(path))
    if img is None:
        raise ValueError(f"cannot decode {path}")
    return img.shape[1], img.shape[0]


def _image_shape(path) -> Tuple[int, int]:
    """(w, h) with EXIF rotation respected: from PIL where it is installed,
    else from the cv2 decode."""
    try:
        import PIL  # noqa: F401
    except ImportError:
        return _image_shape_cv2(path)
    return _image_shape_pil(path)


def build_label_cache(im_files: Sequence[str], *, kind: str = "coco",
                      odgt_paths: Sequence[str] = (),
                      xml_dir: Optional[str] = None,
                      cut_max_len: int = -1,
                      cache_path: Optional[str] = None,
                      prefix: str = "") -> Dict:
    """Scan labels for every image -> {im_file: (labels, (w, h), segments)}.

    kind='coco': per-image YOLO txt (reference datasets.py:599-647).
    kind='human': joint CrowdHuman(.odgt) + SHEL(xml) labels with the
    cut_max_len image-drop rule (reference datasets.py:649-803).
    The cache key covers the file list and each label file's size and
    mtime, so an edited label invalidates the cache.
    """
    sig_parts = ["|".join(im_files), f"{kind}{cut_max_len}"]
    for lb in img2label_paths(list(im_files)):
        try:
            st = os.stat(lb)
            sig_parts.append(f"{st.st_size}:{st.st_mtime_ns}")
        except OSError:
            sig_parts.append("absent")
    key = hashlib.md5("|".join(sig_parts).encode()).hexdigest()
    if cache_path and os.path.isfile(cache_path):
        with open(cache_path, "rb") as f:
            cache = pickle.load(f)
        if cache.get("version") == CACHE_VERSION and cache.get("key") == key:
            return cache
    human_dict: Dict[str, list] = {}
    shel_dict: Dict[str, list] = {}
    if kind == "human":
        human_dict = parse_crowdhuman_odgt(odgt_paths)
        if xml_dir:
            xmls = glob.glob(os.path.join(xml_dir, "**", "*.xml"), recursive=True)
            shel_dict = parse_shel_xml(xmls)

    items: Dict[str, tuple] = {}
    stats = {"found": 0, "missing": 0, "empty": 0, "corrupt": 0,
             "max_label_len": 0, "cut_crowd_human_num": 0,
             "cut_safety_helmet_num": 0}
    label_files = img2label_paths(im_files)
    for im_file, lb_file in zip(im_files, label_files):
        try:
            w, h = _image_shape(im_file)
            if w <= 9 or h <= 9:
                raise ValueError(f"image size {w}x{h} < 10 pixels")
            segments: list = []
            if kind == "coco":
                labels, segments = parse_yolo_txt(lb_file)
                if os.path.isfile(lb_file):
                    stats["found" if len(labels) else "empty"] += 1
                else:
                    stats["missing"] += 1
            else:
                stem = Path(im_file).stem
                is_crowd = "CrowdHuman" in im_file or stem in human_dict
                if is_crowd and stem in human_dict:
                    labels = crowdhuman_labels(human_dict[stem], w, h)
                    src = "crowd"
                elif stem in shel_dict:
                    labels = shel_labels(shel_dict[stem], w, h)
                    src = "shel"
                else:
                    labels = np.zeros((0, 5), np.float32)
                    src = "none"
                stats["max_label_len"] = max(stats["max_label_len"], len(labels))
                if len(labels) == 0:
                    stats["empty"] += 1
                    continue
                if cut_max_len != -1 and len(labels) > cut_max_len:
                    # drop over-dense images entirely (reference
                    # datasets.py:790-795, the fork's OTA-OOM mitigation)
                    stats["cut_crowd_human_num" if src == "crowd"
                          else "cut_safety_helmet_num"] += 1
                    continue
                stats["found"] += 1
            items[im_file] = (labels, (w, h), segments)
        except Exception as e:  # noqa: BLE001 — a bad file is counted and skipped
            stats["corrupt"] += 1
            print(f"{prefix}WARNING: ignoring corrupt image/label {im_file}: {e}")

    cache = {"version": CACHE_VERSION, "key": key, "items": items,
             "stats": stats}
    if cache_path:
        os.makedirs(os.path.dirname(os.path.abspath(cache_path)), exist_ok=True)
        with open(cache_path, "wb") as f:
            pickle.dump(cache, f)
    return cache


class DetectionDataset:
    """Map-style dataset yielding augmented (img RGB uint8 HWC, labels,
    path, shapes); its draws come from `self.rng` and `self.np_rng`."""

    def __init__(self, path, img_size=640, batch_size=16, augment=False,
                 hyp: Optional[dict] = None, rect=False, image_weights=False,
                 stride=32, pad=0.0, kind="coco", odgt_paths=(),
                 xml_dir=None, cut_max_len=-1, cache_path=None, prefix="",
                 cache_images=False, device_tail=False, fast_decode=False,
                 single_cls=False, seed=0):
        # device_tail: the host decodes, places and draws the parameters;
        # warp, HSV, flips and mixup run on the device (`device_item`)
        self.device_tail = device_tail and augment
        self.rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)
        # fast_decode: DCT-domain reduced JPEG decode when the image will
        # be downscaled >= 2x anyway. A documented deviation from the
        # reference (which full-decodes then resizes): the resampled pixels
        # differ slightly, so it is opt-in (large-image datasets).
        self.fast_decode = fast_decode
        self.img_size = img_size
        self.augment = augment
        self.hyp = dict(DEFAULT_HYP, **(hyp or {}))
        self.rect = rect and not image_weights
        self.stride = stride
        self.pad = pad
        self.mosaic = augment and not rect
        self.mosaic_border = [-img_size // 2, -img_size // 2]

        im_files = _scan_img_files(path)
        if not im_files:
            raise FileNotFoundError(f"no images found in {path}")
        if cache_path is None and isinstance(path, str) and path.endswith(".txt"):
            cache_path = path.rsplit(".", 1)[0] + ".ystpu.cache"
        cache = build_label_cache(
            im_files, kind=kind, odgt_paths=odgt_paths, xml_dir=xml_dir,
            cut_max_len=cut_max_len, cache_path=cache_path, prefix=prefix)
        items = cache["items"]
        self.stats = cache["stats"]
        if kind == "human":
            # dropped / empty images are removed from the epoch entirely
            im_files = [f for f in im_files if f in items]
        self.im_files = im_files
        self.labels = [items.get(f, (np.zeros((0, 5), np.float32), None, []))[0]
                       for f in im_files]
        if single_cls:  # train/test --single-cls (reference datasets.py:452)
            self.labels = [np.concatenate(
                [np.zeros_like(lb[:, :1]), lb[:, 1:]], 1) for lb in self.labels]
        self.shapes = np.array(
            [items.get(f, (None, (1, 1), None))[1] or (1, 1) for f in im_files],
            np.float64)  # (w, h)
        self.segments = [items.get(f, (None, None, []))[2] for f in im_files]
        n = len(im_files)
        self.indices = np.arange(n)
        self.batch_index = np.floor(np.arange(n) / batch_size).astype(int)
        self._img_cache = None

        if self.rect:
            # aspect-ratio sort + per-batch shapes (reference
            # datasets.py:467-490)
            ar = self.shapes[:, 1] / self.shapes[:, 0]
            irect = ar.argsort()
            self.im_files = [self.im_files[i] for i in irect]
            self.labels = [self.labels[i] for i in irect]
            self.segments = [self.segments[i] for i in irect]
            self.shapes = self.shapes[irect]
            ar = ar[irect]
            nb = self.batch_index[-1] + 1
            shapes = []
            for i in range(nb):
                ari = ar[self.batch_index == i]
                mini, maxi = ari.min(), ari.max()
                if maxi < 1:
                    shapes.append([maxi, 1])
                elif mini > 1:
                    shapes.append([1, 1 / mini])
                else:
                    shapes.append([1, 1])
            self.batch_shapes = np.ceil(
                np.array(shapes) * img_size / stride + pad).astype(int) * stride

        if cache_images:  # after any rect re-ordering
            self._img_cache = [self._read_resize(i) for i in range(n)]

    def __len__(self):
        return len(self.im_files)

    # -- image io ---------------------------------------------------------

    def _read_resize(self, i):
        path = self.im_files[i]
        img = None
        h0 = w0 = None
        if self.fast_decode and self.shapes is not None:
            # decode at 1/2 or 1/4 scale inside the JPEG decoder when the
            # target is at least that much smaller (the label cache holds
            # the size, so no full decode is needed to know it)
            w0, h0 = int(self.shapes[i][0]), int(self.shapes[i][1])
            r = self.img_size / max(h0, w0)
            if r <= 0.25:
                img = cv2.imread(path, cv2.IMREAD_REDUCED_COLOR_4)
            elif r <= 0.5:
                img = cv2.imread(path, cv2.IMREAD_REDUCED_COLOR_2)
            if img is not None and img.ndim == 2:
                img = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
            if img is not None:
                # a stale label cache (file re-encoded, EXIF-swapped dims)
                # would mis-scale the labels: fall back to a full decode
                # when the reduced decode does not match the cached size
                scale = round(max(h0, w0) / max(img.shape[:2]))
                if (abs(img.shape[0] * scale - h0) > scale
                        or abs(img.shape[1] * scale - w0) > scale):
                    img = None
        if img is None:
            img = cv2.imread(path)
            if img is None:
                raise FileNotFoundError(f"image not found {path}")
            h0, w0 = img.shape[:2]
        r = self.img_size / max(h0, w0)
        tw, th = int(w0 * r), int(h0 * r)
        if img.shape[:2] != (th, tw):
            interp = cv2.INTER_AREA if r < 1 and not self.augment else cv2.INTER_LINEAR
            img = cv2.resize(img, (tw, th), interpolation=interp)
        return img, (h0, w0), img.shape[:2]

    def load_image(self, i):
        """Read + resize long side to img_size, with optional RAM cache
        (reference datasets.py:959-973, cache :493-512)."""
        if self._img_cache is not None and self._img_cache[i] is not None:
            img, hw0, hw = self._img_cache[i]
            return img.copy(), hw0, hw
        return self._read_resize(i)

    def _labels_xyxy(self, i, ratio_w, ratio_h, padw, padh):
        """Stored normalized cls-xywh -> pixel cls-xyxy for a placed image."""
        lb = self.labels[i]
        out = lb.copy()
        if len(lb):
            out[:, 1] = ratio_w * (lb[:, 1] - lb[:, 3] / 2) + padw
            out[:, 2] = ratio_h * (lb[:, 2] - lb[:, 4] / 2) + padh
            out[:, 3] = ratio_w * (lb[:, 1] + lb[:, 3] / 2) + padw
            out[:, 4] = ratio_h * (lb[:, 2] + lb[:, 4] / 2) + padh
        return out

    def _load_mosaic(self, index, nine=False):
        rng = self.rng
        k = 8 if nine else 3
        idxs = [index] + rng.choices(range(len(self)), k=k)
        rng.shuffle(idxs)
        imgs, lbs = [], []
        for i in idxs:
            img, _, (h, w) = self.load_image(i)
            imgs.append(img)
            lbs.append(self._labels_xyxy(i, w, h, 0, 0))
        fn = A.mosaic9 if nine else A.mosaic4
        canvas, labels = fn(imgs, lbs, self.img_size, rng)
        segments: list = []
        canvas, labels, segments = A.copy_paste(
            canvas, labels, segments, p=self.hyp["copy_paste"], rng=rng)
        canvas, labels = A.random_perspective(
            canvas, labels, segments,
            degrees=self.hyp["degrees"], translate=self.hyp["translate"],
            scale=self.hyp["scale"], shear=self.hyp["shear"],
            perspective=self.hyp["perspective"], border=self.mosaic_border,
            rng=rng)
        return canvas, labels

    def _sample_segments(self, n_needed=30):
        """Collect paste-in samples (cls, crop, mask) from segmented labels
        (reference load_samples/sample_segments, datasets.py:1136-1257)."""
        samples = []
        tries = 0
        while len(samples) < n_needed and tries < n_needed * 2:
            tries += 1
            i = self.rng.randint(0, len(self) - 1)
            segs = self.segments[i]
            if not segs:
                continue
            img, _, (h, w) = self.load_image(i)
            lb = self._labels_xyxy(i, w, h, 0, 0)
            for j, seg in enumerate(segs[: max(1, n_needed - len(samples))]):
                seg_px = (seg * [w, h]).astype(np.int32)
                x1, y1 = seg_px.min(0)
                x2, y2 = seg_px.max(0)
                if x2 - x1 < 10 or y2 - y1 < 10:
                    continue
                mask = np.zeros((h, w), np.uint8)
                cv2.drawContours(mask, [seg_px], -1, 255, cv2.FILLED)
                samples.append((lb[j, 0] if j < len(lb) else 0,
                                img[y1:y2, x1:x2].copy(),
                                mask[y1:y2, x1:x2].copy()))
        return samples

    # -- device-tail item -------------------------------------------------

    def device_item(self, index):
        """The host half of the device-augment tail: decode, mosaic
        placement, the augmentation parameters and the label math; the
        warp, HSV, flips and mixup run on the device with the same
        parameters (`data/device_aug.make_device_augment`).

        Returns dict(canvas (2s, 2s, 3) uint8 BGR, or None with tiles
        (tiles (4, s, s, 3) uint8 BGR, origins (4, 2), centers (2,)), minv
        (2, 3) fp32 out -> src, hsv (3,) fp32 gains, flips (2,) bool [ud,
        lr], labels (n, 5) cls + normalized xywh, after the warp and flips).
        """
        import yolo_series_tpu_torch.data.device_aug as DA

        hyp, rng = self.hyp, self.rng
        if hyp.get("perspective", 0):
            # the device warps are affine (invert_affine drops the projective
            # row) while warp_labels applies the full homography: pixels and
            # labels would part. No shipped hyp sets perspective != 0.
            raise ValueError("the device-augment tail needs hyp['perspective'] == 0 "
                             "(the device warp is affine); use the host augmentation")
        s = self.img_size
        tile_pack = None
        if rng.random() < hyp["mosaic"]:
            nine = rng.random() >= 0.8
            k = 8 if nine else 3
            idxs = [index] + rng.choices(range(len(self)), k=k)
            rng.shuffle(idxs)
            if not nine and not hyp.get("copy_paste", 0):
                # a 4-tile mosaic, composed on the device: the host keeps
                # decode, placement geometry and label math (reference
                # datasets.py:1010-1045); copy_paste needs the composed
                # pixels and takes the host path below
                yc = int(rng.uniform(s // 2, 2 * s - s // 2))
                xc = int(rng.uniform(s // 2, 2 * s - s // 2))
                tiles = np.full((4, s, s, 3), 114, np.uint8)
                hw, lbs = [], []
                for t, i in enumerate(idxs):
                    img, _, (h, w) = self.load_image(i)
                    tiles[t, :h, :w] = img
                    hw.append((h, w))
                    lbs.append(self._labels_xyxy(i, w, h, 0, 0))
                origins, pads = DA.mosaic4_geometry(hw, s, yc, xc)
                out_l = []
                for t in range(4):
                    if len(lbs[t]):
                        lb = lbs[t].copy()
                        lb[:, [1, 3]] += pads[t][0]
                        lb[:, [2, 4]] += pads[t][1]
                        out_l.append(lb)
                labels = (np.concatenate(out_l, 0) if out_l
                          else np.zeros((0, 5), np.float32))
                if len(labels):
                    labels[:, 1:5] = labels[:, 1:5].clip(0, 2 * s)
                tile_pack = (tiles, origins, np.array([yc, xc], np.float32))
                canvas = None
            else:
                imgs, lbs = [], []
                for i in idxs:
                    img, _, (h, w) = self.load_image(i)
                    imgs.append(img)
                    lbs.append(self._labels_xyxy(i, w, h, 0, 0))
                fn = A.mosaic9 if nine else A.mosaic4
                canvas, labels = fn(imgs, lbs, s, rng)
                canvas, labels, _ = A.copy_paste(canvas, labels, [], p=hyp["copy_paste"],
                                                 rng=rng)
            M, sc, out_hw = DA.sample_perspective_params(
                hyp["degrees"], hyp["translate"], hyp["scale"], hyp["shear"],
                hyp["perspective"], self.mosaic_border, (2 * s, 2 * s), rng)
            M_canvas = M
        else:
            img, _, (h, w) = self.load_image(index)
            base, ratio, pad = A.letterbox(img, s, auto=False, scaleup=True)
            labels = self._labels_xyxy(index, ratio[0] * w, ratio[1] * h, pad[0], pad[1])
            M, sc, out_hw = DA.sample_perspective_params(
                hyp["degrees"], hyp["translate"], hyp["scale"], hyp["shear"],
                hyp["perspective"], (0, 0), base.shape[:2], rng)
            # the s canvas rides the tile composer as 1 active tile, its
            # bottom-right corner at (3s/2, 3s/2), so it lands on [s/2, 3s/2)
            # of the 2s canvas; that shift folds into the warp
            tiles = np.full((4, s, s, 3), 114, np.uint8)
            tiles[0] = base
            off = s // 2
            origins, _ = DA.mosaic4_geometry([(s, s), (0, 0), (0, 0), (0, 0)], s,
                                             off + s, off + s)
            tile_pack = (tiles, origins, np.array([off + s, off + s], np.float32))
            canvas = None
            e_inv = np.eye(3)
            e_inv[0, 2] = -off
            e_inv[1, 2] = -off
            M_canvas = M @ e_inv

        labels = DA.warp_labels(labels, M, sc, out_hw, perspective=hyp["perspective"])
        n = len(labels)
        out = np.zeros((n, 5), np.float32)
        if n:
            out[:, 0] = labels[:, 0]
            out[:, 1] = ((labels[:, 1] + labels[:, 3]) / 2) / out_hw[1]
            out[:, 2] = ((labels[:, 2] + labels[:, 4]) / 2) / out_hw[0]
            out[:, 3] = (labels[:, 3] - labels[:, 1]) / out_hw[1]
            out[:, 4] = (labels[:, 4] - labels[:, 2]) / out_hw[0]

        gains = np.array([rng.uniform(-1, 1) for _ in range(3)], np.float64) * [
            hyp["hsv_h"], hyp["hsv_s"], hyp["hsv_v"]] + 1
        flip_ud = rng.random() < hyp["flipud"]
        flip_lr = rng.random() < hyp["fliplr"]
        if flip_ud and n:
            out[:, 2] = 1 - out[:, 2]
        if flip_lr and n:
            out[:, 1] = 1 - out[:, 1]
        return {"canvas": canvas, "tiles": tile_pack, "minv": DA.invert_affine(M_canvas),
                "hsv": gains.astype(np.float32),
                "flips": np.array([flip_ud, flip_lr], bool), "labels": out}

    # -- item -------------------------------------------------------------

    def __getitem__(self, index):
        """Returns (img RGB uint8 HWC, labels (n, 5) cls + normalized xywh,
        path, shapes_for_rescale)."""
        hyp, rng = self.hyp, self.rng
        if self.mosaic and rng.random() < hyp["mosaic"]:
            nine = rng.random() >= 0.8  # 80% 4-tile (reference :831-836)
            img, labels = self._load_mosaic(index, nine=nine)
            shapes = None
            if rng.random() < hyp["mixup"]:
                img2, labels2 = self._load_mosaic(
                    rng.randint(0, len(self) - 1), nine=rng.random() >= 0.8)
                img, labels = A.mixup(img, labels, img2, labels2, rng=self.np_rng)
        else:
            img, (h0, w0), (h, w) = self.load_image(index)
            shape = (self.batch_shapes[self.batch_index[index]]
                     if self.rect else self.img_size)
            img, ratio, pad = A.letterbox(img, shape, auto=False,
                                          scaleup=self.augment)
            shapes = (h0, w0), ((h / h0 * ratio[1], w / w0 * ratio[0]), pad)
            labels = self._labels_xyxy(index, ratio[0] * w, ratio[1] * h,
                                       pad[0], pad[1])
            if self.augment:
                img, labels = A.random_perspective(
                    img, labels, degrees=hyp["degrees"],
                    translate=hyp["translate"], scale=hyp["scale"],
                    shear=hyp["shear"], perspective=hyp["perspective"],
                    rng=rng)

        if self.augment:
            A.augment_hsv(img, hyp["hsv_h"], hyp["hsv_s"], hyp["hsv_v"], rng)
            if rng.random() < hyp.get("paste_in", 0):
                samples = self._sample_segments(30)
                if samples:
                    img, labels = A.pastein(img, labels, samples, rng)

        n = len(labels)
        out = np.zeros((n, 5), np.float32)
        if n:
            h_img, w_img = img.shape[:2]
            out[:, 0] = labels[:, 0]
            out[:, 1] = ((labels[:, 1] + labels[:, 3]) / 2) / w_img
            out[:, 2] = ((labels[:, 2] + labels[:, 4]) / 2) / h_img
            out[:, 3] = (labels[:, 3] - labels[:, 1]) / w_img
            out[:, 4] = (labels[:, 4] - labels[:, 2]) / h_img

        if self.augment:
            # cv2.flip (not numpy views) keeps the array contiguous
            if rng.random() < hyp["flipud"]:
                img = cv2.flip(img, 0)
                if n:
                    out[:, 2] = 1 - out[:, 2]
            if rng.random() < hyp["fliplr"]:
                img = cv2.flip(img, 1)
                if n:
                    out[:, 1] = 1 - out[:, 1]

        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        return img, out, self.im_files[index], shapes


def pad_labels(label_list: Sequence[np.ndarray], max_labels: int):
    """List of (n_i, 5) -> ((B, max_labels, 5), (B, max_labels) mask).
    Overflow keeps the largest-area boxes."""
    b = len(label_list)
    out = np.zeros((b, max_labels, 5), np.float32)
    mask = np.zeros((b, max_labels), bool)
    for i, lb in enumerate(label_list):
        n = len(lb)
        if n > max_labels:
            order = np.argsort(-(lb[:, 3] * lb[:, 4]))
            lb = lb[order[:max_labels]]
            n = max_labels
        out[i, :n] = lb
        mask[i, :n] = True
    return out, mask


_MALLOC_TUNED = False


def _tune_malloc_for_buffers():
    """Keep multi-MB image buffers on the glibc heap instead of mmap/munmap
    churn (each munmap returns the pages, and the next buffer faults them
    back in). Same effect as the MALLOC_MMAP_THRESHOLD_ /
    MALLOC_TRIM_THRESHOLD_ environment variables; once a process."""
    global _MALLOC_TUNED
    if _MALLOC_TUNED:
        return
    _MALLOC_TUNED = True
    try:
        import ctypes
        libc = ctypes.CDLL(None)
        libc.mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
        libc.mallopt.restype = ctypes.c_int
        libc.mallopt(-3, 128 << 20)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, 256 << 20)  # M_TRIM_THRESHOLD
    except (OSError, AttributeError):
        pass  # not glibc: the buffer pool still helps


class create_loader:
    """Batched iterator with background decode threads.

    Yields dicts {images (B, H, W, 3) uint8 RGB, labels (B, M, 5),
    label_mask (B, M), paths, shapes}. `quad=True` is the reference quad
    collate (datasets.py:931-955): every 4 samples merge into one 2x-side
    item via `_quad_item`; pair with make_train_step(loss_scale=4).

    A dataset with the device tail yields {tiles (B, 4, s, s, 3) uint8 BGR,
    origins, centers, minv, hsv, flips, mix_idx, mix_w, labels, label_mask}
    (`_make_device_batch`), the inputs of `device_aug.make_device_augment`
    with mosaic=True.

    `images` is a pooled buffer: it stays valid while the consumer holds
    at most `hold` batches it has not consumed (`_pooled`); a consumer
    that keeps a batch longer copies it.

    shard=(rank, world): DistributedSampler's semantics. `batch_size` is
    the global batch; every rank draws the same epoch order (`_order`) and
    loads only its contiguous slice of each global batch
    (`parallel/dist.host_local_slice`), batch_size / world samples.
    """

    def __init__(self, dataset: DetectionDataset, batch_size=16,
                 shuffle=True, max_labels=256, drop_last=True, seed=0,
                 prefetch=2, image_weights=False, class_weights=None,
                 hold=1, quad=False, workers=1, shard=(0, 1)):
        self.ds = dataset
        self.bs = batch_size
        self.quad = quad
        self.shard = shard
        world = shard[1]
        if world > 1 and (batch_size % world or not drop_last):
            raise ValueError(f"a loader sharded over {world} ranks needs drop_last and a "
                             f"batch that divides by {world}, not {batch_size}")
        if quad:
            if getattr(dataset, "device_tail", False):
                raise ValueError("quad is a host-collate mode: not with the device tail")
            if (batch_size // world) % 4:
                raise ValueError("quad collate needs batch_size / world % 4 == 0")
            if getattr(dataset, "rect", False):
                raise ValueError("quad needs uniform square batches")
        self.shuffle = shuffle
        self.max_labels = max_labels
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        # >= 1: Queue(0) is unbounded, which would let a worker race
        # arbitrarily far ahead of the buffer-pool contract
        self.prefetch = max(int(prefetch), 1)
        self.image_weights = image_weights
        self.class_weights = class_weights
        # `hold`: the most batches the consumer retains before consuming
        # them (gradient-accumulation micro-batches); sizes the pool
        self.hold = max(int(hold), 1)
        # workers > 1: N decode threads (cv2/numpy release the GIL). Batch
        # order is kept (batch i comes from worker i % N); the sample draws
        # interleave, so the batches differ from workers=1's
        self.workers = max(int(workers), 1)
        self._pools: dict = {}
        self._pool_pos: dict = {}
        self._pool_lock = threading.Lock()
        _tune_malloc_for_buffers()

    def __len__(self):
        n = len(self.ds)
        if self.drop_last:
            return n // self.bs
        full, r = divmod(n, self.bs)
        if r and self.quad and r < 4:
            r = 0  # a <4-sample tail cannot form a quad group
        return full + (1 if r else 0)

    def _pooled(self, key, shape, dtype=np.uint8):
        """Round-robin reusable batch buffer, pages touched once.

        Each pool belongs to one worker (`key` holds the worker id): its
        buffers are taken in that worker's batch order and, as the
        consumer takes batches in order and keeps only the latest `hold`,
        released in that order too, so round-robin reuse is safe when the
        pool holds at least what can be live at once: `prefetch` queued,
        one being filled and the worker's share of the consumer's hold + 1
        consecutive batches, ceil((hold + 1) / workers).
        """
        with self._pool_lock:
            pool = self._pools.get(key)
            if pool is None or pool[0].shape != shape or pool[0].dtype != dtype:
                share = -(-(self.hold + 1) // self.workers)
                pool = []
                for _ in range(self.prefetch + 1 + share):
                    a = np.empty(shape, dtype)
                    a.fill(0)  # page in once, up front
                    pool.append(a)
                self._pools[key] = pool
                self._pool_pos[key] = 0
            i = self._pool_pos[key]
            self._pool_pos[key] = (i + 1) % len(pool)
            return pool[i]

    def _make_batch(self, idxs, wid=0):
        if getattr(self.ds, "device_tail", False):
            return self._make_device_batch(idxs, wid)
        items = [self.ds[i] for i in idxs]
        if self.quad:
            items = [self._quad_item(items[i:i + 4], self.ds.rng)
                     for i in range(0, len(items) - 3, 4)]
        shape = (len(items),) + items[0][0].shape
        imgs = self._pooled(("images", wid), shape)
        for k, it in enumerate(items):
            imgs[k] = it[0]
        labels, mask = pad_labels([it[1] for it in items], self.max_labels)
        return {"images": imgs, "labels": labels, "label_mask": mask,
                "paths": [it[2] for it in items],
                "shapes": [it[3] for it in items]}

    @staticmethod
    def _quad_item(group, rng):
        """4 (img, labels, path, shapes) -> one 2x item (collate_fn4,
        reference datasets.py:938-949): 50% bilinear 2x upsample of the
        first image (labels unchanged: normalized), 50% a 2x2 supertile
        [[0, 2], [1, 3]] with labels shifted into their quadrant and
        halved."""
        img0 = group[0][0]
        h, w = img0.shape[:2]
        if rng.random() < 0.5:
            im = cv2.resize(img0, (w * 2, h * 2), interpolation=cv2.INTER_LINEAR)
            lb = group[0][1]
        else:
            left = np.concatenate([group[0][0], group[1][0]], axis=0)
            right = np.concatenate([group[2][0], group[3][0]], axis=0)
            im = np.concatenate([left, right], axis=1)
            shifts = ((0.0, 0.0), (0.0, 1.0), (1.0, 0.0), (1.0, 1.0))
            parts = []
            for (dx, dy), (_, l, _, _) in zip(shifts, group):
                if len(l):
                    l = l.copy()
                    l[:, 1] = (l[:, 1] + dx) * 0.5
                    l[:, 2] = (l[:, 2] + dy) * 0.5
                    l[:, 3:5] *= 0.5
                    parts.append(l)
            lb = (np.concatenate(parts, 0) if parts
                  else np.zeros((0, 5), np.float32))
        return im, lb, group[0][2], group[0][3]

    def _make_device_batch(self, idxs, wid=0):
        """The device tail's collate: uint8 tiles and the augmentation
        parameters. Mixup pairs two samples of the batch (the reference's
        second-mosaic blend, datasets.py:840-847, without a mosaic composed
        to be thrown away): the labels join on the host, the pixels blend
        on the device."""
        rng = self.ds.rng
        items = [self.ds.device_item(i) for i in idxs]
        b = len(items)
        mix_idx = np.arange(b, dtype=np.int32)
        mix_w = np.ones(b, np.float32)
        lbs = [it["labels"] for it in items]
        for i in range(b):
            if b > 1 and rng.random() < self.ds.hyp.get("mixup", 0.0):
                # one of the b - 1 other samples, so the mixup probability is
                # hyp['mixup'] exactly (the reference's second mosaic is
                # always another sample)
                j = (i + 1 + rng.randrange(b - 1)) % b
                mix_idx[i] = j
                mix_w[i] = float(self.ds.np_rng.beta(8.0, 8.0))
                if len(items[j]["labels"]):
                    lbs[i] = (np.concatenate([lbs[i], items[j]["labels"]], 0)
                              if len(lbs[i]) else items[j]["labels"])
        labels, mask = pad_labels(lbs, self.max_labels)
        s = self.ds.img_size
        # every sample rides the 4-tile form, so the pixels cross once: a
        # host-composed 2s canvas (mosaic9, copy-paste) as its 4 quadrants
        tiles = self._pooled(("tiles", wid), (b, 4, s, s, 3))
        origins = np.zeros((b, 4, 2), np.float32)
        centers = np.zeros((b, 2), np.float32)
        quad_org = np.array([[0, 0], [0, s], [s, 0], [s, s]], np.float32)
        for k, it in enumerate(items):
            if it.get("tiles") is not None:
                tiles[k], origins[k], centers[k] = it["tiles"]
            else:
                cv = it["canvas"]
                tiles[k, 0] = cv[:s, :s]
                tiles[k, 1] = cv[:s, s:]
                tiles[k, 2] = cv[s:, :s]
                tiles[k, 3] = cv[s:, s:]
                origins[k] = quad_org
                centers[k] = (s, s)
        return {"tiles": tiles, "origins": origins, "centers": centers,
                "minv": np.stack([it["minv"] for it in items]),
                "hsv": np.stack([it["hsv"] for it in items]),
                "flips": np.stack([it["flips"] for it in items]),
                "mix_idx": mix_idx, "mix_w": mix_w,
                "labels": labels, "label_mask": mask}

    def _order(self):
        """This epoch's sample order: seeded by seed + epoch."""
        n = len(self.ds)
        rng = np.random.default_rng(self.seed + self.epoch)
        if self.image_weights:
            # class-weighted epoch resampling (reference train.py:318-329)
            nc = getattr(self.ds, "nc", None) or int(max(
                (lb[:, 0].max() for lb in self.ds.labels if len(lb)),
                default=0)) + 1
            cw = (self.class_weights if self.class_weights is not None
                  else labels_to_class_weights(self.ds.labels, nc))
            iw = labels_to_image_weights(self.ds.labels, nc, cw)
            return rng.choice(n, size=n, replace=True, p=iw / max(iw.sum(), 1e-9))
        order = np.arange(n)
        if self.shuffle:
            rng.shuffle(order)
        return order

    def __iter__(self):
        order = self._order()
        self.epoch += 1
        nb = len(self)
        batches = [order[i * self.bs:(i + 1) * self.bs] for i in range(nb)]
        if self.shard[1] > 1:
            batches = [b[host_local_slice(len(b), *self.shard)] for b in batches]
        if self.quad and batches and len(batches[-1]) % 4:
            # trim a drop_last=False tail to whole quad groups, and say so
            keep = 4 * (len(batches[-1]) // 4)
            print(f"quad collate: dropping {len(batches[-1]) - keep} "
                  "tail samples (not a multiple of 4)")
            batches[-1] = batches[-1][:keep]

        w = self.workers
        qs = [queue_mod.Queue(maxsize=self.prefetch) for _ in range(w)]
        stop = threading.Event()

        def put(q, item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    pass
            return False

        def worker(wid):
            try:
                for bi in range(wid, nb, w):
                    if not put(qs[wid], self._make_batch(batches[bi], wid)):
                        return
            except BaseException as e:  # noqa: BLE001 — handed to the consumer
                # a corrupt image or label fails the epoch, not truncates it
                put(qs[wid], e)

        threads = [threading.Thread(target=worker, args=(wid,), daemon=True)
                   for wid in range(w)]
        for t in threads:
            t.start()
        try:
            # in-order delivery: batch i always comes from worker i % w
            for bi in range(nb):
                item = qs[bi % w].get()
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # the consumer is done (or stopped early): let the workers out
            stop.set()
            for t in threads:
                t.join(timeout=60)
