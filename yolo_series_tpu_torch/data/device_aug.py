"""Device-side image ops: the training augmentation tail and the device
letterbox (counterpart of `yolo_series_tpu/data/device_aug.py`).

The training tail splits the augmentation between host and device (the
reference runs all of it on the host, utils/datasets.py:826-922):

    host:   decode -> mosaic placement geometry -> sample aug params ->
            transform labels with the same params
            (`sample_perspective_params`, `warp_labels`, `mosaic4_geometry`,
            `invert_affine`; `data/datasets.DetectionDataset.device_item`)
    device: mosaic compose from 4 tiles -> bilinear affine warp (border
            114) -> HSV jitter -> flips -> mixup blend across the batch ->
            /255 (`make_device_augment`), on the tensors' device

The label math is the host pipeline's bit for bit; the pixels are the JAX
program's within float rounding. The resampling is JAX's: the compose and
the separable warp are `jax.image.scale_and_translate(..., "linear",
antialias=False)` (`scale_and_translate` here: the triangle-kernel weight
matrices of `compute_weight_mat`, each output's weights divided by their
sum where it exceeds 1000 eps, zero outside [-0.5, in - 0.5], applied as
two matmuls), not `F.interpolate` or `grid_sample`, whose border rules
differ. The TTA resize (`resize_bilinear`, `models/tta.py`) is the same
function with JAX's resize arguments. The matmuls run in full fp32
(`device.full_fp32`), as JAX's HIGHEST-precision einsum does.

Mixup (as in the JAX package, a documented deviation): the reference blends
a second, freshly augmented mosaic into a sample (datasets.py:840-847);
here two independently augmented members of the same batch are blended,
the same distribution over (augmented mosaic, augmented mosaic) pairs.

The device letterbox, for a fixed source shape (one camera or stream):
aspect-preserving bilinear resize and centre pad to (dst, dst), uint8 in
and out, with the static (ratio, (dw, dh)) that maps detections back
(`augment.letterbox` with auto=False, scaleup=True). Its resize is
`F.interpolate(mode="bilinear", align_corners=False, antialias=False)`,
the half-pixel-centre bilinear of `jax.image.resize(..., "bilinear",
antialias=False)`; the two sum the same taps in another order, so a value
that lands within an ulp of .5 may round the other way: pixels differ from
the JAX function's by at most 1.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from yolo_series_tpu_torch.device import full_fp32

_F32 = torch.float32
_EPS = float(np.finfo(np.float32).eps)
BORDER = 114.0


# -- JAX's linear resampling ------------------------------------------------


def weight_mat(in_size: int, out_size: int, inv_scale: torch.Tensor,
               shift: torch.Tensor) -> torch.Tensor:
    """`compute_weight_mat` of jax.image with the triangle kernel and no
    antialias: (..., in_size, out_size) fp32, for fp32 `inv_scale` and
    `shift` (= translation * inv_scale) of shape (..., 1). Output o samples
    the input at (o + 0.5) * inv_scale - shift - 0.5."""
    dev = inv_scale.device
    sample = (torch.arange(out_size, dtype=_F32, device=dev) + 0.5) * inv_scale - shift - 0.5
    x = (sample[..., None, :] - torch.arange(in_size, dtype=_F32, device=dev)[:, None]).abs()
    w = torch.clamp_min(1 - x, 0)
    total = w.sum(-2, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[..., None, :], w, torch.zeros_like(w))


def _resample(img: torch.Tensor, wy, wx) -> torch.Tensor:
    """(..., H, W, C) fp32 with row weights (..., H, OH) and column weights
    (..., W, OW) -> (..., OH, OW, C): the rows contracted first, then the
    columns, in full fp32. An axis whose weights are None is left as it
    is."""
    with full_fp32():
        if wy is not None:
            img = torch.einsum("...hwc,...ho->...owc", img, wy)
        if wx is not None:
            img = torch.einsum("...owc,...wp->...opc", img, wx)
    return img


def scale_and_translate(img: torch.Tensor, out_hw, scale: torch.Tensor,
                        translation: torch.Tensor) -> torch.Tensor:
    """`jax.image.scale_and_translate(img, (..., OH, OW, C), (H, W axes),
    scale, translation, "linear", antialias=False)` on (..., H, W, C) fp32.
    scale and translation: (..., 2) fp32, [row, column]; the weight
    arithmetic is JAX's in fp32 (inv_scale = 1 / scale)."""
    inv = 1.0 / scale
    shift = translation * inv
    h, w = img.shape[-3], img.shape[-2]
    wy = weight_mat(h, out_hw[0], inv[..., 0:1], shift[..., 0:1])
    wx = weight_mat(w, out_hw[1], inv[..., 1:2], shift[..., 1:2])
    return _resample(img, wy, wx)


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """`jax.image.resize(x, (B, OH, OW, C), "bilinear", antialias=False)`
    on (B, H, W, C) float, which is JAX's scale_and_translate over the axes
    whose size changes, with scale out / in and no translation. The scale
    is a Python float there, so its inverse is taken in double before it
    enters the fp32 weights (an fp32 inverse of an fp32 scale differs in
    the last bit for about one size pair in twenty)."""
    zero = torch.zeros(1, dtype=_F32, device=x.device)
    wy, wx = (None if o == n else
              weight_mat(n, o, torch.tensor([1.0 / (o / n)], dtype=_F32, device=x.device),
                         zero)
              for n, o in zip(x.shape[1:3], out_hw))
    return _resample(x.float(), wy, wx).to(x.dtype)


# -- host-side parameter sampling and label math ----------------------------


def sample_perspective_params(degrees, translate, scale, shear, perspective,
                              border, canvas_hw, rng):
    """The combined warp matrix of augment.random_perspective (reference
    datasets.py:1327-1352), drawn from `rng` in its order. Returns (M (3, 3)
    float64, s, (height, width) of the output)."""
    height = canvas_hw[0] + border[0] * 2
    width = canvas_hw[1] + border[1] * 2

    C = np.eye(3)
    C[0, 2] = -canvas_hw[1] / 2
    C[1, 2] = -canvas_hw[0] / 2

    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)

    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    # upper bound 1.1 + scale, not 1 + scale: an upstream quirk the
    # training-data distribution depends on (datasets.py:1332)
    s = rng.uniform(1 - scale, 1.1 + scale)
    # cv2.getRotationMatrix2D(angle=a, center=(0, 0), scale=s)
    ca, sa = math.cos(math.radians(a)), math.sin(math.radians(a))
    R[:2, :3] = np.array([[ca * s, sa * s, 0.0], [-sa * s, ca * s, 0.0]])

    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)

    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * width
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * height

    return T @ S @ R @ P @ C, s, (height, width)


def warp_labels(targets, M, s, out_hw, perspective=0.0):
    """The label transform and candidate filter of random_perspective
    (datasets.py:1354-1396) without the pixels. targets: (n, 5) [cls, x1,
    y1, x2, y2] canvas pixels -> output pixels."""
    from yolo_series_tpu_torch.data.augment import box_candidates

    height, width = out_hw
    n = len(targets)
    if not n:
        return targets
    xy = np.ones((n * 4, 3))
    xy[:, :2] = targets[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)
    xy = xy @ M.T
    xy = (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]).reshape(n, 8)
    x = xy[:, [0, 2, 4, 6]]
    y = xy[:, [1, 3, 5, 7]]
    new = np.concatenate((x.min(1), y.min(1), x.max(1), y.max(1))).reshape(4, n).T
    new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
    new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
    keep = box_candidates(box1=targets[:, 1:5].T * s, box2=new.T, area_thr=0.10)
    out = targets[keep]
    out[:, 1:5] = new[keep]
    return out


def mosaic4_geometry(hw_list, s, yc, xc):
    """Buffer origins and label offsets of a 4-tile mosaic, the reference
    placement arithmetic (datasets.py:1010-1045, `augment.mosaic4`).
    hw_list: 4 x (h, w) image sizes inside their (s, s) 114-padded tile
    buffers. Returns (origins (4, 2) [row0, col0] of each buffer on the 2s
    canvas, pads (4, 2) [padw, padh] label shifts), float32."""
    origins, pads = [], []
    for i, (h, w) in enumerate(hw_list):
        if i == 0:    # top left: image bottom-right corner at (yc, xc)
            x1a, y1a = max(xc - w, 0), max(yc - h, 0)
            x1b, y1b = w - (xc - x1a), h - (yc - y1a)
            org = (yc - h, xc - w)
        elif i == 1:  # top right: bottom-left corner at (yc, xc)
            x1a, y1a = xc, max(yc - h, 0)
            x1b, y1b = 0, h - (yc - y1a)
            org = (yc - h, xc)
        elif i == 2:  # bottom left: top-right corner at (yc, xc)
            x1a, y1a = max(xc - w, 0), yc
            x1b, y1b = w - (xc - x1a), 0
            org = (yc, xc - w)
        else:         # bottom right: top-left corner at (yc, xc)
            x1a, y1a = xc, yc
            x1b, y1b = 0, 0
            org = (yc, xc)
        origins.append(org)
        pads.append((x1a - x1b, y1a - y1b))
    return np.array(origins, np.float32), np.array(pads, np.float32)


def invert_affine(M: np.ndarray) -> np.ndarray:
    """(3, 3) affine -> (2, 3) fp32 inverse map (output px -> source px)."""
    Mi = np.linalg.inv(M)
    return np.ascontiguousarray(Mi[:2]).astype(np.float32)


# -- the device program -----------------------------------------------------


def _compose4(tiles: torch.Tensor, origins: torch.Tensor, centers: torch.Tensor,
              cs: int) -> torch.Tensor:
    """(B, 4, s, s, 3) uint8 tiles, (B, 4, 2) fp32 buffer origins on the
    canvas and (B, 2) centres (yc, xc) -> (B, cs, cs, 3) fp32 canvases:
    each buffer translated onto the canvas (scale 1; out of range -> 114
    through the (tile - 114) shift), the quadrants selected around the
    centre."""
    dev = tiles.device
    ones = torch.ones(origins.shape[:1] + (2,), dtype=_F32, device=dev)
    yy = torch.arange(cs, dtype=_F32, device=dev)
    top = (yy[None, :] < centers[:, 0:1])[:, :, None, None]     # (B, cs, 1, 1)
    left = (yy[None, :] < centers[:, 1:2])[:, None, :, None]    # (B, 1, cs, 1)
    placed = [scale_and_translate(tiles[:, i].float() - BORDER, (cs, cs), ones,
                                  origins[:, i]) + BORDER for i in range(4)]
    out = torch.where(~top & left, placed[2], placed[3])
    out = torch.where(top & ~left, placed[1], out)
    return torch.where(top & left, placed[0], out)


def _to_uint8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)


def make_mosaic_compose(img_size: int):
    """The device 4-tile mosaic compose (reference load_mosaic's pixel path,
    datasets.py:1001-1064). fn(tiles (B, 4, s, s, 3) uint8, each image in
    the top left of a 114-padded (s, s) buffer, origins (B, 4, 2) fp32,
    centers (B, 2) fp32 (yc, xc)) -> (B, 2s, 2s, 3) uint8 canvases,
    pixel-exact against the cv2 slicing path. A plain letterbox embed is
    one active tile with degenerate others."""
    def fn(tiles, origins, centers):
        return _to_uint8(_compose4(tiles, origins, centers, 2 * img_size))

    return fn


def rgb_to_hsv_cv(img: torch.Tensor):
    """cv2-convention HSV of float RGB in [0, 255]: H in [0, 180), S and V
    in [0, 255] (augment_hsv's LUT domain)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = v - mn
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    safe = torch.where(c > 0, c, one)
    h = torch.where(v == r, (g - b) / safe,
                    torch.where(v == g, 2.0 + (b - r) / safe, 4.0 + (r - g) / safe))
    h = torch.remainder(h * 30.0, 180.0)
    h = torch.where(c > 0, h, zero)
    s = torch.where(v > 0, c / torch.where(v > 0, v, one) * 255.0, zero)
    return h, s, v


def hsv_to_rgb_cv(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The inverse of `rgb_to_hsv_cv` -> (..., 3) float RGB."""
    h6 = h / 30.0   # sector in [0, 6)
    c = (s / 255.0) * v
    x = c * (1.0 - torch.abs(torch.remainder(h6, 2.0) - 1.0))
    m = v - c
    sec = torch.remainder(torch.floor(h6).to(torch.int32), 6)
    zero = torch.zeros_like(c)

    def select(choices, default):   # jnp.select: the first sector that matches
        out = default
        for k in range(len(choices) - 1, -1, -1):
            out = torch.where(sec == k, choices[k], out)
        return out

    # per-sector (r, g, b) chroma: 0 (c,x,0) 1 (x,c,0) 2 (0,c,x) 3 (0,x,c)
    # 4 (x,0,c) 5 (c,0,x)
    r = select([c, x, zero, zero, x], c)
    g = select([x, c, c, x, zero], zero)
    b = select([zero, zero, x, c, c], x)
    return torch.stack([r + m, g + m, b + m], dim=-1)


def _warp_separable(canvas: torch.Tensor, minv: torch.Tensor, s: int) -> torch.Tensor:
    """No rotation, shear or perspective: out -> src is sx = a_x x + b_x,
    sy = a_y y + b_y, a scale and translate with scale 1 / a and
    translation (0.5 (a - 1) - b) / a (the half-pixel term makes it
    cv2.warpAffine's src = a out + b). Border 114 via the (img - 114)
    shift."""
    a_x, b_x = minv[:, 0, 0], minv[:, 0, 2]
    a_y, b_y = minv[:, 1, 1], minv[:, 1, 2]
    scale = torch.stack([1.0 / a_y, 1.0 / a_x], dim=-1)
    trans = torch.stack([(0.5 * (a_y - 1.0) - b_y) / a_y,
                         (0.5 * (a_x - 1.0) - b_x) / a_x], dim=-1)
    return scale_and_translate(canvas.float() - BORDER, (s, s), scale, trans) + BORDER


def _warp_gather(canvas: torch.Tensor, minv: torch.Tensor, s: int) -> torch.Tensor:
    """A general affine: bilinear sampling, each tap outside the canvas
    reading 114."""
    dev = canvas.device
    yy, xx = torch.meshgrid(torch.arange(s, dtype=_F32, device=dev),
                            torch.arange(s, dtype=_F32, device=dev), indexing="ij")
    m = minv[:, :, :, None, None]
    sx = m[:, 0, 0] * xx + m[:, 0, 1] * yy + m[:, 0, 2]
    sy = m[:, 1, 0] * xx + m[:, 1, 1] * yy + m[:, 1, 2]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    bsz, cs = canvas.shape[0], canvas.shape[1]
    img = canvas.float()
    bi = torch.arange(bsz, device=dev)[:, None, None]

    def tap(yi, xi):
        inb = (xi >= 0) & (xi < cs) & (yi >= 0) & (yi < cs)
        val = img[bi, torch.clamp(yi, 0, cs - 1).long(), torch.clamp(xi, 0, cs - 1).long()]
        return torch.where(inb[..., None], val, torch.full_like(val, BORDER))

    w00 = (1 - fx) * (1 - fy)
    w01 = fx * (1 - fy)
    w10 = (1 - fx) * fy
    w11 = fx * fy
    return (tap(y0, x0) * w00[..., None] + tap(y0, x0 + 1) * w01[..., None]
            + tap(y0 + 1, x0) * w10[..., None] + tap(y0 + 1, x0 + 1) * w11[..., None])


# the keys of a device-tail batch (`data/datasets.create_loader`), in the
# order of `make_device_augment(mosaic=True)`'s arguments
MOSAIC_KEYS = ("tiles", "origins", "centers", "minv", "hsv", "flips", "mix_idx", "mix_w")


def make_device_augment(img_size: int, canvas_size: int, separable: bool = False,
                        mosaic: bool = False):
    """The batched tail, on the device of its inputs.

    fn(canvases (B, C, C, 3) uint8 BGR (cv2 order; the flip to RGB is done
       here), minv (B, 2, 3) fp32 out -> src affine, hsv_gains (B, 3) fp32,
       flips (B, 2) bool [ud, lr], mix_idx (B,) int partner index, mix_w
       (B,) fp32 blend weight)
      -> images (B, S, S, 3) fp32 RGB in [0, 1]

    separable=True: the warp has no rotation, shear or perspective (the
    default yolov7 hyps), so it is a scale and translate: two matmuls per
    image instead of a gather a pixel. The caller holds the hyp to that.

    mosaic=True: fn(tiles (B, 4, s, s, 3) uint8, origins (B, 4, 2) fp32,
    centers (B, 2) fp32, minv, hsv_gains, flips, mix_idx, mix_w): the
    canvas is composed here from 4 tiles first (`make_mosaic_compose`).
    Every sample kind rides this form, so the pixels cross once: a 4-tile
    mosaic as its tiles, a host-composed canvas (mosaic9, copy-paste) as
    its 4 quadrants, a letterboxed image as 1 active tile.
    """
    s = img_size
    warp = _warp_separable if separable else _warp_gather

    def tail(canvases, minv, hsv_gains, flips, mix_idx, mix_w):
        canvases = torch.flip(canvases, [-1])   # BGR -> RGB
        out = _to_uint8(warp(canvases, minv, s)).float()
        # HSV jitter (augment_hsv: gains on H, S, V, H mod 180; the LUT's
        # truncation approximated in float, datasets.py:976-987)
        h, sat, v = rgb_to_hsv_cv(out)
        g = hsv_gains[:, :, None, None]
        h = torch.remainder(h * g[:, 0], 180.0)
        sat = torch.clamp(sat * g[:, 1], 0.0, 255.0)
        v = torch.clamp(v * g[:, 2], 0.0, 255.0)
        imgs = hsv_to_rgb_cv(h, sat, v)
        imgs = torch.where(flips[:, 0, None, None, None], torch.flip(imgs, [1]), imgs)
        imgs = torch.where(flips[:, 1, None, None, None], torch.flip(imgs, [2]), imgs)
        # mixup across the batch (the identity where mix_w == 1)
        partners = imgs[mix_idx.long()]
        w = mix_w[:, None, None, None]
        imgs = imgs * w + partners * (1.0 - w)
        return imgs / 255.0

    if not mosaic:
        return tail

    def fn_mosaic(tiles, origins, centers, minv, hsv_gains, flips, mix_idx, mix_w):
        composed = _to_uint8(_compose4(tiles, origins, centers, canvas_size))
        return tail(composed, minv, hsv_gains, flips, mix_idx, mix_w)

    return fn_mosaic


def make_device_letterbox(src_hw, dst: int = 640, pad_value: float = 114.0):
    """Returns (fn, (r, r), (dw, dh)); fn maps (B, h, w, 3) uint8 NHWC to
    (B, dst, dst, 3) uint8 on the input's device."""
    h, w = src_hw
    r = min(dst / h, dst / w)
    new_w, new_h = int(round(w * r)), int(round(h * r))
    dw, dh = (dst - new_w) / 2, (dst - new_h) / 2
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))

    def fn(x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[1:3]) != (h, w):
            raise ValueError(f"frames {tuple(x.shape)}: this letterbox takes "
                             f"(B, {h}, {w}, 3)")
        y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(new_h, new_w),
                          mode="bilinear", align_corners=False, antialias=False)
        y = torch.clamp(torch.round(y), 0, 255)
        y = F.pad(y, (left, right, top, bottom), value=pad_value)
        return y.to(torch.uint8).permute(0, 2, 3, 1)

    return fn, (r, r), (dw, dh)

