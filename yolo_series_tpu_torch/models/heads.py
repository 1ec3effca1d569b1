"""The detection heads (counterpart of `yolo_series_tpu/models/heads.py`):
Detect, IDetect, IAuxDetect, the binned-size IBin and the pose head
IKeypoint.

Semantics mirror reference models/yolo.py:23-505. The decoded output
concatenates the levels into one (B, sum(na*ny*nx), no) tensor in the
reference's anchor-major order; the raw output per level is
(B, na, ny, nx, no).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from yolo_series_tpu_torch.losses.bin import SigmoidBin
from yolo_series_tpu_torch.models.layers import Ctx, ImplicitA, ImplicitM, PlainConv


def _grid(ny, nx, device):
    """(ny, nx, 1, 2) cell offsets (x, y)."""
    gy, gx = torch.meshgrid(torch.arange(ny, dtype=torch.float32, device=device),
                            torch.arange(nx, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([gx, gy], dim=-1)[:, :, None, :]


def _decode_level(p, stride, anchors_px, nc):
    """p: (B, ny, nx, na, no) raw logits -> (B, na*ny*nx, no) decoded.

    xy = (sigmoid*2 - 0.5 + grid) * stride ; wh = (sigmoid*2)^2 * anchor_px
    (reference yolo.py:55-57)."""
    b, ny, nx, na, no = p.shape
    y = torch.sigmoid(p.float())
    grid = _grid(ny, nx, p.device)
    anc = torch.as_tensor(anchors_px, dtype=torch.float32,
                          device=p.device)[None, None]            # (1, 1, na, 2)
    xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * stride
    wh = torch.square(y[..., 2:4] * 2.0) * anc
    out = torch.cat([xy, wh, y[..., 4:]], dim=-1)
    return out.permute(0, 3, 1, 2, 4).reshape(b, na * ny * nx, no)


@dataclasses.dataclass(frozen=True)
class Detect:
    """Anchor-based decode head. apply(...) returns
    ({"pred": (B, A, no), "raw": [per-level (B, na, ny, nx, no)]}, state)."""

    nc: int
    anchors: Tuple[Tuple[float, ...], ...]   # normalized by stride, (nl, na*2)
    ch: Tuple[int, ...]
    strides: Tuple[float, ...]

    @property
    def na(self):
        return len(self.anchors[0]) // 2

    @property
    def nl(self):
        return len(self.anchors)

    @property
    def no(self):
        return self.nc + 5

    def anchors_grid(self):
        """(nl, na, 2) anchors in pixels (anchor * stride)."""
        a = np.asarray(self.anchors, np.float32).reshape(self.nl, self.na, 2)
        return a * np.asarray(self.strides, np.float32)[:, None, None]

    def _convs(self) -> List[PlainConv]:
        return [PlainConv(c, self.no * self.na, 1) for c in self.ch]

    def init(self, gen):
        return {"m": [cv.init(gen)[0] for cv in self._convs()]}, {}

    def _raw_level(self, params, xs, i, ctx):
        """(B, ny, nx, na, no) logits of level i from NCHW features."""
        y, _ = self._convs()[i].apply(params["m"][i], {}, xs[i], ctx)
        b, _, ny, nx = y.shape
        return y.permute(0, 2, 3, 1).reshape(b, ny, nx, self.na, self.no)

    def apply(self, params, state, xs: Sequence[torch.Tensor], ctx: Ctx):
        """In training only {"raw": [...]} (JAX heads.py:97-107)."""
        raws, preds = [], []
        apx = self.anchors_grid()
        for i in range(self.nl):
            y = self._raw_level(params, xs, i, ctx)
            raws.append(y.permute(0, 3, 1, 2, 4))
            if not ctx.training:
                preds.append(_decode_level(y, self.strides[i], apx[i], self.nc))
        if ctx.training:
            return {"raw": raws}, state
        return {"pred": torch.cat(preds, dim=1), "raw": raws}, state

    def _bias_prior(self, stride, cf=None):
        """Additive obj/cls bias prior (reference yolo.py:633-644):
        b_obj += log(8 / (640/stride)^2); b_cls += log(0.6 / (nc - 0.99))."""
        prior = np.zeros((self.na, self.no), np.float32)
        prior[:, 4] = math.log(8.0 / (640.0 / stride) ** 2)
        if cf is None:
            prior[:, 5:] = math.log(0.6 / (self.nc - 0.99))
        else:
            prior[:, 5:] = np.log(cf / cf.sum())
        return torch.from_numpy(prior.reshape(-1))

    def init_biases(self, params, cf=None):
        new_m = [{**mp, "b": mp["b"] + self._bias_prior(self.strides[i], cf)
                  .to(mp["b"].device)}
                 for i, mp in enumerate(params["m"])]
        return {**params, "m": new_m}


@dataclasses.dataclass(frozen=True)
class IDetect(Detect):
    """Detect + YOLOR implicit knowledge (reference yolo.py:97-207): ia
    (additive, before each conv) and im (multiplicative, after it).
    `reparam.fuse_head_implicit` folds them into the convs; the params are
    then a plain Detect tree and apply takes the Detect path (the
    reference's fuseforward, yolo.py:140)."""

    def init(self, gen):
        params, state = Detect.init(self, gen)
        params["ia"] = [ImplicitA(c).init(gen)[0] for c in self.ch]
        params["im"] = [ImplicitM(self.no * self.na).init(gen)[0] for _ in self.ch]
        return params, state

    def _raw_level(self, params, xs, i, ctx):
        x = xs[i]
        if "ia" in params:
            x = ImplicitA(self.ch[i]).apply(params["ia"][i], {}, x, ctx)[0]
        y, _ = self._convs()[i].apply(params["m"][i], {}, x, ctx)
        if "im" in params:
            y = ImplicitM(self.no * self.na).apply(params["im"][i], {}, y, ctx)[0]
        b, _, ny, nx = y.shape
        return y.permute(0, 2, 3, 1).reshape(b, ny, nx, self.na, self.no)


@dataclasses.dataclass(frozen=True)
class IAuxDetect(Detect):
    """The P6 training head with an auxiliary branch (reference
    yolo.py:311-430). `ch` has 2 x nl entries: the lead convs `m` (with
    the implicit layers `ia` / `im`) on ch[:nl], the aux convs `m2` (none)
    on ch[nl:]. Training returns raw = the lead maps, then the aux maps
    (2 x nl); inference decodes the lead maps only (yolo.py:334-362).
    `reparam.fuse_head_implicit` folds ia / im into `m` and keeps `m2`."""

    def _convs(self) -> List[PlainConv]:
        return [PlainConv(c, self.no * self.na, 1) for c in self.ch[:self.nl]]

    def _aux_convs(self) -> List[PlainConv]:
        return [PlainConv(c, self.no * self.na, 1) for c in self.ch[self.nl:]]

    def init(self, gen):
        params = {"m": [cv.init(gen)[0] for cv in self._convs()],
                  "m2": [cv.init(gen)[0] for cv in self._aux_convs()],
                  "ia": [ImplicitA(c).init(gen)[0] for c in self.ch[:self.nl]],
                  "im": [ImplicitM(self.no * self.na).init(gen)[0]
                         for _ in range(self.nl)]}
        return params, {}

    _raw_level = IDetect._raw_level

    def apply(self, params, state, xs: Sequence[torch.Tensor], ctx: Ctx):
        out, state = Detect.apply(self, params, state, xs, ctx)
        if ctx.training:
            for i, cv in enumerate(self._aux_convs()):
                y, _ = cv.apply(params["m2"][i], {}, xs[self.nl + i], ctx)
                out["raw"].append(y.reshape(y.shape[0], self.na, self.no,
                                            *y.shape[2:]).permute(0, 1, 3, 4, 2))
        return out, state

    def init_biases(self, params, cf=None):
        params = Detect.init_biases(self, params, cf)
        new_m2 = [{**mp, "b": mp["b"] + self._bias_prior(self.strides[i], cf)
                   .to(mp["b"].device)}
                  for i, mp in enumerate(params["m2"])]
        return {**params, "m2": new_m2}


@dataclasses.dataclass(frozen=True)
class IBin(Detect):
    """The binned-size head (reference yolo.py:433-505): an anchor's output
    is [x, y, w bins (bin_count + 1), h bins (bin_count + 1), obj, classes],
    w and h decoded by `SigmoidBin` (the argmax bin plus the residual,
    over [0, 4] x the anchor). Params as IDetect's."""

    bin_count: int = 21

    @property
    def no(self):
        return self.nc + 3 + 2 * (self.bin_count + 1)

    def _bins(self):
        return SigmoidBin(self.bin_count, 0.0, 4.0)

    init = IDetect.init
    _raw_level = IDetect._raw_level

    def apply(self, params, state, xs, ctx):
        raws, preds = [], []
        apx = self.anchors_grid()
        sb = self._bins()
        bl = self.bin_count + 1
        for i in range(self.nl):
            yraw = self._raw_level(params, xs, i, ctx)        # (B, ny, nx, na, no)
            raws.append(yraw.permute(0, 3, 1, 2, 4))
            if not ctx.training:
                b, ny, nx, na, _ = yraw.shape
                y = torch.sigmoid(yraw.float())
                xy = (y[..., 0:2] * 2.0 - 0.5 + _grid(ny, nx, y.device)) * self.strides[i]
                anc = torch.as_tensor(apx[i], dtype=torch.float32, device=y.device)
                pw = sb.forward(y[..., 2:2 + bl]) * anc[:, 0]
                ph = sb.forward(y[..., 2 + bl:2 + 2 * bl]) * anc[:, 1]
                out = torch.cat([xy, pw[..., None], ph[..., None], y[..., 2 + 2 * bl:]], -1)
                preds.append(out.permute(0, 3, 1, 2, 4).reshape(b, na * ny * nx, -1))
        if ctx.training:
            return {"raw": raws}, state
        return {"pred": torch.cat(preds, 1), "raw": raws}, state

    def _bias_prior(self, stride, cf=None):
        """The obj / cls prior at IBin's channel layout (reference
        _initialize_biases_bin, yolo.py:657-670)."""
        prior = np.zeros((self.na, self.no), np.float32)
        obj_idx = 2 * (self.bin_count + 1) + 2
        prior[:, obj_idx] = math.log(8.0 / (640.0 / stride) ** 2)
        prior[:, obj_idx + 1:] = (math.log(0.6 / (self.nc - 0.99)) if cf is None
                                  else np.log(cf / cf.sum()))
        return torch.from_numpy(prior.reshape(-1))


@dataclasses.dataclass(frozen=True)
class IKeypoint(Detect):
    """The pose head (reference yolo.py:210-308): nc + 5 detection channels
    (convs `m`, with the implicit layers `ia` / `im`) and 3 x nkpt
    keypoint channels (convs `m_kpt`, on the level's input without `ia`).

    As in the reference and the JAX package, the det and kpt conv outputs
    are concatenated on the channel axis and that axis is read as
    (na, no): anchor 0's keypoint slots hold det channels of anchors 1
    and up. A trained network learns that reading, so it is kept. The
    keypoints' x and y decode from the raw logits, (2 t - 0.5 + grid) x
    stride, their visibility through a sigmoid."""

    nkpt: int = 17

    @property
    def no_det(self):
        return self.nc + 5

    @property
    def no_kpt(self):
        return 3 * self.nkpt

    @property
    def no(self):
        return self.no_det + self.no_kpt

    def _convs(self) -> List[PlainConv]:
        return [PlainConv(c, self.no_det * self.na, 1) for c in self.ch]

    def _kpt_convs(self) -> List[PlainConv]:
        return [PlainConv(c, self.no_kpt * self.na, 1) for c in self.ch]

    def init(self, gen):
        return {"m": [cv.init(gen)[0] for cv in self._convs()],
                "m_kpt": [cv.init(gen)[0] for cv in self._kpt_convs()],
                "ia": [ImplicitA(c).init(gen)[0] for c in self.ch],
                "im": [ImplicitM(self.no_det * self.na).init(gen)[0] for _ in self.ch]}, {}

    def apply(self, params, state, xs, ctx):
        raws, preds = [], []
        apx = self.anchors_grid()
        for i in range(self.nl):
            x = xs[i]
            xd = ImplicitA(self.ch[i]).apply(params["ia"][i], {}, x, ctx)[0] \
                if "ia" in params else x
            det, _ = self._convs()[i].apply(params["m"][i], {}, xd, ctx)
            if "im" in params:
                det = ImplicitM(self.no_det * self.na).apply(params["im"][i], {}, det, ctx)[0]
            kpt, _ = self._kpt_convs()[i].apply(params["m_kpt"][i], {}, x, ctx)
            b, _, ny, nx = det.shape
            full = torch.cat([det, kpt], dim=1).permute(0, 2, 3, 1).reshape(
                b, ny, nx, self.na, self.no)
            raws.append(full.permute(0, 3, 1, 2, 4))
            if not ctx.training:
                x_det = full[..., :self.no_det].float()
                x_kpt = full[..., self.no_det:].float()
                y = torch.sigmoid(x_det)
                grid = _grid(ny, nx, y.device)
                anc = torch.as_tensor(apx[i], dtype=torch.float32, device=y.device)[None, None]
                xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * self.strides[i]
                wh = torch.square(y[..., 2:4] * 2.0) * anc
                kx = (x_kpt[..., 0::3] * 2.0 - 0.5 + grid[..., 0:1]) * self.strides[i]
                ky = (x_kpt[..., 1::3] * 2.0 - 0.5 + grid[..., 1:2]) * self.strides[i]
                kv = torch.sigmoid(x_kpt[..., 2::3])
                kout = torch.stack([kx, ky, kv], -1).reshape(*x_kpt.shape[:-1], -1)
                out = torch.cat([xy, wh, y[..., 4:], kout], -1)
                preds.append(out.permute(0, 3, 1, 2, 4).reshape(b, self.na * ny * nx, -1))
        if ctx.training:
            return {"raw": raws}, state
        return {"pred": torch.cat(preds, 1), "raw": raws}, state

    def _bias_prior(self, stride, cf=None):
        """The obj / cls prior of the det convs (their na x (nc + 5)
        channels)."""
        prior = np.zeros((self.na, self.no_det), np.float32)
        prior[:, 4] = math.log(8.0 / (640.0 / stride) ** 2)
        prior[:, 5:] = (math.log(0.6 / (self.nc - 0.99)) if cf is None
                        else np.log(cf / cf.sum()))
        return torch.from_numpy(prior.reshape(-1))
