"""Static-shape label assignment candidates (counterpart of
`yolo_series_tpu/losses/targets.py`, the reference's build_targets
family, utils/loss.py:500-553).

Labels are padded to (B, M, 5) with a validity mask, and each (gt, anchor,
offset) triple is a candidate slot with its own validity bit. Candidate
layout a level: (B, M, na, K), K = 5 lateral offsets.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

# offset directions: center, left, up, right, down (reference loss.py:510-514)
_OFF = np.asarray(
    [[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]], np.float32)


@functools.lru_cache(maxsize=None)
def _const_on(values: Tuple[float, ...], shape: Tuple[int, ...],
              device: torch.device) -> torch.Tensor:
    """An fp32 constant of the loss on `device`, made at its first use and
    shared after it (never written). Each value is written by a fill on the
    device, not copied from the host: no call of a step, not even the
    first, waits for the card, so the first call's check for syncs finds
    none (`train/step`). Made outside inference mode, so that autograd can
    use it whoever made it."""
    with torch.inference_mode(False):
        t = torch.empty(len(values), dtype=torch.float32, device=device)
        for i, v in enumerate(values):
            t[i].fill_(v)     # (`t[i] = v` would copy v from the host)
        return t.reshape(shape)


def const_on(x, device: torch.device) -> torch.Tensor:
    """`x` (numbers or an array) as the cached fp32 tensor on `device`: the
    values of `torch.tensor(x, dtype=torch.float32)`."""
    a = np.asarray(x, np.float32)
    return _const_on(tuple(a.reshape(-1).tolist()), a.shape, torch.device(device))


@dataclasses.dataclass(frozen=True)
class LevelCandidates:
    """Candidates of one pyramid level: gi, gj (int64 grid x, y), valid
    (bool), all (B, M, na, K); tbox (B, M, na, K, 4), the (dx, dy, w, h)
    target relative to the cell in grid units; tcls (B, M) int64; anchors
    (na, 2) in grid units."""

    gi: torch.Tensor
    gj: torch.Tensor
    valid: torch.Tensor
    tbox: torch.Tensor
    tcls: torch.Tensor
    anchors: torch.Tensor


def find_positive(labels: torch.Tensor, label_mask: torch.Tensor,
                  anchors: np.ndarray, grid: Tuple[int, int],
                  anchor_t: float, g: float = 0.5) -> LevelCandidates:
    """Candidates for one level.

    labels: (B, M, 5) rows [cls, x, y, w, h] normalized; label_mask (B, M).
    anchors: (na, 2) in grid units. grid: (ny, nx). g: the offset trigger
    radius (0.5: 3 positives an axis, 1.0: 5, reference loss.py:1592).
    """
    ny, nx = grid
    na = anchors.shape[0]
    b, m, _ = labels.shape
    dev = labels.device

    gain = const_on([nx, ny, nx, ny], dev)
    txywh = labels[..., 1:5] * gain                    # (B, M, 4) grid units
    txy = txywh[..., 0:2]
    twh = txywh[..., 2:4]

    anc = const_on(anchors, dev)                       # (na, 2)
    r = twh[:, :, None, :] / anc[None, None, :, :]     # (B, M, na, 2)
    anchor_ok = torch.maximum(r, 1.0 / r).amax(-1) < anchor_t   # (B, M, na)

    inv = const_on([nx, ny], dev) - txy
    fx, fy = txy[..., 0] % 1.0, txy[..., 1] % 1.0
    ix, iy = inv[..., 0] % 1.0, inv[..., 1] % 1.0
    off_ok = torch.stack([
        torch.ones_like(fx, dtype=torch.bool),
        (fx < g) & (txy[..., 0] > 1.0),
        (fy < g) & (txy[..., 1] > 1.0),
        (ix < g) & (inv[..., 0] > 1.0),
        (iy < g) & (inv[..., 1] > 1.0),
    ], dim=-1)                                         # (B, M, K)

    off = const_on(_OFF * np.float32(g), dev)          # (K, 2)
    # gij = floor(txy - off), clamped before the box target is taken from
    # it (the reference clamps in place, loss.py:545-548)
    gij = torch.floor(txy[:, :, None, :] - off[None, None, :, :]).long()
    gi = torch.clamp(gij[..., 0], 0, nx - 1)
    gj = torch.clamp(gij[..., 1], 0, ny - 1)

    dxy = txy[:, :, None, :] - torch.stack([gi, gj], -1).float()
    tbox = torch.cat([dxy, twh[:, :, None, :].expand(dxy.shape)], dim=-1)  # (B,M,K,4)

    valid = (label_mask[:, :, None, None] & anchor_ok[:, :, :, None]
             & off_ok[:, :, None, :])

    def bkast(x):
        return x[:, :, None, :].expand(b, m, na, x.shape[-1])

    return LevelCandidates(
        gi=bkast(gi), gj=bkast(gj), valid=valid,
        tbox=tbox[:, :, None, :, :].expand(b, m, na, 5, 4),
        tcls=labels[..., 0].long(), anchors=anc)
