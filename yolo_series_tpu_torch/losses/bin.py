"""SigmoidBin, the bin classification + residual regression codec of the
IBin head and the bin-OTA loss (counterpart of
`yolo_series_tpu/losses/bin.py`; reference utils/loss.py:33-118).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from yolo_series_tpu_torch.losses.yolo_loss import bce_logits


@dataclasses.dataclass(frozen=True)
class SigmoidBin:
    bin_count: int = 10
    vmin: float = 0.0
    vmax: float = 1.0
    reg_scale: float = 2.0
    use_loss_regression: bool = True
    use_fw_regression: bool = True
    bce_weight: float = 1.0
    smooth_eps: float = 0.0

    @property
    def length(self):
        return self.bin_count + 1

    @property
    def scale(self):
        return float(self.vmax - self.vmin)

    @property
    def step(self):
        return self.scale / self.bin_count

    def bins(self, device=None):
        """The bin centres, fp32 (the JAX package's float32 numpy table)."""
        start = self.vmin + (self.scale / 2.0) / self.bin_count
        table = np.arange(self.bin_count, dtype=np.float32) * self.step + start
        return torch.from_numpy(table.astype(np.float32)).to(device)

    def forward(self, pred):
        """Decode (..., length) sigmoid-activated outputs to values: the
        argmax bin's centre (the first bin at a tie, as `jnp.argmax`) plus
        the residual (reference forward, loss.py:71-86)."""
        pred_reg = (pred[..., 0] * self.reg_scale - self.reg_scale / 2.0) * self.step
        bin_idx = torch.argmax(pred[..., 1:1 + self.bin_count], dim=-1)
        bias = self.bins(pred.device)[bin_idx]
        out = pred_reg + bias if self.use_fw_regression else bias
        return torch.clamp(out, self.vmin, self.vmax)

    def training_loss(self, pred, target, valid=None, count=None):
        """pred: (..., length) raw logits; target: (...) values. Returns
        (loss, decoded): the BCE over the bins plus, with
        use_loss_regression, the MSE of the regressed value (reference
        training_loss, loss.py:89-118). `valid` masks padded rows, and the
        means are over max(count, 1) rows: `count` when given (the global
        batch's positives under a process group), else valid's."""
        cp = 1.0 - 0.5 * self.smooth_eps
        cn = 0.5 * self.smooth_eps
        pred_reg = (torch.sigmoid(pred[..., 0]) * self.reg_scale
                    - self.reg_scale / 2.0) * self.step
        pred_bin = pred[..., 1:1 + self.bin_count]
        bins = self.bins(pred.device)
        bin_idx = torch.argmin(torch.abs(target[..., None] - bins), dim=-1)
        result = pred_reg + bins[bin_idx]

        onehot = F.one_hot(bin_idx, self.bin_count).bool()
        tbins = torch.where(onehot, torch.full((), cp, dtype=pred_bin.dtype, device=pred.device),
                            torch.full((), cn, dtype=pred_bin.dtype, device=pred.device))
        bce = bce_logits(pred_bin, tbins, self.bce_weight)
        if valid is None:
            loss = bce.mean()
            if self.use_loss_regression:
                loss = loss + torch.square(result - target).mean()
        else:
            v = valid.to(bce.dtype)
            den = torch.clamp(v.sum() if count is None else count, min=1.0)
            loss = (bce.mean(-1) * v).sum() / den
            if self.use_loss_regression:
                loss = loss + (torch.square(result - target) * v).sum() / den
        return loss, torch.clamp(result, self.vmin, self.vmax)
