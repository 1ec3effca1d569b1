"""Losses (counterpart of `yolo_series_tpu/losses`). The bin and ranking
losses are ROADMAP queue 1 item 15."""

from yolo_series_tpu_torch.losses.aux_ota import make_compute_loss_aux_ota
from yolo_series_tpu_torch.losses.ota import make_compute_loss_ota
from yolo_series_tpu_torch.losses.yolo_loss import LossHyp, make_compute_loss

__all__ = ["LossHyp", "make_compute_loss", "make_compute_loss_ota",
           "make_compute_loss_aux_ota"]
