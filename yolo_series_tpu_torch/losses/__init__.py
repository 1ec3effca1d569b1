"""Losses (counterpart of `yolo_series_tpu/losses`)."""

from yolo_series_tpu_torch.losses.aux_ota import make_compute_loss_aux_ota
from yolo_series_tpu_torch.losses.bin import SigmoidBin
from yolo_series_tpu_torch.losses.bin_ota import make_compute_loss_bin_ota
from yolo_series_tpu_torch.losses.ota import make_compute_loss_ota
from yolo_series_tpu_torch.losses.ranking import alrp_loss, ap_loss, rank_sort_loss
from yolo_series_tpu_torch.losses.yolo_loss import LossHyp, make_compute_loss

__all__ = ["LossHyp", "SigmoidBin", "alrp_loss", "ap_loss", "make_compute_loss",
           "make_compute_loss_aux_ota", "make_compute_loss_bin_ota", "make_compute_loss_ota",
           "rank_sort_loss"]
