"""Evaluation of the port (counterpart of `yolo_series_tpu/eval`): metrics
and the mAP evaluator."""
