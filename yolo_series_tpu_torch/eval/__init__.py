"""Evaluation of the port (counterpart of `yolo_series_tpu/eval`): metrics,
the mAP evaluator and the numpy COCOeval."""
