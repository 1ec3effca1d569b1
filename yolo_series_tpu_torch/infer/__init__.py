"""Serving engine of the port (counterpart of `yolo_series_tpu/infer`)."""
