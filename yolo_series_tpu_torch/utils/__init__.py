"""Host utilities of the port (counterpart of `yolo_series_tpu/utils`)."""
