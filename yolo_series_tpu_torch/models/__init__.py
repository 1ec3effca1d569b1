"""Graph compiler, blocks, heads and deploy transforms of the port
(counterpart of `yolo_series_tpu/models`)."""
