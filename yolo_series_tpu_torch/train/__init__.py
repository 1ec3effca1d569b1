"""Training-side modules of the port (counterpart of `yolo_series_tpu/train`);
only the checkpoint reader is ported so far."""
