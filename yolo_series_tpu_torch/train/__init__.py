"""Training-side modules of the port (counterpart of `yolo_series_tpu/train`):
the train step with its optimizer, schedules and EMA, checkpoints and the
trainer."""
