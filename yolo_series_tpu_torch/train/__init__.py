"""Training-side modules of the port (counterpart of `yolo_series_tpu/train`):
the train step with its optimizer, schedules and EMA, and the checkpoint
reader. The trainer is ROADMAP queue 1 item 11."""
