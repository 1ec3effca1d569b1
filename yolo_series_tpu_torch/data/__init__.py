"""Data helpers of the port (counterpart of `yolo_series_tpu/data`): the
letterbox of inference, on the host and on the device, so far."""
