"""Data pipeline of the port (counterpart of `yolo_series_tpu/data`): label
parsers, host augmentation, the dataset and its batched loader, and the
device letterbox of inference."""
