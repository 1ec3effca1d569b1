"""Box math, NMS and the kernel wrappers of the port (counterpart of
`yolo_series_tpu/ops`)."""
