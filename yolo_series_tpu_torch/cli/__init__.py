"""Command-line entry points of the port (counterpart of
`yolo_series_tpu/cli`): detect, test and train."""
