"""Data-parallel training across processes (counterpart of
`yolo_series_tpu/parallel`): `parallel/dist.py`."""
