"""Several devices (counterpart of `yolo_series_tpu/parallel`): data-parallel
training across processes, `parallel/dist.py`; the ('data', 'model') device
grid and the tensor-parallel rule that serving uses, `parallel/mesh.py`."""
