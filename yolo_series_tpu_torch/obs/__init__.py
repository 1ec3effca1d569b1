"""Observability helpers of the port (counterpart of `yolo_series_tpu/obs`):
the box drawing that detect needs, the experiment logger and the local
artifact store; and the port's own spans and counters (`trace.py`)."""
