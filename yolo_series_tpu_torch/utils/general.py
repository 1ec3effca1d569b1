"""Host utilities (counterpart of `increment_path` in
`yolo_series_tpu/utils/general.py`; reference general.py:891-904). The
rest of that module is ROADMAP queue 1, item 19."""

from __future__ import annotations

from pathlib import Path


def increment_path(path, exist_ok=False):
    """runs/detect/exp -> exp{2,3,...}: the first of them that does not
    exist (`path` itself when it does not, or with exist_ok)."""
    path = Path(path)
    if not path.exists() or exist_ok:
        return path
    for n in range(2, 9999):
        p = Path(f"{path}{n}")
        if not p.exists():
            return p
    raise RuntimeError("too many runs")
