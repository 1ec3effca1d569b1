"""What every cell shares: the benchmark's files found by name, the
environment, the device checks, spans, the peaks, and the result line."""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]       # benchmark/
ROOT = BENCH.parent                                # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "yolo_series_tpu")
DEVICE = "cuda"   # the CPU rehearsals of the tests set "cpu"


def setup_env():
    """Fixed cache directories inside the checkout (so only a checkout's
    first run builds), and no JAX behind a library's back. Call before
    torch is imported."""
    cache = ROOT / "build" / "bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str):
    """(workload entry, configuration, traffic mix) of the cell `name`: the
    configuration from benchmark/configs/<config>.json, the mix from
    benchmark/traffic/<traffic>.json."""
    s = spec()
    wl = [w for w in s["workloads"] if w["name"] == name]
    if not wl:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    wl = wl[0]
    cfg = load_json(BENCH / "configs" / f"{wl['config']}.json")
    mix = load_json(BENCH / "traffic" / f"{wl['traffic']}.json")
    return wl, cfg, mix


def cell_metrics(name: str, kind: str) -> List[dict]:
    """The metrics of `kind` ("end_to_end" or "per_layer") that the cell
    reports: those listing it under "workloads"; one without the key when
    the cell reports the end-to-end metric it moves (per-layer) or always
    (end-to-end)."""
    s = spec()
    out = []
    e2e = {m["name"] for m in cell_metrics(name, "end_to_end")} if kind == "per_layer" else None
    for m in s[kind]:
        if "workloads" in m:
            if name in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def reader_path(metric: str) -> Path:
    """benchmark/metrics/<metric>.py; for a quantity split by the cells
    that report it (`<quantity>.<cells>`) without a file of its own, the
    quantity's benchmark/metrics/<quantity>.py."""
    path = BENCH / "metrics" / f"{metric}.py"
    return path if path.is_file() else BENCH / "metrics" / f"{metric.split('.', 1)[0]}.py"


def reader(metric: str):
    """The metric's `read(run) -> value or None` (see `reader_path`)."""
    path = reader_path(metric)
    mod_name = "bench_metric_" + path.stem.replace(".", "_").replace("-", "_")
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (yolo_series_tpu_torch is not yolo_series_tpu)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def check_program():
    """The program under test is the checkout's own `yolo_series_tpu_torch`,
    never a copy installed elsewhere."""
    try:
        import yolo_series_tpu_torch as prog
    except ImportError as e:
        raise SystemExit(f"the program is not in this checkout: {e}")
    where = Path(prog.__file__).resolve()
    if ROOT not in where.parents:
        raise SystemExit(f"yolo_series_tpu_torch is imported from {where}, not from {ROOT}")


def check_device(chips: int):
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark measures the port on the card")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"{torch.cuda.device_count()} CUDA devices, the cell needs {chips}")


class Spans:
    """Host-clock spans the harness puts around its calls into the
    program's layers; each is also a profiler annotation "bench.<name>"
    (named in a traced run's idle gaps)."""

    def __init__(self):
        self.durations: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        import torch
        t = time.perf_counter()
        with torch.profiler.record_function("bench." + name):
            yield
        self.durations.setdefault(name, []).append(time.perf_counter() - t)

    def reset(self):
        self.durations = {}


def emit(result: dict, checks: Dict[str, tuple]):
    """The compared numbers as the last lines on standard error, then the
    result line as the last line of standard output, its "checks" key
    last."""
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr, flush=True)
    result = dict(result)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    print(json.dumps(result), flush=True)
    return result


def device_info(count: int, peak: Optional[int]) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak or 0)}
