"""What a traced run reads from the profiler: the device's busy time in the
traced window, kernel time by name, and the idle gaps named by what the
harness's host thread was doing (its "bench.<span>" annotations)."""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
import time
from typing import Dict, List, Tuple

import torch

from benchmark.harness import common

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def warm_profiler():
    """Start and stop the profiler once: its first start in a process
    initialises CUPTI for some seconds, which would land in the window."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        torch.zeros(1, device=common.DEVICE).add_(1)
        torch.cuda.synchronize()


class Profile:
    """A profiler over a steady sub-window of the measured window: it
    starts `at` seconds into the window and traces `length` seconds from
    the moment tracing has begun (starting the profiler takes a while)."""

    def __init__(self, at: float, length: float):
        self.at, self.length = at, length
        self.prof = self.annot = None
        self.t0 = self.t1 = None      # start and stop calls, host clock
        self.began = None             # tracing under way

    def tick(self, elapsed: float):
        """Call often from the driving thread; starts and stops tracing."""
        now = time.perf_counter()
        if self.t0 is None and elapsed >= self.at:
            self.t0 = now
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()
            self.annot = torch.profiler.record_function("bench.window")
            self.annot.__enter__()
            self.began = time.perf_counter()
        elif self.began is not None and self.t1 is None and now >= self.began + self.length:
            self.close()

    def close(self):
        if self.prof is not None and self.t1 is None:
            self.annot.__exit__(None, None, None)
            torch.cuda.synchronize()
            self.prof.stop()
            self.t1 = time.perf_counter()


def _events(prof):
    """(name, category, start us, end us) of every event of the profiler's
    Chrome trace (written to TMPDIR, read, deleted)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    evs = data["traceEvents"] if isinstance(data, dict) else data
    return [(e.get("name", ""), str(e.get("cat", "")).lower(), float(e["ts"]),
             float(e["ts"]) + float(e.get("dur", 0.0)))
            for e in evs if e.get("ph") == "X" and "ts" in e]


def _merge(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def read(prof) -> dict:
    """{busy_s, window_s, kernels: {name: (seconds, launches)}, device_ops,
    idle_gaps, categories} over the "bench.window" annotation."""
    evs = _events(prof)
    win = [e for e in evs if e[0] == "bench.window"]
    if not win:
        return {}
    w0, w1 = win[0][2], win[0][3]
    dev, annots = [], []
    cats = collections.Counter()
    for name, cat, a, b in evs:
        cats[cat] += 1
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((a, b, name))
        elif name.startswith("bench.") and name != "bench.window":
            annots.append((a, b, name[6:]))
    kernels: Dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    for a, b, name in dev:
        kernels[name][0] += (b - a) / 1e6
        kernels[name][1] += 1
    busy = _merge([(a, b) for a, b, _ in dev])
    busy_s = sum(b - a for a, b in busy) / 1e6
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    by_host: Dict[str, float] = collections.defaultdict(float)
    annots.sort()
    starts = [x[0] for x in annots]
    for a, b in gaps:
        mid = (a + b) / 2
        k = bisect.bisect_right(starts, mid)
        inside = [x for x in annots[max(0, k - 64):k] if x[1] >= mid]
        # the innermost span the host was in at the gap's middle
        name = min(inside, key=lambda x: x[1] - x[0])[2] if inside else "other host work"
        by_host[name] += (b - a) / 1e6
    ops = sorted(((k, v[0]) for k, v in kernels.items()), key=lambda x: -x[1])[:10]
    idle = sorted(by_host.items(), key=lambda x: -x[1])[:10]
    return {"busy_s": busy_s, "window_s": (w1 - w0) / 1e6,
            "kernels": {k: tuple(v) for k, v in kernels.items()},
            "device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle],
            "categories": dict(cats)}
