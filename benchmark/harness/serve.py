"""The serving cell (kind "batch"): a batch engine fed from a frame pool
with a few batches in flight."""

from __future__ import annotations

import collections
import hashlib
import time
from typing import Dict

import numpy as np
import torch

from benchmark.harness import common, compare, port, traffic
from benchmark.reference import yolo as ref

CALIB_FRAMES = 4


def _digest(host: Dict[str, np.ndarray], i: int) -> bytes:
    h = hashlib.sha1()
    for k in sorted(host):
        h.update(np.ascontiguousarray(host[k][i]).tobytes())
    return h.digest()


def _row(host, i):
    return {k: v[i] for k, v in host.items()}


def _phases(phases) -> str:
    return "set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())


def faulty(engine, fault: str, nc: int):
    """Break the served answers underneath the harness (the tests' faults):
    "alter" gives the first detection of every image the next class,
    "half" drops the answers of the second half of every batch."""
    to_host = engine.to_host

    def broken(out):
        host = to_host(out)
        host = {k: v.copy() for k, v in host.items()}
        if fault == "alter":
            host["det_classes"][:, 0] = (host["det_classes"][:, 0] + 1) % nc
        elif fault == "half":
            b = host["num_dets"].shape[0]
            host["num_dets"][b // 2:] = 0
        else:
            raise ValueError(fault)
        return host

    engine.to_host = broken


class BatchCell:
    """Kind "batch": batches of `batch` frames from a pool of `pool` seeded
    frames go to `ServingEngine.infer_async`, up to `inflight` in flight,
    each fetched by `to_host`. The configuration's weights are drawn and
    livened from the seed; every distinct answer is held against the
    reference."""

    def __init__(self, wl, cfg, mix, seed, spans, fault=None, control=False):
        self.wl, self.cfg, self.mix, self.seed = wl, cfg, mix, int(seed)
        self.spans, self.fault, self.control = spans, fault, control
        self.answers: Dict[int, Dict[bytes, dict]] = collections.defaultdict(dict)
        self.counters: Dict[str, float] = {}
        self.phases: Dict[str, float] = {}     # set-up seconds by part (a note)

    def setup(self):
        m = self.mix
        self.batch, self.inflight = m["batch"], m["inflight"]
        img = self.cfg["img"]
        t = time.perf_counter()
        self.frames = traffic.frame_pool(self.seed, m["pool"], (img, img), device=common.DEVICE)
        self.phases["frames"] = time.perf_counter() - t
        self._build(self.frames, self.batch)
        self.n_batches = m["pool"] // self.batch
        t = time.perf_counter()
        self.window(m["warmup_s"])      # the window's own loop, until its rate has settled
        self.phases["warm-up"] = time.perf_counter() - t

    def _build(self, frames: np.ndarray, batch: int):
        dev = torch.device(common.DEVICE)
        t = time.perf_counter()
        calib = torch.from_numpy(frames[:CALIB_FRAMES]).to(dev)
        self.net, sd = ref.make_weights(self.cfg["cfg_deploy"], self.seed, dev, calib,
                                        self.cfg["nms"]["conf_thres"])
        del calib
        self.sd = {k: v.cpu() for k, v in sd.items()}
        del sd
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        self.phases["weights"] = time.perf_counter() - t
        t = time.perf_counter()
        self.engine = port.engine(self.cfg, self.sd, batch, int8=self.control)
        if self.fault:
            faulty(self.engine, self.fault, self.cfg["nc"])
        self.phases["import, fuse, engine"] = time.perf_counter() - t
        t = time.perf_counter()
        self.engine.capture()
        self.phases["kernels and capture"] = time.perf_counter() - t

    def keep(self, idx: int, host, i: int):
        """Keep one served answer of pool frame idx (each distinct one once)."""
        self.answers[idx].setdefault(_digest(host, i), _row(host, i))

    def _dispatch(self, j):
        b = self.batch
        with self.spans("infer_async"):
            out, _ = self.engine.infer_async(self.frames[j * b:(j + 1) * b])
        return out, j

    def _fetch(self, item):
        out, j = item
        with self.spans("to_host"):
            host = self.engine.to_host(out)
        return host, j

    def window(self, seconds: float, profile=None):
        """Dispatch ahead and fetch for `seconds`; the images whose answers
        reached the host by then count."""
        self.spans.reset()
        c0 = port.counters(self.engine)
        pending = collections.deque()
        done = prof_done = 0
        done_at = []
        t0 = time.perf_counter()
        end = t0 + seconds
        i = 0
        while True:
            now = time.perf_counter()
            if profile is not None:
                profile.tick(now - t0)
            if now >= end:
                break
            pending.append(self._dispatch(i % self.n_batches))
            i += 1
            if len(pending) >= self.inflight:
                host, j = self._fetch(pending.popleft())
                t = time.perf_counter()
                if t <= end:
                    done += self.batch
                    done_at.append(t - t0)
                    if profile is not None and profile.t0 is not None and profile.t1 is None:
                        prof_done += self.batch
                for k in range(self.batch):
                    self.keep(j * self.batch + k, host, k)
        t_end = time.perf_counter()
        if profile is not None:
            profile.close()
        while pending:
            host, j = self._fetch(pending.popleft())
            for k in range(self.batch):
                self.keep(j * self.batch + k, host, k)
        c1 = port.counters(self.engine)
        self.counters = {k: c1[k] - c0[k] for k in c0}
        self.record = {"kind": "batch", "window_s": t_end - t0, "images": done,
                       "batch": self.batch, "window_start": t0,
                       "attempted": i * self.batch, "failed": 0,
                       "quarters": [self.batch * sum(1 for x in done_at if q * seconds / 4 <= x
                                                     < (q + 1) * seconds / 4) for q in range(4)]}
        if profile is not None and profile.t1 is not None:
            span = profile.t1 - profile.t0
            self.record["untraced_images"] = done - prof_done
            self.record["untraced_s"] = (t_end - t0) - span
        return t0

    def release(self):
        """Free the program's state before the reference runs."""
        self.engine = None
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    @torch.no_grad()
    def check(self) -> Dict[str, float]:
        """Every distinct answer served for every pool frame against the
        fp32 reference of that frame, in blocks of 8 frames."""
        dev = torch.device(common.DEVICE)
        sd = {k: v.to(dev) for k, v in self.sd.items()}
        img, nms = self.cfg["img"], self.cfg["nms"]
        idx = sorted(self.answers)
        gaps = []
        for s in range(0, len(idx), 8):
            block = idx[s:s + 8]
            x = torch.from_numpy(self.frames[block]).to(dev)
            with ref.fp32_exact():
                raws = self.net.forward(sd, x.permute(0, 3, 1, 2).float() / 255.0)
            boxes, scores = ref.decode(self.net, raws, img)
            for j, f in enumerate(block):
                for ans in self.answers[f].values():
                    gaps.append(compare.detection_gaps(ans, boxes[j], scores[j], nms))
            del raws, boxes, scores
        return compare.widest(gaps, nms["iou_thres"])

    def notes(self):
        d = self.spans.durations
        host = {k: round(1e3 * sum(v) / len(v), 4) for k, v in d.items() if v}
        return [f"engine: {self.counters}; images by quarter of the window "
                f"{self.record['quarters']}; host ms a call {host}", _phases(self.phases)]
