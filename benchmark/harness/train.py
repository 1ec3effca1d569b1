"""The training cell (kind "train"): the program's train step, built once,
driven from the seed through its first steps (the ones the reference
follows), then through the window, each step staging its batch through the
trainer's `BatchUpload` as `train/trainer.train` does."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import common, port, traffic
from benchmark.reference import train as ref_train
from benchmark.reference import yolo as ref

CHECKED = 3          # steps the reference follows
OPT_STEPS = 2        # steps whose update is held against SGD's rule
# the reference's conv precision in the program's place: the control (fp8,
# the step below the configuration's bf16), and bf16 itself (a reading)
CASTS = {True: torch.float8_e4m3fn, "control": torch.float8_e4m3fn, "bf16ref": torch.bfloat16}


def _norms(tree: Dict[str, np.ndarray], base, keys) -> Dict[str, float]:
    """Per key, the norm of tree[key] - base[key] (base None: of tree[key])."""
    out = {}
    for k in keys:
        a = np.asarray(tree[k], np.float64)
        if base is not None:
            a = a - np.asarray(base[k], np.float64)
        out[k] = float(np.sqrt(np.square(a).sum()))
    return out


def worst_leaf(got: Dict[str, float], want: Dict[str, float], keys) -> float:
    """The gap of the worst leaf: |got - want| over the larger of want's
    norm of that leaf and its median leaf's."""
    if not keys:
        return 0.0
    med = float(np.median([want[k] for k in keys]))
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keys)


def completed(times, a: float, b: float) -> float:
    """Steps completed within [a, b] of the window, given each step's
    completion time from the window's start (in order): whole steps, and
    the share of a step under way at either edge by its duration."""
    n, prev = 0.0, 0.0
    for t in times:
        lo, hi = max(prev, a), min(t, b)
        if hi > lo and t > prev:
            n += (hi - lo) / (t - prev)
        prev = t
    return n


class TrainCell:
    def __init__(self, wl, cfg, mix, seed, spans, fault=None, control=False):
        self.wl, self.cfg, self.mix, self.seed = wl, cfg, mix, int(seed)
        self.spans, self.fault, self.control = spans, fault, control
        self.counters: Dict[str, float] = {}
        self.losses: List[torch.Tensor] = []
        self.snapshots: List[tuple] = []   # the control follows no program: none

    # -- set-up: the step object and its first, checked steps --------------
    def setup(self):
        m, cfg = self.mix, self.cfg
        dev = torch.device(common.DEVICE)
        t = time.perf_counter()
        self.batches = traffic.train_batches(self.seed, m["batches"], m["batch"], cfg["img"],
                                             cfg["nc"], m["label_pad"], m["labels_mean"],
                                             m["labels_sigma"], device=common.DEVICE)
        self.net = ref.Net(cfg["cfg_training"])
        sd = ref_train.init_training(self.net, self.seed, dev)
        self.sd = {k: v.cpu() for k, v in sd.items()}
        del sd
        self.param_keys = [k for k, v in self.sd.items() if ref_train.is_param(k, v)]
        self.stat_keys = [k for k in self.sd if k.endswith(ref_train.STATS)]
        if common.DEVICE == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self.phases = {"batches and weights": time.perf_counter() - t}
        if self.control:    # the reference in a lower precision, in the program's place
            self.readings = self.reference(cast=CASTS[self.control])
            self.step = None
            return
        t = time.perf_counter()
        self.plan, self.step, self.ts, (lr, mom), self.upload = port.trainer(cfg, self.sd, m["hyp"])
        self.lr, self.mom = lr, mom
        self.phases["import, step"] = time.perf_counter() - t
        t = time.perf_counter()
        losses = []
        sd0 = {k: v.numpy() for k, v in self.sd.items()}
        # (params, momentum buffer) after each of the first OPT_STEPS steps
        for i in range(CHECKED):
            losses.append(float(self._step(i)))
            if i < OPT_STEPS:
                v = port.exported(self.plan, self.ts.opt_state["v"], self.ts.state)
                self.snapshots.append((port.exported(self.plan, self.ts.params, self.ts.state), v))
            if i == 0:
                grad = _norms(v, None, self.param_keys)
                bn1 = _norms(v, sd0, self.stat_keys)
        p3 = port.exported(self.plan, self.ts.params, self.ts.state)
        e3 = port.exported(self.plan, self.ts.ema_params, self.ts.ema_state)
        self.readings = {"loss": losses, "grad": grad, "bn1": bn1,
                         "step": _norms(p3, sd0, self.param_keys),
                         "bn": _norms(p3, sd0, self.stat_keys),
                         "ema": _norms(e3, sd0, self.param_keys + self.stat_keys)}
        self.phases["checked steps"] = time.perf_counter() - t
        t = time.perf_counter()
        for i in range(CHECKED, CHECKED + m["warmup_steps"]):
            self._step(i)
        self.next = CHECKED + m["warmup_steps"]
        self.phases["warm-up"] = time.perf_counter() - t

    def _step(self, i):
        """One step of the window's own call and feed on batch i."""
        images, labels, mask = self.batches[i % len(self.batches)]
        lr, mom = self.lr, self.mom
        if self.fault == "half":    # half of the batch left out
            h = len(images) // 2
            images, labels, mask = images[:h], labels[:h], mask[:h]
        elif self.fault == "lr":    # the learning rate 1.5 times too large
            lr = lr * 1.5
        elif self.fault == "momentum":  # no momentum: no carry, no Nesterov term
            mom = mom * 0
        with self.spans("upload"):
            ims, lbs, mks = (self.upload([a]) for a in (images, labels, mask))
        with self.spans("train_step"):
            new, metrics = self.step(self.ts, ims, lbs, mks, lr, mom)
        if self.fault != "stale":   # stale: the step's state is thrown away
            self.ts = new
        return metrics["total"]

    # -- the window ----------------------------------------------------------
    def window(self, seconds: float, profile=None):
        """Steps until `seconds` have passed. Each step's completion on the
        device is timed by a CUDA event; the images trained in the window
        are the steps completed by its end, and the share of the step under
        way then, times the batch."""
        self.spans.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        b = self.mix["batch"]
        cuda = common.DEVICE == "cuda"
        start = torch.cuda.Event(enable_timing=True) if cuda else None
        done = []
        t0 = time.perf_counter()
        if cuda:
            start.record()
        end = t0 + seconds
        while True:
            now = time.perf_counter()
            if profile is not None:
                profile.tick(now - t0)
            if now >= end:
                break
            self.losses.append(self._step(self.next + len(done)))
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
            else:   # the CPU's step has finished when it returns
                ev = time.perf_counter() - t0
            done.append(ev)
        if profile is not None:
            profile.close()
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        times = [start.elapsed_time(ev) / 1e3 for ev in done] if cuda else done
        bad = int(sum(1 for x in torch.stack(self.losses).tolist() if not np.isfinite(x)))
        self.record = {"kind": "train", "window_s": seconds,
                       "images": b * completed(times, 0.0, seconds),
                       "attempted": len(done), "failed": bad, "window_start": t0,
                       "window_peak_bytes": torch.cuda.max_memory_allocated(),
                       "drained_s": t_end - t0}
        if profile is not None and profile.t1 is not None:
            a, z = profile.t0 - t0, profile.t1 - t0
            steps = completed(times, 0.0, a) + completed(times, z, seconds)
            self.record["untraced_images"] = b * steps
            self.record["untraced_s"] = seconds - (z - a)
        return t0

    def opt_gap(self, keys) -> float:
        """The program's first OPT_STEPS updates against SGD-nesterov's rule
        worked out from its own momentum buffers (the step that the
        reference's own gradients cannot pin down): step k's change
        p[k-1] - p[k] against lr (d + mu v[k]), d = v[k] - mu v[k-1]; the
        worst leaf's norm of the difference, over the larger of the rule's
        norm of that leaf and of its median leaf."""
        lr, mu = ref_train.after_warmup(self.mix["hyp"])
        prev_p = {k: v.numpy() for k, v in self.sd.items()}
        prev_v = None
        worst = 0.0
        for p, v in self.snapshots:
            gaps, norms = [], []
            for k in keys:
                vk = np.asarray(v[k], np.float64)
                d = vk if prev_v is None else vk - mu * np.asarray(prev_v[k], np.float64)
                rule = lr[ref_train.group(k, self.sd[k])] * (d + mu * vk)
                got = np.asarray(prev_p[k], np.float64) - np.asarray(p[k], np.float64)
                gaps.append(float(np.linalg.norm(got - rule)))
                norms.append(float(np.linalg.norm(rule)))
            med = float(np.median(norms))
            worst = max([worst] + [g / max(n, med, 1e-30) for g, n in zip(gaps, norms)])
            prev_p, prev_v = p, v
        return worst

    def release(self):
        self.step = self.ts = self.upload = None
        self.losses = []
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------
    def reference(self, cast=None):
        """The reference's readings over the checked steps: each step's loss,
        the first step's gradient as the optimizer takes it (its momentum
        buffer), and the change of the weights, BN statistics and EMA."""
        dev = torch.device(common.DEVICE)
        sd = {k: v.to(dev) for k, v in self.sd.items()}
        tr = ref_train.Trainer(self.net, sd, self.mix["hyp"], cast=cast)
        lr, mom = ref_train.after_warmup(self.mix["hyp"])
        losses, grad = [], None
        for i in range(CHECKED):
            images, labels, mask = (torch.from_numpy(a).to(dev)
                                    for a in self.batches[i % len(self.batches)])
            losses.append(tr.step(images, labels, mask, lr, mom))
            if i == 0:
                grad = {k: float(tr.buf[k].double().norm()) for k in self.param_keys}
                bn1 = {k: float((tr.sd[k].double() - sd[k].double()).norm())
                       for k in self.stat_keys}
        chg = lambda src, k: float((src[k].double() - sd[k].double()).norm())  # noqa: E731
        out = {"loss": losses, "grad": grad, "bn1": bn1,
               "step": {k: chg(tr.sd, k) for k in self.param_keys},
               "bn": {k: chg(tr.sd, k) for k in self.stat_keys},
               "ema": {k: chg(tr.ema, k) for k in self.param_keys + self.stat_keys}}
        del tr, sd
        return out

    def check(self) -> Dict[str, float]:
        want = self.reference()
        got = self.readings
        # leaves whose reference gradient is nought to rounding move by
        # round-off alone: left out of the change by a rule on the gradient
        med = float(np.median([want["grad"][k] for k in self.param_keys]))
        moved = [k for k in self.param_keys if want["grad"][k] >= 1e-3 * med]
        out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"])),
               "grad_gap": worst_leaf(got["grad"], want["grad"], moved),
               "step_gap": worst_leaf(got["step"], want["step"], moved),
               "bn_gap": worst_leaf(got["bn"], want["bn"], self.stat_keys),
               "ema_gap": worst_leaf(got["ema"], want["ema"], moved + self.stat_keys),
               "left_out": len(self.param_keys) - len(moved)}
        # readings beside them: step by step, and the median leaf
        for i, (a, b) in enumerate(zip(got["loss"], want["loss"])):
            out[f"loss{i + 1}_gap"] = abs(a - b) / abs(b)
        out["bn1_gap"] = worst_leaf(got["bn1"], want["bn1"], self.stat_keys)
        for fam, keys in (("grad", moved), ("step", moved), ("ema", moved),
                          ("bn1", self.stat_keys), ("bn", self.stat_keys)):
            rel = [abs(got[fam][k] - want[fam][k]) / max(want[fam][k], 1e-30) for k in keys]
            out[f"{fam}_median_leaf"] = float(np.median(rel))
        out["opt_gap"] = self.opt_gap(moved)
        return out

    def notes(self):
        return [f"train: {self.record['attempted']} steps dispatched, the last done "
                f"{self.record['drained_s']:.3f} s after the window's start",
                "set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in self.phases.items())]
