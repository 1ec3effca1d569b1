"""Batched serving engine (counterpart of `yolo_series_tpu/infer/serving.py`:
`ServingEngine`, `DynamicBatcher`).

ServingEngine: fixed batch and size, uint8 NHWC frames in, normalize in
the working dtype, the re-parameterized deploy graph (fp, or int8 from
`infer/quant.quantize_model`) with the three serving transforms always
applied (fused stem, fast stem, fused ELAN spans) where they match, then
`ops/nms.fused_head_nms`. The response contract is the
Triton client's (deploy/triton-inference-server/client.py:15-16):
num_dets (B, 1), det_boxes (B, max_det, 4), det_scores (B, max_det),
det_classes (B, max_det). The engine runs eagerly on its device.

DynamicBatcher: the queue micro-batcher with pipelined dispatch and
completion threads and the in-flight-aware bs1 low-latency path, ported
as it is (pure host code).

Device letterbox ingest (`ingest_hw`), `split_concat` and CUDA-graph
capture are ROADMAP queue 1, item 5.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from yolo_series_tpu_torch.device import device as _device
from yolo_series_tpu_torch.models.faststem import make_fast_stem
from yolo_series_tpu_torch.models.model import apply_model, tree_map
from yolo_series_tpu_torch.ops.fused_elan import make_fused_elan
from yolo_series_tpu_torch.ops.fused_stem import make_fused_stem
from yolo_series_tpu_torch.ops.nms import fused_head_nms


class ServingEngine:
    """Fixed-shape end-to-end detector on one device."""

    def __init__(self, plan, params, state, *, batch_size=8, img_size=640,
                 conf_thres=0.25, iou_thres=0.45, max_det=100,
                 dtype=torch.bfloat16, max_nms=1024, pack_output=False,
                 device=None):
        """plan/params/state: the fused deploy model (`reparam.fuse_model`),
        or its int8 form (`infer/quant.quantize_model`); the transforms
        then match the convs that stayed fp. device: the card unless "cpu"
        is asked for."""
        self.device = _device(device)
        plan, params, state = make_fused_stem(plan, params, state)
        plan, params, state = make_fast_stem(plan, params, state, max_pairs=2)
        plan, params, state = make_fused_elan(plan, params, state)

        def place(t):  # fp32 weights take the working dtype; kernel
            # params are bf16 already and stay so
            if t.dtype == torch.float32:
                return t.to(self.device, dtype)
            return t.to(self.device)

        def place_tree(tree):  # an int8 leaf keeps sw, sx and b in fp32,
            # as the JAX package does (quant.int8_conv dequantizes in fp32)
            if isinstance(tree, dict) and "wq" in tree:
                return tree_map(lambda t: t.to(self.device), tree)
            if isinstance(tree, dict):
                return {k: place_tree(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(place_tree(v) for v in tree)
            return place(tree) if isinstance(tree, torch.Tensor) else tree

        self.plan = plan
        self._params = place_tree(params)
        self._state = tree_map(place, state)
        self.batch_size = batch_size
        self.img_size = img_size
        self.max_det = max_det
        self.pack_output = pack_output
        self._nms_kw = dict(conf_thres=conf_thres, iou_thres=iou_thres,
                            max_det=max_det, max_nms=max_nms,
                            compute_dtype=dtype)
        self._dtype = dtype
        self.batches = 0  # forward passes run, padded partial batches too

    @torch.inference_mode()
    def end2end(self, x: torch.Tensor):
        """x: (B, H, W, 3) uint8 RGB on the engine's device -> detections
        (dict of device tensors, or one packed (B, 1 + 6*max_det) fp32
        array with pack_output)."""
        self.batches += 1
        xf = x.to(self._dtype) / 255.0
        feats, _ = apply_model(self.plan, self._params, self._state, xf,
                               dtype=self._dtype, return_head_inputs=True)
        num, boxes, scores, cls = fused_head_nms(
            self.plan.head, self._params["layers"][-1], feats, **self._nms_kw)
        if self.pack_output:
            return torch.cat([num[:, None].float(), scores, cls.float(),
                              boxes.reshape(boxes.shape[0], -1)], dim=1)
        return {"num_dets": num[:, None], "det_boxes": boxes,
                "det_scores": scores, "det_classes": cls}

    def unpack(self, packed: np.ndarray) -> Dict[str, np.ndarray]:
        """Inverse of the pack_output row layout."""
        md = self.max_det
        return {"num_dets": packed[:, :1].astype(np.int32),
                "det_scores": packed[:, 1:1 + md],
                "det_classes": packed[:, 1 + md:1 + 2 * md].astype(np.int32),
                "det_boxes": packed[:, 1 + 2 * md:].reshape(len(packed), md, 4)}

    def to_host(self, out) -> Dict[str, np.ndarray]:
        """Device output of `infer_async` -> numpy dict (waits for it)."""
        if self.pack_output:
            return self.unpack(out.cpu().numpy())
        return {k: v.cpu().numpy() for k, v in out.items()}

    def infer(self, images: np.ndarray) -> Dict[str, np.ndarray]:
        """images: (n<=B, H, W, 3) uint8 RGB, already letterboxed to
        img_size. Partial batches are padded and trimmed."""
        out, n = self.infer_async(images)
        return {k: v[:n] for k, v in self.to_host(out).items()}

    def infer_async(self, images: np.ndarray):
        """Dispatch without waiting: returns (device output, n), so a
        pipeline can keep several batches in flight."""
        n = images.shape[0]
        if n > self.batch_size:
            raise ValueError(f"{n} images for batch size {self.batch_size}")
        if n < self.batch_size:
            pad = np.zeros((self.batch_size - n, *images.shape[1:]), images.dtype)
            images = np.concatenate([images, pad], 0)
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        return self.end2end(x), n

    def warmup(self, iters=3):
        x = np.zeros((self.batch_size, self.img_size, self.img_size, 3), np.uint8)
        for _ in range(iters):
            self.infer(x)


class DynamicBatcher:
    """Queue-based micro-batching front end (Triton dynamic_batching
    equivalent). Call submit(image) from any thread; the result is a
    Future-like slot.

    Pipelined like Triton's multiple in-flight executions: the batching
    thread dispatches (infer_async) and completion threads materialize
    results, so device-to-host latency overlaps the next batch's compute.
    `inflight` bounds queued executions (backpressure)."""

    def __init__(self, engine: ServingEngine, max_delay_ms: float = 5.0,
                 inflight: int = 3, stage_fn=None, completers: int = 2,
                 bs1_engine: Optional[ServingEngine] = None):
        """bs1_engine: optional batch-1 engine for the low-latency path —
        when a request arrives and the queue is otherwise empty and nothing
        is in flight, it dispatches at once on this engine instead of
        waiting max_delay_ms for co-batching. stage_fn(frames) -> batch
        array replaces the default np.stack."""
        self.engine = engine
        self.bs1_engine = bs1_engine
        if bs1_engine is not None and bs1_engine.batch_size != 1:
            raise ValueError("bs1_engine must have batch_size 1")
        self.max_delay = max_delay_ms / 1e3
        self.stage_fn = stage_fn
        self.q: queue_mod.Queue = queue_mod.Queue()
        self._done: queue_mod.Queue = queue_mod.Queue(maxsize=max(inflight, 1))
        self._stop = False
        self.worker = threading.Thread(target=self._loop, daemon=True)
        self.completer_pool = [
            threading.Thread(target=self._complete, daemon=True)
            for _ in range(max(completers, 1))]
        self.worker.start()
        for t in self.completer_pool:
            t.start()

    def submit(self, image: np.ndarray):
        ev = threading.Event()
        slot = {"image": image, "event": ev, "result": None}
        self.q.put(slot)
        return slot

    @staticmethod
    def wait(slot, timeout=None):
        slot["event"].wait(timeout)
        return slot["result"]

    def _loop(self):
        bs = self.engine.batch_size
        while not self._stop:
            try:
                first = self.q.get(timeout=0.1)
            except queue_mod.Empty:
                continue
            batch = [first]
            eng = self.engine
            if (self.bs1_engine is not None and self.q.empty()
                    and self._done.qsize() == 0):
                # low-latency path: nothing queued and nothing in flight —
                # dispatch now on the bs1 engine, skip the co-batching wait;
                # sustained load keeps co-batching
                eng = self.bs1_engine
            else:
                deadline = time.perf_counter() + self.max_delay
                while len(batch) < bs and time.perf_counter() < deadline:
                    try:
                        batch.append(self.q.get(timeout=max(
                            0.0, deadline - time.perf_counter())))
                    except queue_mod.Empty:
                        break
            frames = [b["image"] for b in batch]
            images = (self.stage_fn(frames) if self.stage_fn is not None
                      else np.stack(frames))
            out, _n = eng.infer_async(images)
            # blocks at `inflight` pending — but never past close(): a
            # plain put() could wedge forever once the completers exit
            while not self._stop:
                try:
                    self._done.put((batch, out, eng), timeout=0.1)
                    batch = None
                    break
                except queue_mod.Full:
                    continue
            if batch is not None:  # shut down mid-handoff: wake the waiters
                for b in batch:
                    b["event"].set()

    def _complete(self):
        while True:
            try:
                batch, out, eng = self._done.get(timeout=0.1)
            except queue_mod.Empty:
                if self._stop:
                    return  # drain everything dispatched before exiting
                continue
            host = eng.to_host(out)
            for i, b in enumerate(batch):
                b["result"] = {k: v[i] for k, v in host.items()}
                b["event"].set()

    def close(self):
        """Stop the pipeline. In-flight batches still complete; anything
        left undispatched is woken with result None so no wait() hangs."""
        self._stop = True
        self.worker.join(timeout=10)
        for t in self.completer_pool:
            t.join(timeout=10)
        while True:  # never-dispatched requests
            try:
                slot = self.q.get_nowait()
            except queue_mod.Empty:
                break
            slot["event"].set()
        while True:  # dispatched but stranded between queues
            try:
                batch, _, _ = self._done.get_nowait()
            except queue_mod.Empty:
                break
            for b in batch:
                b["event"].set()
