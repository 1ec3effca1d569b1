"""Batched serving engine (counterpart of `yolo_series_tpu/infer/serving.py`:
`ServingEngine`, `DynamicBatcher`).

ServingEngine: fixed batch and size, uint8 NHWC frames in (raw camera
frames of one fixed shape with `ingest_hw`, letterboxed on the device by
`data/device_aug.make_device_letterbox`), normalize in the working dtype,
the re-parameterized deploy graph (fp, or int8 from
`infer/quant.quantize_model`) with the three serving transforms always
applied (fused stem, fast stem, fused ELAN spans) where they match, then
`ops/nms.fused_head_nms`, and with `ingest_hw` the boxes scaled back to
source pixels. The response contract is the Triton client's
(deploy/triton-inference-server/client.py:15-16): num_dets (B, 1),
det_boxes (B, max_det, 4), det_scores (B, max_det), det_classes
(B, max_det).

The JAX engine is one AOT-compiled program; its counterpart here is a CUDA
graph. On the card the first `infer_async` (or `capture()`) runs `end2end`
eagerly once, so that every one-time host setup (the kernels' nvcc build
and their attribute and tensor-map setup) happens outside the capture,
then captures one `end2end` on a static uint8 input buffer; every call
after that copies the frames into the buffer, replays the graph and
clones the outputs. A capture that fails raises: there is no eager
fallback on the card. On the CPU the engine runs `end2end` eagerly. The
kernels' launch counters grow at eager calls and at the capture only;
`replays` counts the replays.

DynamicBatcher: the queue micro-batcher with pipelined dispatch and
completion threads and the in-flight-aware bs1 low-latency path, ported
as it is (pure host code); it captures its engines' graphs in the
caller's thread before its own threads start. `split_concat` is ROADMAP
queue 1, item 20.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from yolo_series_tpu_torch.data.device_aug import make_device_letterbox
from yolo_series_tpu_torch.device import device as _device
from yolo_series_tpu_torch.models.faststem import make_fast_stem
from yolo_series_tpu_torch.models.model import apply_model, tree_map
from yolo_series_tpu_torch.ops.fused_elan import make_fused_elan
from yolo_series_tpu_torch.ops.fused_stem import make_fused_stem
from yolo_series_tpu_torch.ops.nms import fused_head_nms


def serving_transforms(plan, params, state):
    """The three serving rewrites, where they match: fused stem (K2), fast
    stem, fused ELAN spans (K3). Exact re-arrangements of the same convs."""
    plan, params, state = make_fused_stem(plan, params, state)
    plan, params, state = make_fast_stem(plan, params, state, max_pairs=2)
    return make_fused_elan(plan, params, state)


def place(params, state, device, dtype):
    """(params, state) on `device`, fp32 leaves in the working dtype; the
    kernels' params are bf16 already and stay so, and an int8 leaf keeps
    sw, sx and b in fp32, as the JAX package does (quant.int8_conv
    dequantizes in fp32)."""
    def leaf(t):
        return t.to(device, dtype) if t.dtype == torch.float32 else t.to(device)

    def tree(t):
        if isinstance(t, dict) and "wq" in t:
            return tree_map(lambda v: v.to(device), t)
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(tree(v) for v in t)
        return leaf(t) if isinstance(t, torch.Tensor) else t

    return tree(params), tree_map(leaf, state)


class ServingEngine:
    """Fixed-shape end-to-end detector on one device."""

    def __init__(self, plan, params, state, *, batch_size=8, img_size=640,
                 conf_thres=0.25, iou_thres=0.45, max_det=100,
                 dtype=torch.bfloat16, max_nms=1024, pack_output=False,
                 ingest_hw: Optional[tuple] = None, device=None):
        """plan/params/state: the fused deploy model (`reparam.fuse_model`),
        or its int8 form (`infer/quant.quantize_model`); the transforms
        then match the convs that stayed fp. ingest_hw=(h, w): take raw
        (B, h, w, 3) uint8 frames, letterbox them on the device, and
        return boxes in source pixels. device: the card unless "cpu" is
        asked for."""
        self.device = _device(device)
        plan, params, state = serving_transforms(plan, params, state)
        self.plan = plan
        self._params, self._state = place(params, state, self.device, dtype)
        self.batch_size = batch_size
        self.img_size = img_size
        self.max_det = max_det
        self.pack_output = pack_output
        self._nms_kw = dict(conf_thres=conf_thres, iou_thres=iou_thres,
                            max_det=max_det, max_nms=max_nms,
                            compute_dtype=dtype)
        self._dtype = dtype
        # pixel anchors on the device: no host copy inside the capture
        self._anchors = torch.as_tensor(plan.head.anchors_grid(),
                                        dtype=torch.float32, device=self.device)
        self.ingest_hw = None if ingest_hw is None else tuple(ingest_hw)
        self._letterbox = None
        if self.ingest_hw is not None:
            self._letterbox, ratio, self._pad = make_device_letterbox(
                self.ingest_hw, dst=img_size)
            self._ratio = ratio[0]
        self.in_shape = (batch_size, *(self.ingest_hw or (img_size, img_size)), 3)
        self.batches = 0  # forward passes run, padded partial batches too
        self.replays = 0  # of them, CUDA-graph replays
        self._graph = self._static_in = self._static_out = None

    @torch.inference_mode()
    def end2end(self, x: torch.Tensor):
        """x: (B, H, W, 3) uint8 RGB on the engine's device (raw frames of
        `ingest_hw` with it) -> detections (dict of device tensors, or one
        packed (B, 1 + 6*max_det) fp32 array with pack_output). Eager: the
        graph is a capture of this function."""
        if self._letterbox is not None:
            x = self._letterbox(x)  # raw frames -> letterboxed, on the device
        xf = x.to(self._dtype) / 255.0
        feats, _ = apply_model(self.plan, self._params, self._state, xf,
                               dtype=self._dtype, return_head_inputs=True)
        num, boxes, scores, cls = fused_head_nms(
            self.plan.head, self._params["layers"][-1], feats, **self._nms_kw,
            anchors=self._anchors)
        if self._letterbox is not None:
            # back to source pixels (the host-side scale_coords role,
            # general.py); python scalars, so no host copy under capture
            (dw, dh), r = self._pad, self._ratio
            hs, ws = self.ingest_hw
            x1, y1, x2, y2 = ((boxes[..., i] - off) / r
                              for i, off in enumerate((dw, dh, dw, dh)))
            boxes = torch.stack([x1.clamp(0.0, ws), y1.clamp(0.0, hs),
                                 x2.clamp(0.0, ws), y2.clamp(0.0, hs)], dim=-1)
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
        """images: (n<=B, H, W, 3) uint8 RGB, letterboxed to img_size (raw
        frames of `ingest_hw` with it). Partial batches are padded and
        trimmed."""
        out, n = self.infer_async(images)
        return {k: v[:n] for k, v in self.to_host(out).items()}

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def capture(self):
        """Capture `end2end` on the card as a CUDA graph, after one eager
        call on the capture's side stream (the one-time host setup: nvcc
        builds, kernel attributes, the tensor-map encoder). A no-op once
        captured and on the CPU; a capture that fails raises."""
        if self._graph is not None or self.device.type != "cuda":
            return
        static_in = torch.zeros(self.in_shape, dtype=torch.uint8, device=self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.end2end(static_in)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: the batcher's completer threads may copy results to
        # the host while another engine captures
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            static_out = self.end2end(static_in)
        self._graph, self._static_in, self._static_out = graph, static_in, static_out

    def infer_async(self, images: np.ndarray):
        """Dispatch without waiting: returns (device output, n), so a
        pipeline can keep several batches in flight. On the card: copy into
        the graph's input buffer, replay, clone the outputs (the next
        replay writes over the graph's own)."""
        n = images.shape[0]
        if n > self.batch_size:
            raise ValueError(f"{n} images for batch size {self.batch_size}")
        if n < self.batch_size:
            pad = np.zeros((self.batch_size - n, *images.shape[1:]), images.dtype)
            images = np.concatenate([images, pad], 0)
        if tuple(images.shape) != self.in_shape:
            raise ValueError(f"frames {tuple(images.shape[1:])}: this engine takes "
                             f"{self.in_shape[1:]}")
        x = torch.from_numpy(np.ascontiguousarray(images))
        self.batches += 1
        if self.device.type != "cuda":
            return self.end2end(x), n
        self.capture()
        # from pinned memory: the copy queues behind the last replay
        # without holding up the host
        self._static_in.copy_(x.pin_memory(), non_blocking=True)
        self._graph.replay()
        self.replays += 1
        out = self._static_out
        return (out.clone() if self.pack_output
                else {k: v.clone() for k, v in out.items()}), n

    def warmup(self, iters=3):
        x = np.zeros(self.in_shape, np.uint8)
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
        for eng in (engine, bs1_engine):   # in this thread, not the worker's
            if eng is not None:
                eng.capture()
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
