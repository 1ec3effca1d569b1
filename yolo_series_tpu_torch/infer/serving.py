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
`replays` counts the replays. On the card each call's outputs carry an
event recorded after them on the compute stream, and `to_host` waits for
that event alone and copies on a stream of its own, so the batches
dispatched after it keep the card busy while the host fetches. The
rewrites run in the span `engine.rewrite`; the engine keeps the operations
of one batch that they hand to the conv + SiLU kernel (`conv_silu_ops`),
which `obs/trace.snapshot` reads, summed over the engines built, as
`engine.conv_silu_ops`.

DynamicBatcher: the queue micro-batcher with pipelined dispatch and
completion threads and the in-flight-aware bs1 low-latency path, ported
as it is (pure host code); it captures its engines' graphs in the
caller's thread before its own threads start.

`split_concat=True` adds `models/fastconcat.make_split_concat` after the
three transforms, as the JAX engine adds it after its Pallas rewrites (off
by default there and here): each 1x1 conv that reads a concat takes the
concat's inputs instead, one partial product a tap.

ShardedServingEngine: the same interface over a ('data', 'model') grid of
devices (`parallel/mesh.make_mesh`), one process driving all of it, the
counterpart of `jax.jit(serve, in_shardings=...)` over JAX's mesh. Each
row of the grid serves a contiguous slice of the batch: with one device a
row, a full `ServingEngine` (its CUDA graph, K2, K3 and K1); with several,
a tensor-parallel row that runs the fused plan without the rewrites, as
JAX's tensor-parallel serving does: each conv weight that
`mesh.param_partition_specs` cuts computes its output channels on its own
device and the row gathers them on its first device, which runs the rest
and `fused_head_nms` (K1), eagerly (no graph spans several devices). The
rows' outputs are concatenated in row order. A `DynamicBatcher` sits in
front of either engine alike.
"""

from __future__ import annotations

import collections
import itertools
import queue as queue_mod
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from yolo_series_tpu_torch.data.device_aug import make_device_letterbox
from yolo_series_tpu_torch.device import device as _device
from yolo_series_tpu_torch.device import graph_capture
from yolo_series_tpu_torch.models.fastconcat import make_split_concat
from yolo_series_tpu_torch.models.faststem import make_fast_stem
from yolo_series_tpu_torch.models.model import apply_model, tree_map
from yolo_series_tpu_torch.obs import trace
from yolo_series_tpu_torch.ops import conv_silu
from yolo_series_tpu_torch.ops.fused_elan import FusedELAN, make_fused_elan
from yolo_series_tpu_torch.ops.fused_stem import FusedStem, make_fused_stem
from yolo_series_tpu_torch.ops.nms import fused_head_nms
from yolo_series_tpu_torch.parallel.dist import host_local_slice
from yolo_series_tpu_torch.parallel.mesh import Mesh, tensor_parallel_params


def serving_transforms(plan, params, state):
    """The three serving rewrites, where they match: fused stem (K2), fast
    stem, fused ELAN spans (K3). Exact re-arrangements of the same convs."""
    plan, params, state = make_fused_stem(plan, params, state)
    plan, params, state = make_fast_stem(plan, params, state, max_pairs=2)
    return make_fused_elan(plan, params, state)


def conv_silu_ops(plan, fused, img: int) -> int:
    """Operations of one img x img image in the convs of `plan` that the
    serving rewrites handed to the conv + SiLU kernel in `fused` (its plan
    after `serving_transforms`): a FusedStem's three convs (layers 1-3),
    each FusedELAN's n + 3, counted as the dense FLOP counter counts the
    original convs (`conv_silu.conv_ops`). A block that `plan` holds
    already rewritten (an engine's own plan, given to another engine)
    counts nothing: its convs are not in `plan`."""
    covered = []
    for idx, spec in enumerate(fused.layers):
        if isinstance(plan.layers[idx].block, (FusedStem, FusedELAN)):
            continue
        if isinstance(spec.block, FusedStem):
            covered += [idx, idx + 1, idx + 2]
        elif isinstance(spec.block, FusedELAN):
            covered += [j for j in range(idx - spec.block.n - 3, idx + 1) if j != idx - 1]
    total = 0
    for j in covered:
        spec = plan.layers[j]
        src = j - 1 if spec.frm == -1 else spec.frm
        side = img if src < 0 else round(img / plan.layers[src].stride)
        b = spec.block
        total += conv_silu.conv_ops(side, side, b.c1, b.c2, b.k, b.s)
    return total


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


def _tensors(out) -> tuple:
    """The tensors of an engine output: the packed array, or the dict's."""
    return (out,) if isinstance(out, torch.Tensor) else tuple(out.values())


class ServingEngine:
    """Fixed-shape end-to-end detector on one device."""

    rewrites = True   # the serving transforms (a tensor-parallel row runs without)
    graphs = True     # replay a CUDA graph on the card
    # `conv_silu_ops` summed over the engines this process built: read by
    # `obs/trace.snapshot` as "engine.conv_silu_ops", and kept after the
    # engines are gone
    built_conv_silu_ops = 0

    def __init__(self, plan, params, state, *, batch_size=8, img_size=640,
                 conf_thres=0.25, iou_thres=0.45, max_det=100,
                 dtype=torch.bfloat16, max_nms=1024, pack_output=False,
                 ingest_hw: Optional[tuple] = None, device=None,
                 split_concat: bool = False):
        """plan/params/state: the fused deploy model (`reparam.fuse_model`),
        or its int8 form (`infer/quant.quantize_model`); the transforms
        then match the convs that stayed fp. ingest_hw=(h, w): take raw
        (B, h, w, 3) uint8 frames, letterbox them on the device, and
        return boxes in source pixels. device: the card unless "cpu" is
        asked for. split_concat: also route each concat's inputs straight
        into its 1x1 consumers (`models/fastconcat.py`)."""
        self.device = _device(device)
        if split_concat and not self.rewrites:
            raise ValueError("split_concat rewrites the serving plan, which a "
                             "tensor-parallel row runs without its rewrites")
        self.conv_silu_ops = 0   # operations of one batch in conv_silu (K2, K3)
        if self.rewrites:
            with trace.span("engine.rewrite"):
                fused, params, state = serving_transforms(plan, params, state)
            self.conv_silu_ops = batch_size * conv_silu_ops(plan, fused, img_size)
            plan = make_split_concat(fused) if split_concat else fused
        ServingEngine.built_conv_silu_ops += self.conv_silu_ops
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
        # on the card: the events of the last calls (`_ready`), which
        # `to_host` reads to count the fetches that left the card empty,
        # and the stream it copies on (non-blocking, from PyTorch's pool)
        self._events: collections.deque = collections.deque(maxlen=8)
        self._fetch_stream = (torch.cuda.Stream(self.device)
                              if self.device.type == "cuda" else None)
        trace.watch("engine.batches", self, "batches")
        trace.watch("engine.replays", self, "replays")

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
        """Device output of `infer_async` -> numpy dict. An output that
        carries this engine's event (`_ready`) waits for that event on the
        host, then copies on the engine's fetch stream and waits for that
        stream only: the calls dispatched after it stay queued on the
        compute stream. Any other output (the CPU's, an eager `end2end`'s)
        gets `.cpu()` on the current stream, which waits for all the work
        queued there. Span `engine.fetch`; counters `engine.fetches` and
        `engine.fetches_drained`, the fetches after which none of the
        engine's last calls was still running."""
        with trace.span("engine.fetch"):
            ev = self._event_of(out)
            if ev is None:
                host = self._copy(out)
            else:
                # on the host, not `wait_event` on the fetch stream: two
                # completer threads then never queue behind each other's batch
                ev.synchronize()
                # the copy ends before this returns, so the allocator cannot
                # hand the output's memory to the compute stream under it
                with torch.cuda.stream(self._fetch_stream):
                    host = self._copy(out)
            if trace.on():
                trace.count("engine.fetches")
                if all(e.query() for e in tuple(self._events)):
                    trace.count("engine.fetches_drained")
        return host

    def _copy(self, out) -> Dict[str, np.ndarray]:
        if self.pack_output:
            return self.unpack(out.cpu().numpy())
        return {k: v.cpu().numpy() for k, v in out.items()}

    def _ready(self, out):
        """Record an event on the engine's compute stream after `out`'s
        work and tie it to each of `out`'s tensors; returns `out`."""
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self._events.append(ev)
        tied = (self, ev)
        for t in _tensors(out):
            t._serving_ready = tied
        return out

    def _event_of(self, out) -> Optional[torch.cuda.Event]:
        """The event `_ready` tied to every tensor of `out` if this engine
        tied it, else None."""
        tensors = _tensors(out)
        tied = getattr(tensors[0], "_serving_ready", None)
        if tied is None or tied[0] is not self or any(
                getattr(t, "_serving_ready", None) is not tied for t in tensors[1:]):
            return None
        return tied[1]

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
        if self._graph is not None or self.device.type != "cuda" or not self.graphs:
            return
        # the engine's card is the current device while it captures (the
        # capture stream, and the kernels' launches, are the current device's)
        with torch.cuda.device(self.device):
            static_in = torch.zeros(self.in_shape, dtype=torch.uint8, device=self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self.end2end(static_in)
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # thread_local: the batcher's completer threads may copy results
            # to the host while another engine captures. The capture runs on
            # `side`, this card's stream: torch.cuda.graph's own default
            # stream is made once, on the first card that captured
            with graph_capture(graph, side, capture_error_mode="thread_local"):
                static_out = self.end2end(static_in)
        self._graph, self._static_in, self._static_out = graph, static_in, static_out

    def infer_async(self, images):
        """Dispatch without waiting: returns (device output, n), so a
        pipeline can keep several batches in flight. On the card: copy into
        the graph's input buffer, replay, clone the outputs (the next
        replay writes over the graph's own), and tie to the outputs an
        event after them (`_ready`). images: (n<=B, ...) uint8
        numpy frames, or a full uint8 batch already staged on the engine's
        device (a load bench's `--prestaged`). Spans: `engine.infer_async`,
        and in it `engine.stage` (pad, tensor, pin), `engine.copy`,
        `engine.replay`, `engine.clone`."""
        with trace.span("engine.infer_async"):
            with trace.span("engine.stage"):
                x, n = self._stage(images)
            self.batches += 1
            if self.device.type != "cuda":
                return self.end2end(x), n
            # the kernels launch on the current device's stream, and a graph
            # replays there: make it the engine's card
            with torch.cuda.device(self.device):
                if not self.graphs:
                    return self._ready(self.end2end(x.to(self.device, non_blocking=True))), n
                self.capture()
                with trace.span("engine.copy"):
                    self._static_in.copy_(x, non_blocking=True)
                with trace.span("engine.replay"):
                    self._graph.replay()
                self.replays += 1
                with trace.span("engine.clone"):
                    out = self._static_out
                    out = (out.clone() if self.pack_output
                           else {k: v.clone() for k, v in out.items()})
                return self._ready(out), n

    def _stage(self, images):
        """(the batch as a tensor, n): numpy frames checked, padded to the
        batch and, for a graph on the card, pinned, so that their copy
        queues behind the last replay without holding up the host."""
        if isinstance(images, torch.Tensor):
            if tuple(images.shape) != self.in_shape or images.device != self.device:
                raise ValueError(f"a staged batch must be {self.in_shape} on {self.device}")
            return images, self.batch_size
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
        if self.device.type == "cuda" and self.graphs:
            x = x.pin_memory()
        return x, n

    def warmup(self, iters=3):
        x = np.zeros(self.in_shape, np.uint8)
        for _ in range(iters):
            self.infer(x)


trace.watch("engine.conv_silu_ops", ServingEngine, "built_conv_silu_ops")


class _TensorParallelEngine(ServingEngine):
    """One row of a grid with several devices on its model axis: the fused
    plan without the serving rewrites, its cut conv weights
    `mesh.ShardedWeight`s over the row, everything else on the row's first
    device, run eagerly."""

    rewrites = False
    graphs = False

    def __init__(self, plan, params, state, devices, **kw):
        super().__init__(plan, params, state, device=devices[0], **kw)
        self.devices = list(devices)
        self._params = tensor_parallel_params(self._params, self.devices)


class ShardedServingEngine:
    """`ServingEngine`'s interface over a ('data', 'model') grid (module
    docstring). batch_size is the global batch; the grid's n_data must
    divide it, as a batch sharding over 'data' must."""

    def __init__(self, plan, params, state, mesh: Mesh, *, batch_size=8, **kw):
        if batch_size % mesh.n_data:
            raise ValueError(f"a batch of {batch_size} does not split over {mesh.n_data} "
                             "rows of the grid")
        self.mesh = mesh
        self.batch_size = batch_size
        per = batch_size // mesh.n_data
        if mesh.n_model == 1:
            self.rows = [ServingEngine(plan, params, state, batch_size=per,
                                       device=mesh.devices[d, 0], **kw)
                         for d in range(mesh.n_data)]
        else:
            self.rows = [_TensorParallelEngine(plan, params, state, list(mesh.devices[d]),
                                               batch_size=per, **kw)
                         for d in range(mesh.n_data)]
        lead = self.rows[0]
        self.img_size, self.max_det = lead.img_size, lead.max_det
        self.pack_output, self.ingest_hw = lead.pack_output, lead.ingest_hw
        self.in_shape = (batch_size, *lead.in_shape[1:])

    @property
    def batches(self) -> int:
        return sum(r.batches for r in self.rows)

    @property
    def replays(self) -> int:
        return sum(r.replays for r in self.rows)

    @property
    def captured(self) -> bool:
        return all(r.captured or not r.graphs for r in self.rows)

    def capture(self):
        for r in self.rows:
            r.capture()

    def infer_async(self, images: np.ndarray):
        """images: (n<=B, H, W, 3) uint8 numpy frames. Pads to the global
        batch, dispatches each row's slice on its devices without waiting,
        and returns (the rows' device outputs, n)."""
        n = images.shape[0]
        if n > self.batch_size:
            raise ValueError(f"{n} images for batch size {self.batch_size}")
        if n < self.batch_size:
            pad = np.zeros((self.batch_size - n, *images.shape[1:]), images.dtype)
            images = np.concatenate([images, pad], 0)
        outs = [r.infer_async(images[host_local_slice(self.batch_size, d, len(self.rows))])[0]
                for d, r in enumerate(self.rows)]
        return outs, n

    def to_host(self, outs) -> Dict[str, np.ndarray]:
        """The rows' outputs of `infer_async` -> one numpy dict, rows in order."""
        host = [r.to_host(o) for r, o in zip(self.rows, outs)]
        return {k: np.concatenate([h[k] for h in host], 0) for k in host[0]}

    def infer(self, images: np.ndarray) -> Dict[str, np.ndarray]:
        out, n = self.infer_async(images)
        return {k: v[:n] for k, v in self.to_host(out).items()}

    def warmup(self, iters=3):
        for r in self.rows:
            r.warmup(iters)


class DynamicBatcher:
    """Queue-based micro-batching front end (Triton dynamic_batching
    equivalent). Call submit(image) from any thread; the result is a
    Future-like slot.

    Pipelined like Triton's multiple in-flight executions: the batching
    thread dispatches (infer_async) and completion threads materialize
    results, so device-to-host latency overlaps the next batch's compute.
    `inflight` bounds queued executions (backpressure).

    Spans while the tracer is on (`obs/trace`): `batcher.queue`, a request's
    wait from `submit` until the loop takes it (its identifier the
    request's, its parent the `batcher.collect` of the batch it joined);
    per batch, with the batch's identifier, `batcher.collect` (the
    co-batching wait), `batcher.stack`, `batcher.dispatch` (the engine's
    spans in it), `batcher.handoff` (blocked on `inflight`) and, in a
    completer thread, `batcher.complete` (parent: the dispatch). Counters
    `batcher.requests`, `batcher.batches`, `batcher.bs1`."""

    def __init__(self, engine, max_delay_ms: float = 5.0,
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
        self._ids = itertools.count()      # requests' and batches' identifiers
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
        if trace.on():
            slot["t"], slot["id"] = time.perf_counter(), next(self._ids)
        self.q.put(slot)
        return slot

    @staticmethod
    def wait(slot, timeout=None):
        slot["event"].wait(timeout)
        return slot["result"]

    @staticmethod
    def _taken(slot, collect):
        """A request leaves the queue for the batch whose collect span is
        `collect`."""
        if "t" in slot:
            trace.interval("batcher.queue", slot["t"], parent=collect.sid, ident=slot["id"])

    def _loop(self):
        bs = self.engine.batch_size
        while not self._stop:
            try:
                first = self.q.get(timeout=0.1)
            except queue_mod.Empty:
                continue
            bid = next(self._ids) if trace.on() else None
            with trace.span("batcher.collect", ident=bid) as collect:
                self._taken(first, collect)
                batch = [first]
                eng = self.engine
                if (self.bs1_engine is not None and self.q.empty()
                        and self._done.qsize() == 0):
                    # low-latency path: nothing queued and nothing in flight —
                    # dispatch now on the bs1 engine, skip the co-batching
                    # wait; sustained load keeps co-batching
                    eng = self.bs1_engine
                else:
                    deadline = time.perf_counter() + self.max_delay
                    while len(batch) < bs and time.perf_counter() < deadline:
                        try:
                            batch.append(self.q.get(timeout=max(
                                0.0, deadline - time.perf_counter())))
                        except queue_mod.Empty:
                            break
                        self._taken(batch[-1], collect)
            trace.count("batcher.batches")
            trace.count("batcher.requests", len(batch))
            if eng is self.bs1_engine:
                trace.count("batcher.bs1")
            with trace.span("batcher.stack", ident=bid):
                frames = [b["image"] for b in batch]
                images = (self.stage_fn(frames) if self.stage_fn is not None
                          else np.stack(frames))
            with trace.span("batcher.dispatch", ident=bid) as dispatch:
                out, _n = eng.infer_async(images)
            # blocks at `inflight` pending — but never past close(): a
            # plain put() could wedge forever once the completers exit
            with trace.span("batcher.handoff", ident=bid):
                while not self._stop:
                    try:
                        self._done.put((batch, out, eng, dispatch.sid, bid), timeout=0.1)
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
                batch, out, eng, dispatch, bid = self._done.get(timeout=0.1)
            except queue_mod.Empty:
                if self._stop:
                    return  # drain everything dispatched before exiting
                continue
            with trace.span("batcher.complete", parent=dispatch, ident=bid):
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
                batch = self._done.get_nowait()[0]
            except queue_mod.Empty:
                break
            for b in batch:
                b["event"].set()
