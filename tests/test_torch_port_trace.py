"""The port's tracer (`obs/trace`) on the CPU, on a width-0.25 yolov7 at
64 px: the spans of `ServingEngine.infer_async`, the train step and
`DynamicBatcher` in a profiler's Chrome trace and in `snapshot()`, nothing
recorded and nothing changed with the tracer off, the store's bound, and
the serving load tool's `--spans` keys."""

import json
import socket
import sys
import threading
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests._torch_port_util import PORT_DEPLOY_CFG, PORT_TRAINING_CFG, deploy_cfg
from yolo_series_tpu_torch.infer.serving import DynamicBatcher, ServingEngine
from yolo_series_tpu_torch.losses import LossHyp, make_compute_loss_ota
from yolo_series_tpu_torch.models.graph import compile_graph
from yolo_series_tpu_torch.models.model import init_model
from yolo_series_tpu_torch.models.model import tree_leaves as leaves
from yolo_series_tpu_torch.models.reparam import fuse_model
from yolo_series_tpu_torch.obs import trace
from yolo_series_tpu_torch.train.optim import OptimConfig
from yolo_series_tpu_torch.train.step import init_train_state, make_train_step

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import torch_bench_serving  # noqa: E402  tools/torch_bench_serving.py

torch.set_num_threads(2)

SIZE, M = 64, 8
PHASES = ("train.forward", "train.loss", "train.backward", "train.optim", "train.ema")
TRACED = ("engine.fetches", "engine.fetches_drained", "train.steps", "train.eager.cpu",
          "batcher.requests", "batcher.batches", "batcher.bs1")


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


@pytest.fixture(scope="module")
def deploy():
    plan = compile_graph(deploy_cfg(0.25, PORT_DEPLOY_CFG))
    return (plan, *fuse_model(plan, *init_model(plan, torch.Generator().manual_seed(0))))


def _engine(deploy, batch):
    return ServingEngine(*deploy, batch_size=batch, img_size=SIZE, max_det=20,
                         conf_thres=1e-5, dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def engine(deploy):
    return _engine(deploy, 2)


@pytest.fixture(scope="module")
def trainer():
    """(plan, OTA loss, TrainState, a batch) of yolov7's training form."""
    plan = compile_graph(deploy_cfg(0.25, PORT_TRAINING_CFG))
    params, state = init_model(plan, torch.Generator().manual_seed(1))
    ts = init_train_state(params, state, OptimConfig(), device="cpu")
    rng = np.random.default_rng(2)
    images = rng.uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    labels = np.zeros((2, M, 5), np.float32)
    mask = np.zeros((2, M), bool)
    for i in range(2):
        labels[i, :4] = np.concatenate([rng.integers(0, 80, (4, 1)), rng.uniform(0.2, 0.8, (4, 2)),
                                        rng.uniform(0.1, 0.4, (4, 2))], 1)
        mask[i, :4] = True
    return plan, make_compute_loss_ota(plan.head, LossHyp()), ts, (images, labels, mask)


def _frames(n, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (n, SIZE, SIZE, 3), np.uint8)


def _steps(trainer, n, mesh=None):
    plan, loss_fn, ts, batch = trainer
    step = make_train_step(plan, loss_fn, OptimConfig(), mesh=mesh, compute_dtype=torch.float32)
    lr, mom = np.float32([0.01, 0.01, 0.05]), np.float32(0.9)
    for _ in range(n):
        ts, _ = step(ts, *batch, lr, mom)
    return ts


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(path, engine, trainer):
    """Drive one path; returns the names of (child, parent) pairs to find
    nested, and the steps or calls made."""
    if path == "engine":
        for _ in range(2):
            engine.to_host(engine.infer_async(_frames(2))[0])
        return [("engine.stage", "engine.infer_async"), ("engine.infer_async", "outer"),
                ("engine.fetch", "outer")], 2
    if path == "train":
        _steps(trainer, 2)
        return [(p, "train.step") for p in PHASES] + [("train.step", "outer")], 2
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        _steps(trainer, 1, mesh=dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    return [(p, "train.step") for p in PHASES + ("train.allreduce",)], 1


def _read(metric, kind):
    """The benchmark's reader of `metric` on a run of `kind`."""
    from benchmark.harness import common
    return common.reader(metric)({"kind": kind})


def _chrome(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    evs = json.loads(path.read_text())
    evs = evs["traceEvents"] if isinstance(evs, dict) else evs
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
            for e in evs if e.get("ph") == "X"]


@pytest.mark.parametrize("path", ["engine", "train", "train_mesh"])
def test_spans_nest_in_the_profilers_trace_and_add_up(path, engine, trainer, tmp_path):
    """Under a profiler started and stopped as the benchmark does, every
    span is a record_function event nested in its parent and inside the
    outer annotation, on the trace's one clock; `snapshot()` then holds one
    duration a phase a step, and each step's phases and self time sum to
    its duration."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        with torch.profiler.record_function("outer"):
            pairs, n = _run(path, engine, trainer)
    finally:
        prof.stop()
    assert not trace.on()
    evs = _chrome(prof, tmp_path)
    (outer,) = [e for e in evs if e[0] == "outer"]
    for child, parent in pairs:
        kids = [e for e in evs if e[0] == child]
        holders = [e for e in evs if e[0] == parent]
        assert len(kids) == n, (child, len(kids))
        for _, a, b in kids:
            assert outer[1] <= a <= b <= outer[2]
            assert any(p[1] <= a and b <= p[2] for p in holders), (child, parent)
    snap = trace.snapshot()
    if path == "engine":
        c = snap["counters"]
        assert len(snap["spans"]["engine.stage"]) == len(snap["spans"]["engine.fetch"]) == 2
        assert c["engine.fetches"] == c["engine.fetches_drained"] == 2
        # the live engines' own counts, registered with `watch`
        assert c["engine.batches"] >= engine.batches >= 2
        assert c["engine.replays"] == 0 and c["launches.conv_silu.launch"] == 0
        assert _read("stage_ms.serve", "batch") == pytest.approx(
            1e3 * np.mean(snap["spans"]["engine.stage"]), rel=1e-9)
        assert _read("fetch_ms.serve", "batch") > 0
        assert _read("fetch_drain_share.serve", "batch") == 100
        assert _read("stage_ms.serve", "train") is None
        assert _read("fwd_host_ms.train", "batch") is None
        return
    phases = [c for c, p in pairs if p == "train.step"]
    assert all(len(snap["spans"][p]) == n for p in phases)
    assert snap["counters"]["train.steps"] == n
    steps = trace.records("train.step")
    assert [r.ident for r in steps] == list(range(1, n + 1))
    for k, r in enumerate(steps):
        inside = sum(snap["spans"][p][k] for p in phases)
        assert inside + r.self_s == pytest.approx(r.end - r.start, rel=1e-9)
        assert r.self_s >= 0 and all(x.parent == r.sid for p in phases
                                     for x in trace.records(p)[k:k + 1])
    if path == "train":
        # the benchmark's readers: the five phases a step and its own time
        # make up the step's mean
        split = [_read(f"{m}_host_ms.train", "train")
                 for m in ("fwd", "ota", "bwd", "optim", "ema")]
        own = _read("step_self_ms.train", "train")
        mean = 1e3 * np.mean(snap["spans"]["train.step"])
        assert min(split) > 0 and sum(split) + own == pytest.approx(mean, rel=1e-9)


def test_cpu_steps_run_eagerly_and_count_why(trainer):
    """On the CPU every step runs eagerly, counted once as
    `train.eager.cpu`: no capture and no replay, so the benchmark's replay
    share reads 0."""
    trace.enable(True)
    _steps(trainer, 2)
    c = trace.snapshot()["counters"]
    assert c["train.steps"] == c["train.eager.cpu"] == 2
    assert not {k for k in c if k.startswith("train.") and k not in
                ("train.steps", "train.eager.cpu")}
    assert _read("train_replay_share.train", "train") == 0


def test_an_eager_call_out_of_memory_drops_the_live_graph_and_runs_again(monkeypatch):
    """`train/step._eager`: an eager step's call that runs out of the card's
    memory while a captured step's graph is alive drops that graph and
    runs again; with no graph alive the error stands."""
    from yolo_series_tpu_torch.train import step as S

    class Holder:
        graph = "a graph"

        def evict(self):
            self.graph = None

    holder = Holder()
    monkeypatch.setattr(S, "_alive", weakref.ref(holder))
    seen = []

    def run():
        seen.append(holder.graph)
        if len(seen) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return "done"

    assert S._eager(run) == "done"
    assert seen == ["a graph", None]
    seen.clear()
    with pytest.raises(torch.cuda.OutOfMemoryError):
        S._eager(run)
    assert seen == [None]


def test_replay_share_reader(monkeypatch):
    """`train_replay_share.train` on a snapshot's counters: None on a run of
    another kind, and for a program that counts steps but no replay,
    capture or eager step (one without the step's graph); 100 for a
    window of replays, 50 for half."""
    counters = {}
    monkeypatch.setattr(trace, "snapshot",
                        lambda: {"spans": {}, "self": {}, "counters": dict(counters)})
    assert _read("train_replay_share.train", "train") is None
    counters["train.steps"] = 7
    assert _read("train_replay_share.train", "train") is None
    counters["train.replays"] = 7
    assert _read("train_replay_share.train", "train") == 100
    assert _read("train_replay_share.train", "batch") is None
    counters.update({"train.steps": 4, "train.replays": 2, "train.captures": 1,
                     "train.eager.new": 1})
    assert _read("train_replay_share.train", "train") == 50


def test_off_records_nothing_and_changes_nothing(engine, trainer, monkeypatch):
    """With no profiler and the tracer off, no span, counter or
    record_function; the detections and the new train state are bitwise
    those of a run with the tracer on."""
    x = _frames(2, seed=5)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        det_on, ts_on = engine.infer(x), _steps(trainer, 1)
    finally:
        prof.stop()
    assert trace.snapshot()["spans"]
    trace.reset()

    def refuse(*a, **k):
        raise AssertionError("record_function entered with the tracer off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    det_off, ts_off = engine.infer(x), _steps(trainer, 1)
    snap = trace.snapshot()
    assert snap["spans"] == {} and snap["self"] == {}
    assert not set(TRACED) & set(snap["counters"])
    assert int(det_on["num_dets"].sum()) > 0
    for k in det_on:
        np.testing.assert_array_equal(det_on[k], det_off[k])
    a, b = leaves(ts_on._asdict()), leaves(ts_off._asdict())
    assert len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))


def test_batcher_spans_tie_requests_to_batches(engine):
    trace.enable(True)
    batcher = DynamicBatcher(engine, max_delay_ms=5)
    slots = [batcher.submit(f) for f in _frames(5)]
    for s in slots:
        assert DynamicBatcher.wait(s, timeout=60) is not None
    batcher.close()
    trace.enable(False)
    collect = {r.sid: r.ident for r in trace.records("batcher.collect")}
    dispatch = {r.sid for r in trace.records("batcher.dispatch")}
    complete = {r.sid for r in trace.records("batcher.complete")}
    queue = trace.records("batcher.queue")
    assert len(queue) == 5 and len({r.ident for r in queue}) == 5
    assert all(r.parent in collect and r.end >= r.start for r in queue)
    assert {r.parent for r in trace.records("batcher.complete")} <= dispatch
    assert {r.parent for r in trace.records("engine.fetch")} <= complete
    assert {r.parent for r in trace.records("engine.infer_async")} <= dispatch
    c = trace.snapshot()["counters"]
    assert c["batcher.requests"] == 5 and c["batcher.batches"] == len(collect) >= 3
    assert "batcher.bs1" not in c


def test_store_bound_counts_and_threads(monkeypatch):
    """The newest MAX_RECORDS spans a name are kept; counters count only
    while on and lose no update across threads; each thread nests its own
    spans."""
    monkeypatch.setattr(trace, "MAX_RECORDS", 3)
    trace.count("x")
    trace.enable(True)
    for i in range(10):
        with trace.span("bounded", ident=i):
            pass
    assert [r.ident for r in trace.records("bounded")] == [7, 8, 9]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for _ in range(500):
                with trace.span("outer", ident=i) as o:
                    with trace.span("inner", ident=i) as s:
                        assert s.parent == o.sid
                    trace.count("x")
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert trace.snapshot()["counters"]["x"] == 8 * 500

    class Holder:
        n = 3

    held = Holder()
    trace.watch("held", held, "n")
    trace.watch("held", Holder(), "n")   # gone at once: no longer read
    assert trace.snapshot()["counters"]["held"] == 3


def test_load_tool_reports_the_batchers_spans(deploy, engine):
    out = torch_bench_serving.bench(engine, _engine(deploy, 1), clients=4, seconds=0.5,
                                    spans=True)
    s = out["dynamic_batching_on"]["spans"]
    assert set(s) == {"queue_p50_ms", "queue_p99_ms", "batch_fill", "bs1_share", "stage_ms",
                      "fetch_ms"}
    assert 0 <= s["queue_p50_ms"] <= s["queue_p99_ms"] and 0 < s["batch_fill"] <= 1
    assert s["bs1_share"] == 0     # the tool's batcher has no batch-1 engine
    assert s["stage_ms"] > 0 and s["fetch_ms"] > 0
    assert "spans" not in out["dynamic_batching_off"] and not trace.on()
