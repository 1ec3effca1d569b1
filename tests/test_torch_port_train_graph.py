"""The train step's CUDA graph (`train/step.make_train_step`) against the
eager step, on the card, the rule that decides when a call captures, and
the memory a live graph holds beside eager steps.

Every test here needs an NVIDIA GPU: it is marked `cuda` and skips without
a card. On a machine with one (and no jax), run

    python -m pytest --noconftest -m cuda tests/test_torch_port_train_graph.py -q

The models are yolov7's training form (IDetect) and yolov7-w6's (IAuxDetect,
nl 4) at width 0.25, 320 px, batch 8, with cuDNN deterministic, so that
the graph's step and the eager step agree bit for bit. The eager reference
is a step built anew for each call: a step's first call of a signature
always runs eagerly. This file imports no jax.
"""

import gc

import numpy as np
import pytest
import torch

from yolo_series_tpu_torch.losses import (LossHyp, make_compute_loss, make_compute_loss_aux_ota,
                                          make_compute_loss_ota)
from yolo_series_tpu_torch.models.model import tree_leaves as leaves
from yolo_series_tpu_torch.models.model import tree_rebuild as rebuild
from yolo_series_tpu_torch.obs import trace
from yolo_series_tpu_torch.train.optim import OptimConfig
from yolo_series_tpu_torch.train.schedules import warmup_factors
from yolo_series_tpu_torch.train import step as step_module
from yolo_series_tpu_torch.train.step import init_train_state, make_train_step

pytestmark = pytest.mark.cuda

WIDTH, IMG, BATCH, STEPS = 0.25, 320, 8, 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA graph has no CPU mode)")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    trace.enable(True)
    trace.reset()
    yield torch.device("cuda")
    # what a test leaves in the allocator would steer later tests' cuDNN
    # choices; a failed capture's tensors sit in a reference cycle (its
    # traceback) until a collection
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = deterministic
    trace.enable(False)
    trace.reset()


def _model(dev, p6=False):
    import chip_smoke
    return chip_smoke.train_model(dev, WIDTH, cfg=chip_smoke.P6_TRAIN_CFG if p6
                                  else chip_smoke.TRAIN_CFG)


def _batches(dev, n=STEPS, batch=BATCH, accumulate=1):
    """n batches of noise frames with padded labels, on the card."""
    import chip_smoke
    out = []
    for i in range(n):
        arrays = chip_smoke.train_batch(np.random.default_rng(10 + i), batch, IMG)
        if accumulate > 1:
            arrays = [a.reshape(accumulate, batch // accumulate, *a.shape[1:]) for a in arrays]
        out.append(tuple(torch.from_numpy(a).to(dev) for a in arrays))
    return out


def _factors(opt, i):
    """Step i's (lr_groups, momentum) in a 1000-step warm-up: both change
    every step, as does the EMA's decay with the step count."""
    return warmup_factors(i, 1000, 0.0, 300, opt.lr0, 0.1, 0.1, 0.8, opt.momentum)


def _tally():
    """(captures, replays, {why: eager steps}, steps) from the counters,
    checking that every step is counted once."""
    c = trace.snapshot()["counters"]
    eager = {k[len("train.eager."):]: v for k, v in c.items() if k.startswith("train.eager.")}
    cap, rep, steps = c.get("train.captures", 0), c.get("train.replays", 0), c.get("train.steps", 0)
    assert cap + rep + sum(eager.values()) == steps
    return cap, rep, eager, steps


def _same(a, b):
    """Two (TrainState, metrics) pairs hold the same numbers, bit for bit."""
    (ta, ma), (tb, mb) = a, b
    assert ta.step == tb.step
    if "t" in ta.opt_state:
        assert ta.opt_state["t"] == tb.opt_state["t"]
    la, lb = leaves(ta) + [ma[k] for k in sorted(ma)], leaves(tb) + [mb[k] for k in sorted(mb)]
    assert len(la) == len(lb)
    bad = [i for i, (x, y) in enumerate(zip(la, lb))
           if x.shape != y.shape or x.dtype != y.dtype or not torch.equal(x, y)]
    assert not bad, f"{len(bad)} of {len(la)} leaves differ, the first at {bad[0]}"


def _snap(pair):
    ts, m = pair
    return ts._replace(**{f: [t.clone() for t in leaves(getattr(ts, f))]
                          for f in ("params", "state", "ema_params", "ema_state")},
                       opt_state=[t.clone() for t in leaves(ts.opt_state)]), \
        {k: v.clone() for k, v in m.items()}


def _same_leaves(pair, snap):
    (ts, m), (ss, sm) = pair, snap
    for f in ("params", "state", "opt_state", "ema_params", "ema_state"):
        assert all(torch.equal(a, b) for a, b in zip(leaves(getattr(ts, f)), getattr(ss, f)))
    assert all(torch.equal(m[k], sm[k]) for k in m)


CASES = {
    "sgd_warmup": {},
    "adam": {"opt": OptimConfig(kind="adam", lr0=0.001)},
    "accumulate2": {"accumulate": 2},
    "freeze2": {"freeze": 2},
    "aux_nl4": {"p6": True},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_step_equals_eager_step(cuda, case):
    """Three steps from one state, lr, momentum and the EMA's decay changing
    every step: the first runs eagerly, the second captures and replays,
    the third replays; each equals the eager step from the same state,
    bit for bit (params, BN state, optimizer slots, EMA, metrics)."""
    kw = dict(CASES[case])
    p6 = kw.pop("p6", False)
    opt = kw.pop("opt", OptimConfig())
    m = _model(cuda, p6)
    loss_fn = (make_compute_loss_aux_ota if p6 else make_compute_loss_ota)(m.plan.head, LossHyp())
    build = lambda: make_train_step(m.plan, loss_fn, opt, **kw)  # noqa: E731
    step = build()
    ts = init_train_state(m.params, m.state, opt, device=cuda)
    for i, b in enumerate(_batches(cuda, accumulate=kw.get("accumulate", 1))):
        got = step(ts, *b, *_factors(opt, i))
        want = build()(ts, *b, *_factors(opt, i))
        _same(got, want)
        ts = got[0]
    cap, rep, eager, steps = _tally()
    # the graph's step: new, capture, replay; the eager references: new
    assert (cap, rep, eager, steps) == (1, 1, {"new": 1 + STEPS}, 2 * STEPS)


def test_returned_trees_are_the_callers_own(cuda):
    """What a replayed step returns, and the state it was given, are not
    written by the next two steps; two calls from one state return equal
    trees of their own."""
    m = _model(cuda)
    opt = OptimConfig()
    step = make_train_step(m.plan, make_compute_loss_ota(m.plan.head, LossHyp()), opt)
    ts = init_train_state(m.params, m.state, opt, device=cuda)
    b = _batches(cuda)
    f = _factors(opt, 0)
    out1 = step(ts, *b[0], *f)               # eager
    out2 = step(out1[0], *b[1], *f)          # capture, replay
    kept = {"ts1": _snap(out1), "out2": _snap(out2)}
    out3 = step(out2[0], *b[2], *f)          # replay
    step(out3[0], *b[0], *f)                 # replay
    _same_leaves(out1, kept["ts1"])
    _same_leaves(out2, kept["out2"])
    again = [step(out2[0], *b[2], *f) for _ in range(2)]
    _same(again[0], again[1])
    _same(again[0], out3)
    assert not set(map(id, leaves(again[0][0]))) & set(map(id, leaves(again[1][0])))
    first = leaves(again[0][0])[0]
    assert first.untyped_storage().data_ptr() != leaves(again[1][0])[0].untyped_storage().data_ptr()
    assert _tally()[:3] == (1, 4, {"new": 1})


@pytest.mark.parametrize("loss", ["ota", "aux_ota", "plain"])
def test_steps_make_no_synchronizing_call(cuda, loss):
    """Under `set_sync_debug_mode("error")` the eager step, its capture and
    its replay raise nothing: no call of the step waits for the card."""
    m = _model(cuda, p6=loss == "aux_ota")
    make = {"ota": make_compute_loss_ota, "aux_ota": make_compute_loss_aux_ota,
            "plain": make_compute_loss}[loss]
    opt = OptimConfig()
    step = make_train_step(m.plan, make(m.plan.head, LossHyp()), opt)
    ts = init_train_state(m.params, m.state, opt, device=cuda)
    b = _batches(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(STEPS):
            ts, metrics = step(ts, *b[i], *_factors(opt, i))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert _tally() == (1, 1, {"new": 1}, STEPS)


def test_a_loss_that_syncs_leaves_its_signature_eager(cuda):
    """A loss that reads a number on the host (`float(total)`, a
    synchronizing call): the step's first call finds the sync, so every
    call runs eagerly, counted under `train.eager.sync`, and equals the
    eager step of the plain OTA loss."""
    m = _model(cuda)
    opt = OptimConfig()
    ota = make_compute_loss_ota(m.plan.head, LossHyp())

    def syncing(raw, labels, mask, group=None):
        total, items = ota(raw, labels, mask, group=group)
        float(total)
        return total, items

    step = make_train_step(m.plan, syncing, opt)
    ts = init_train_state(m.params, m.state, opt, device=cuda)
    for i, b in enumerate(_batches(cuda)):
        got = step(ts, *b, *_factors(opt, i))
        _same(got, make_train_step(m.plan, ota, opt)(ts, *b, *_factors(opt, i)))
        ts = got[0]
    assert _tally() == (0, 0, {"new": 1 + STEPS, "sync": STEPS - 1}, 2 * STEPS)


def test_a_new_batch_shape_runs_eagerly_then_captures_anew(cuda):
    """Batch 8 captures on its second call; batch 4 runs eagerly once, then
    captures in its place; batch 8's dropped graph then leaves batch 8
    eager (`train.eager.evicted`), so shapes that alternate do not capture
    again and again. Every call equals the eager step."""
    m = _model(cuda)
    opt = OptimConfig()
    loss_fn = make_compute_loss_ota(m.plan.head, LossHyp())
    step = make_train_step(m.plan, loss_fn, opt)
    ts = init_train_state(m.params, m.state, opt, device=cuda)
    b8, b4 = _batches(cuda, 1)[0], _batches(cuda, 1, batch=4)[0]
    f = _factors(opt, 0)
    seen = []
    for b in (b8, b8, b4, b4, b4, b8):
        got = step(ts, *b, *f)
        cap, rep, eager, _ = _tally()
        seen.append((cap, rep, eager.get("new", 0), eager.get("evicted", 0)))
        _same(got, make_train_step(m.plan, loss_fn, opt)(ts, *b, *f))
        ts = got[0]
    # after each call of the step (before its reference): captures,
    # replays, eager "new" (the references' included), eager "evicted"
    assert seen == [(0, 0, 1, 0), (1, 0, 2, 0), (1, 0, 4, 0), (2, 0, 5, 0), (2, 1, 6, 0),
                    (2, 1, 7, 1)]


def test_a_capture_that_fails_runs_eagerly(cuda):
    """A loss that asks its stream whether it is done (no sync, but not
    allowed while the stream is captured): the capture raises, the step
    runs eagerly from then on (`train.eager.capture`), equals the eager
    step, and leaves the caller's stream current and the allocator as it
    was: the failed capture's pool given back, and an emptied cache holds
    no free segment."""
    m = _model(cuda)
    opt = OptimConfig()
    ota = make_compute_loss_ota(m.plan.head, LossHyp())

    def querying(raw, labels, mask, group=None):
        torch.cuda.current_stream().query()
        return ota(raw, labels, mask, group=group)

    step = make_train_step(m.plan, querying, opt)
    ts = init_train_state(m.params, m.state, opt, device=cuda)
    stream = torch.cuda.current_stream()
    pools = {tuple(g["segment_pool_id"]) for g in torch.cuda.memory._snapshot()["segments"]}
    for i, b in enumerate(_batches(cuda)):
        got = step(ts, *b, *_factors(opt, i))
        assert torch.cuda.current_stream() == stream
        _same(got, make_train_step(m.plan, ota, opt)(ts, *b, *_factors(opt, i)))
        ts = got[0]
    assert _tally() == (0, 0, {"new": 1 + STEPS, "capture": STEPS - 1}, 2 * STEPS)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    segments = torch.cuda.memory._snapshot()["segments"]
    assert {tuple(g["segment_pool_id"]) for g in segments} <= pools | {(0, 0)}
    assert not [g for g in segments if tuple(g["segment_pool_id"]) == (0, 0)
                and g["allocated_size"] == 0]


def _fresh():
    """What the allocator reserves with its cache emptied; the peak reset."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_reserved()


def _peak(fn, base):
    """The most the allocator reserved while fn ran, over base."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_reserved() - base


def _host(pair):
    """A (TrainState, metrics) pair with its tensors copied to the host, so
    that keeping it pins no block of the card's memory."""
    ts, m = pair
    cpu = lambda tree: rebuild(tree, [t.cpu() for t in leaves(tree)])  # noqa: E731
    return ts._replace(**{f: cpu(getattr(ts, f)) for f in ts._fields if f != "step"}), \
        {k: v.cpu() for k, v in m.items()}


def _steps(dev, shapes):
    """(new(key) -> a step, ts, {key: batch}, the numbers, {key: the eager
    step's output on the host}) for yolov7 steps of `shapes` {key:
    (accumulate, images)}, one state; the eager calls also set up what a
    first call sets up."""
    # blocks that earlier tests left cached would take the state's tensors
    # below, and an emptied cache cannot release a segment that holds one
    _fresh()
    m = _model(dev)
    opt = OptimConfig()
    loss_fn = make_compute_loss_ota(m.plan.head, LossHyp())
    new = lambda key: make_train_step(m.plan, loss_fn, opt,  # noqa: E731
                                      accumulate=shapes[key][0])
    ts = init_train_state(m.params, m.state, opt, device=dev)
    b = {k: _batches(dev, 1, batch=n, accumulate=acc)[0] for k, (acc, n) in shapes.items()}
    f = _factors(opt, 0)
    return new, ts, b, f, {k: _host(new(k)(ts, *b[k], *f)) for k in shapes}


def _in_child(fn):
    """fn() in a new process on the card, as the `cuda` fixture sets it up:
    the allocator's reserved memory is read there without what earlier
    tests left cached, pinned by long-lived tensors, or capped."""
    import concurrent.futures
    import multiprocessing
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        pool.submit(fn).result()


def _child_cuda():
    torch.backends.cudnn.deterministic = True
    trace.enable(True)
    trace.reset()
    return torch.device("cuda")


def test_a_live_graph_beside_eager_steps_holds_one_pool_and_one_eager_peak(cuda):
    """The accumulate-1 step captured, the accumulate-2 step runs eagerly
    beside its graph, captures (dropping the other's), the accumulate-1
    step runs eagerly beside that, the accumulate-2 step replays: all the
    while the allocator reserves no more than one graph's pool and one
    eager step's peak (the capture's warm-up leaves no cache behind), and
    every call equals the eager step. In a process of its own."""
    _in_child(_live_graph_beside_eager_steps)


def _live_graph_beside_eager_steps():
    cuda = _child_cuda()
    # accumulate 1 and 2 over micro-batches of 8, as a trainer's warm-up ramp builds them
    new, ts, b, f, want = _steps(cuda, {1: (1, BATCH), 2: (2, 2 * BATCH)})
    base = _fresh()
    eager = {acc: _peak(lambda: new(acc)(ts, *b[acc], *f), base) for acc in b}
    one, two = new(1), new(2)
    one(ts, *b[1], *f)                      # eager
    _same(_host(one(ts, *b[1], *f)), want[1])      # capture, replay
    pool = {1: _fresh() - base}             # the graph's pool and its static inputs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for step, acc in ((two, 2), (two, 2), (one, 1), (two, 2)):
        _same(_host(step(ts, *b[acc], *f)), want[acc])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_reserved() - base
    pool[2] = _fresh() - base
    assert _tally()[:3] == (2, 1, {"new": 6, "evicted": 1}), _tally()
    bound = max(pool.values()) + max(eager.values())
    assert peak <= bound + max(eager.values()) // 10, (peak, pool, eager)


def test_an_eager_step_that_does_not_fit_beside_a_graph_drops_it(cuda):
    """A step at batch 16 captured, the card's memory capped at its graph's
    pool and half of what a step at batch 8 takes: the batch-8 step's
    eager call runs out of memory beside the graph, so the graph is
    dropped and the call runs again, equal to the eager step; the batch-16
    step then runs eagerly (`train.eager.evicted`). In a process of its
    own, which the cap does not outlive."""
    _in_child(_eager_step_that_does_not_fit)


def _eager_step_that_does_not_fit():
    cuda = _child_cuda()
    new, ts, b, f, want = _steps(cuda, {"small": (1, BATCH), "big": (1, 2 * BATCH)})
    base = _fresh()
    at = torch.cuda.memory_allocated()
    alone = _peak(lambda: new("small")(ts, *b["small"], *f), base)
    needs = torch.cuda.max_memory_allocated() - at      # what its tensors take at most
    small, big = new("small"), new("big")
    big(ts, *b["big"], *f)
    big(ts, *b["big"], *f)                  # captured
    pool = _fresh() - base                  # its pool and static inputs
    # the cap leaves the small step room alone, and none beside the graph
    assert pool + needs // 2 >= alone, (pool, needs, alone)
    cap = base + pool + needs // 2
    total = torch.cuda.get_device_properties(cuda).total_memory
    torch.cuda.set_per_process_memory_fraction(cap / total)
    try:
        _same(_host(small(ts, *b["small"], *f)), want["small"])
        assert step_module._live() is None, (pool, needs, alone)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        torch.cuda.empty_cache()
    _same(_host(big(ts, *b["big"], *f)), want["big"])
    captures, replays, why, _ = _tally()
    assert (captures, replays, why.get("evicted")) == (1, 0, 1), _tally()
