"""`remat_prefix` in the port (`models/model.apply_model`,
`train/step.make_train_step`): the first k layers under
`torch.utils.checkpoint` give the same step bit for bit, as JAX's
`jax.checkpoint` prefix does (tests/test_parallel_train.py:202), also for
a prefix that ends inside a saved route, and under SyncBN on 2 gloo
ranks; the forward equals JAX's prefix forward; an observer is refused,
as JAX asserts. yolov7-tiny training, fp32, 64 px, batch 2, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_util import assert_trees_close, port_drawn_model, zoo_cfg
from yolo_series_tpu.models.model import apply_model as japply
from yolo_series_tpu_torch.losses import LossHyp, make_compute_loss
from yolo_series_tpu_torch.models.model import apply_model
from yolo_series_tpu_torch.models.model import tree_leaves as leaves
from yolo_series_tpu_torch.train.optim import OptimConfig
from yolo_series_tpu_torch.train.step import init_train_state, make_train_step

torch.set_num_threads(2)

SIZE = 64


@pytest.fixture(scope="module")
def tiny():
    jplan, params, state, tplan, tp, ts = port_drawn_model(
        zoo_cfg("yolov7-tiny", "training", 1.0), seed=7, stats_seed=8)
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    labels = np.zeros((2, 8, 5), np.float32)
    labels[:, :2, 0] = rng.integers(0, 80, (2, 2))
    labels[:, :2, 1:3] = rng.uniform(0.3, 0.7, (2, 2, 2))
    labels[:, :2, 3:5] = rng.uniform(0.1, 0.3, (2, 2, 2))
    mask = np.zeros((2, 8), bool)
    mask[:, :2] = True
    return jplan, params, state, tplan, tp, ts, (x, labels, mask)


def _route_prefix(plan):
    """The shortest prefix past layer 1 that ends inside a saved route: a
    layer before its last one is saved and read by a layer after it."""
    for k in range(2, len(plan.layers)):
        for j in range(k, len(plan.layers)):
            frm = plan.layers[j].frm
            refs = frm if isinstance(frm, tuple) else (frm,)
            if any(0 <= r < k - 1 and r in plan.save for r in refs):
                return k
    raise AssertionError("no saved route crosses a prefix")


@pytest.mark.parametrize("kind", ["four", "route"])
def test_remat_step_is_bit_identical(tiny, kind):
    """One SGD step with remat_prefix k and with 0: the loss, every param,
    the BN state, the optimizer state and the EMA are equal bit for bit
    (the recompute runs the same operations on the same values)."""
    *_, tplan, tp, ts, (x, labels, mask) = tiny
    k = 4 if kind == "four" else _route_prefix(tplan)
    if kind == "route":
        assert any(i < k - 1 for i in tplan.save)
    loss_fn = make_compute_loss(tplan.head, LossHyp())
    cfg = OptimConfig()
    lr, mom = np.array([0.01, 0.01, 0.05], np.float32), 0.9
    outs = {}
    for rp in (0, k):
        ts0 = init_train_state(tp, ts, cfg, device="cpu")
        step = make_train_step(tplan, loss_fn, cfg, compute_dtype=torch.float32,
                               remat_prefix=rp)
        new, met = step(ts0, x, labels, mask, lr, mom)
        outs[rp] = (met["total"], new)
    assert torch.equal(outs[0][0], outs[k][0])
    a, b = outs[0][1], outs[k][1]
    for field in ("params", "state", "opt_state", "ema_params", "ema_state"):
        la, lb = leaves(getattr(a, field)), leaves(getattr(b, field))
        assert len(la) == len(lb) > 0
        assert all(torch.equal(u, v) for u, v in zip(la, lb)), field
    # the step moved the params
    assert not all(torch.equal(u, v) for u, v in zip(leaves(a.params), leaves(tp)))


def test_remat_forward_matches_jax(tiny):
    """The training forward with remat_prefix 4 against JAX's (raw maps
    within 2e-4 of each map's largest |value|, new BN state within 1e-5,
    the tolerances of tests/test_torch_port_train_model.py) and against
    the port's forward without it (equal bit for bit); an observer with a
    prefix raises."""
    jplan, params, state, tplan, tp, ts, (x, _, _) = tiny
    j = jax.tree_util.tree_map(jnp.asarray, (params, state))
    want, want_state = japply(jplan, *j, jnp.asarray(x), training=True, remat_prefix=4)
    xt = torch.from_numpy(x)
    got, got_state = apply_model(tplan, tp, ts, xt, training=True, remat_prefix=4)
    plain, plain_state = apply_model(tplan, tp, ts, xt, training=True)
    for g, p, w in zip(got["raw"], plain["raw"], want["raw"]):
        w = np.asarray(w)
        assert torch.equal(g, p)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=2e-4 * np.abs(w).max())
    assert all(torch.equal(u, v) for u, v in zip(leaves(got_state), leaves(plain_state)))
    assert_trees_close(got_state, want_state, 1e-5, "BN state")
    with pytest.raises(ValueError, match="observer"):
        apply_model(tplan, tp, ts, xt, remat_prefix=4, observer=lambda path, v: None)


def _remat_rank(rank, world, init_method, k, data):
    """One SyncBN step of yolov7-tiny on this rank's slice, with
    remat_prefix 0 and k: (total, params) of each, numpy."""
    from yolo_series_tpu_torch.parallel.dist import host_local_slice, init_distributed

    tplan, tp, ts, (x, labels, mask) = data
    group = init_distributed(rank, world, init_method, "cpu")
    sl = host_local_slice(x.shape[0], rank, world)
    loss_fn = make_compute_loss(tplan.head, LossHyp())
    cfg = OptimConfig()
    out = []
    for rp in (0, k):
        ts0 = init_train_state(tp, ts, cfg, device="cpu")
        step = make_train_step(tplan, loss_fn, cfg, mesh=group, compute_dtype=torch.float32,
                               remat_prefix=rp)
        new, met = step(ts0, x[sl], labels[sl], mask[sl], np.array([0.01, 0.01, 0.05],
                                                                      np.float32), 0.9)
        out.append((float(met["total"]), [t.numpy() for t in leaves(new.params)]))
    return out


def test_remat_step_under_sync_bn_is_bit_identical(tiny):
    """On 2 gloo ranks (SyncBN over the group), the step with remat_prefix 4
    equals the step without it bit for bit on each rank: the recompute
    repeats the prefix's BN all-reduces in the backward, in the same order
    on every rank."""
    from yolo_series_tpu_torch.parallel.dist import launch

    *_, tplan, tp, ts, batch = tiny
    x, labels, mask = (np.concatenate([a, a[::-1]]) for a in batch)   # 4 images
    outs = launch(_remat_rank, 2, args=(4, (tplan, tp, ts, (x, labels, mask))), timeout=240,
                  threads=1)
    for (t0, p0), (t4, p4) in outs:
        assert t0 == t4
        assert all(np.array_equal(a, b) for a, b in zip(p0, p4))
    assert all(np.array_equal(a, b) for a, b in zip(outs[0][0][1], outs[1][0][1]))
