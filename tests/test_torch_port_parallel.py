"""The port's data-parallel layer (`yolo_series_tpu_torch/parallel/dist.py`)
against the JAX package on the CPU, with 2 gloo ranks spawned by
`dist.launch` (one thread each; `tests/_torch_port_parallel_worker.py`
holds the rank functions): `host_local_slice`, the bucketed gradient
all-reduce and the tree broadcast, SyncBN at C 32 (two-pass moments) and C
96 (shifted one-pass) and `--no-sync-bn`'s per-replica BN against JAX's
`batch_norm` on the whole batch, the plain, OTA and aux OTA (nl 4) losses
against JAX's on the whole batch, and `make_train_step(mesh=group)`
against JAX's `make_train_step(mesh=make_mesh(n_data=2))` and the port's
one-process step from the same state. Every launch has a timeout: a rank
that fails or hangs fails its test, and every rank is killed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tests import _torch_port_parallel_worker as W
from tests._torch_port_util import jax_training_model, rel_l2, training_cfg
from tests.test_torch_port_losses import _case, _heads
from tests.test_torch_port_p6_train import _aux_case, _aux_heads
from tests.test_torch_port_train import STEP_LOSS_RTOL, STEP_STATE_REL
from yolo_series_tpu.losses import LossHyp as JHyp
from yolo_series_tpu.losses import make_compute_loss as jloss
from yolo_series_tpu.losses import make_compute_loss_ota as jloss_ota
from yolo_series_tpu.losses.aux_ota import make_compute_loss_aux_ota as jloss_aux
from yolo_series_tpu.models import layers as JL
from yolo_series_tpu.parallel import mesh as jmesh
from yolo_series_tpu.train import optim as joptim
from yolo_series_tpu.train import step as jstep
from yolo_series_tpu_torch.losses import LossHyp, make_compute_loss, make_compute_loss_ota
from yolo_series_tpu_torch.models import layers as TL
from yolo_series_tpu_torch.parallel import dist as D
from yolo_series_tpu_torch.train.optim import OptimConfig
from yolo_series_tpu_torch.train.step import make_train_step

torch.set_num_threads(2)

# a launch of 2 ranks takes 5-10 s on the CPU (spawn, torch's import, the
# gloo rendezvous) plus its cases' work: one that has not returned after
# this long has hung
LAUNCH_TIMEOUT_S = 300


def _launch(fn, *args):
    return D.launch(fn, 2, args=args, timeout=LAUNCH_TIMEOUT_S, threads=1)


# ----------------------------------------------------------- the layer ---

@pytest.mark.parametrize("n,rank,world", [(8, 0, 2), (8, 1, 2), (16, 3, 4), (12, 2, 3),
                                          (7, 1, 2), (4, 0, 1)])
def test_host_local_slice_matches_jax(n, rank, world):
    assert D.host_local_slice(n, rank, world) == jmesh.host_local_slice(n, rank, world)


def test_rank_seed():
    """Rank 0 draws what a one-process run draws; the other ranks differ
    from it and from each other, and each is reproducible."""
    seeds = [D.rank_seed(5, r) for r in range(4)]
    assert seeds[0] == 5 and len(set(seeds)) == 4
    assert seeds == [D.rank_seed(5, r) for r in range(4)]


def test_collectives_over_two_ranks():
    """allreduce_grads sums every tensor over the ranks (1 + 2 = 3 times
    the ramp) through one flat all-reduce a bucket, a tensor larger than
    the bucket taking one of its own; broadcast_tensors sets every tensor leaf
    to the source rank's, whatever its dtype."""
    sizes, bucket = (5, 300, 7, 9, 1), 64 * 4   # 64 fp32 a bucket
    outs = _launch(W.collectives_rank, sizes, bucket)
    for summed, leaves, n_buckets in outs:
        assert n_buckets == 3   # [5], [300], [7, 9, 1]
        for s, n in zip(summed, sizes):
            np.testing.assert_array_equal(s, np.arange(n, dtype=np.float32) * 3)
        assert [a.tolist() for a in leaves] == [[1.0] * 3, [[1, 1], [1, 1]], [-1.0] * 5]


def test_init_distributed_needs_the_cards(monkeypatch):
    """On the card a rank needs its own device: with fewer visible it
    raises, naming the count, and never falls back to gloo."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs CUDA device 1, but 1 is visible"):
        D.init_distributed(1, 2, "tcp://localhost:1", "cuda")
    with pytest.raises(ValueError, match="unsupported"):
        D.init_distributed(0, 1, "tcp://localhost:1", "meta")


def test_ranks_import_no_jax():
    """A spawned rank holds no module of JAX or of the JAX package (this
    test process holds both)."""
    assert _launch(W.imported_rank) == [[], []]


def test_launch_fails_on_a_failing_rank():
    """A rank that raises fails the launch with its traceback, and the rank
    waiting for it at a barrier is killed, long before the timeout."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        D.launch(W.failing_rank, 2, timeout=LAUNCH_TIMEOUT_S, threads=1)


def test_launch_times_out_on_a_hung_rank():
    with pytest.raises(TimeoutError, match="still running"):
        D.launch(W.hanging_rank, 2, timeout=10, threads=1)


# --------------------------------------------------------------- SyncBN ---

BN_CASES = {"sync_c32": (32, 1), "sync_c96": (96, 1), "no_sync_c32": (32, 2),
            "no_sync_c96": (96, 2)}
# JAX's whole-batch numbers against the two ranks': y, dx, the summed
# dscale / dbias and the running stats within 1e-5 of each one's largest
# value (fp32 sums in another order; measured: 2e-7 to 4e-7)
BN_REL = 1e-5


def _bn_input(c):
    rng = np.random.default_rng(c)
    x = rng.normal(0.3, 1.2, (4, c, 6, 5)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.2, c).astype(np.float32)
    state = {"mean": rng.normal(0, 0.2, c).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    gy = rng.normal(0, 1, x.shape).astype(np.float32)
    return x, scale, bias, state, gy


@pytest.fixture(scope="module")
def bn_runs():
    names = sorted(BN_CASES)
    cases = [(*_bn_input(BN_CASES[k][0]), BN_CASES[k][1]) for k in names]
    outs = _launch(W.bn_rank, cases)
    return {k: [o[i] for o in outs] for i, k in enumerate(names)}


def _nhwc(a):
    return np.asarray(a).transpose(0, 2, 3, 1)


def _close(got, want, what):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= BN_REL * np.abs(want).max(), (what, err, np.abs(want).max())


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_bn_two_ranks_match_jax(bn_runs, case):
    """SyncBN (bn_shards 1) and per-replica BN (bn_shards 2, `--no-sync-bn`)
    on 2 ranks of 2 images each against JAX's `batch_norm` on all 4 with
    the same bn_shards, and against the port's in one process: y, dx and
    the grads of scale and bias summed over the ranks (each rank returns
    its own sums; the step's all-reduce adds them). The running stats:
    every rank's under SyncBN, rank 0's per replica (the step broadcasts
    them; JAX's follow shard 0)."""
    c, shards = BN_CASES[case]
    x, scale, bias, state, gy = _bn_input(c)
    ranks = bn_runs[case]
    y = np.concatenate([r[0] for r in ranks])
    dx = np.concatenate([r[2] for r in ranks])
    dscale, dbias = sum(r[3] for r in ranks), sum(r[4] for r in ranks)

    def jf(xx, s, b):
        return JL.batch_norm({"scale": s, "bias": b}, jax.tree_util.tree_map(jnp.asarray, state),
                             xx, JL.Ctx(training=True, bn_shards=shards))

    (jy, jst), vjp = jax.vjp(jf, jnp.asarray(_nhwc(x)), jnp.asarray(scale), jnp.asarray(bias))
    jdx, jds, jdb = vjp((jnp.asarray(_nhwc(gy)), jax.tree_util.tree_map(jnp.zeros_like, jst)))
    _close(_nhwc(y), jy, "y")
    _close(_nhwc(dx), jdx, "dx")
    _close(dscale, jds, "dscale")
    _close(dbias, jdb, "dbias")
    for r in ranks if shards == 1 else ranks[:1]:
        for k in ("mean", "var"):
            _close(r[1][k], jst[k], k)
    if shards > 1:   # rank 1's own stats are its slice's, not the global batch's
        assert np.abs(ranks[1][1]["mean"] - np.asarray(jst["mean"])).max() > 1e-3

    # the port in one process on all 4 images
    xt = torch.from_numpy(x).requires_grad_()
    st, bt = (torch.from_numpy(a).requires_grad_() for a in (scale, bias))
    ty, tst = TL.batch_norm({"scale": st, "bias": bt},
                            {k: torch.from_numpy(v) for k, v in state.items()}, xt,
                            TL.Ctx(training=True, bn_shards=shards))
    tdx, tds, tdb = torch.autograd.grad(ty, (xt, st, bt), torch.from_numpy(gy))
    for got, want, what in ((y, ty, "y"), (dx, tdx, "dx"), (dscale, tds, "dscale"),
                            (dbias, tdb, "dbias"), (ranks[0][1]["var"], tst["var"], "var")):
        _close(got, want.detach().numpy(), what + " (port, one process)")


@pytest.fixture(scope="module")
def bn_core_runs():
    """`BnTrainCore` on 2 ranks at C 32 and 96, with cotangents of its mean
    and var outputs as well as of y."""
    cases = []
    for c in (32, 96):
        x, scale, bias, state, gy = _bn_input(c)
        rng = np.random.default_rng(c + 1)
        gm, gv = (rng.normal(0, 1, c).astype(np.float32) for _ in range(2))
        cases.append((x, scale, bias, state["mean"], gy, gm, gv))
    return cases, _launch(W.bn_core_rank, cases)


@pytest.mark.parametrize("i,c", [(0, 32), (1, 96)])
def test_bn_core_mean_var_cotangents_match_jax(bn_core_runs, i, c):
    """SyncBN's backward with cotangents of the mean and var outputs (each
    rank holding its own share of them, as each rank's loss would give)
    against JAX's `_bn_train_core` on the whole batch: y, the moments, dx
    and the summed dscale / dbias. The train step gives none (the running
    stats take the moments detached); the backward keeps them exact."""
    cases, outs = bn_core_runs
    x, scale, bias, m0, gy, gm, gv = cases[i]
    ranks = [o[i] for o in outs]

    def jf(xx, s, b):
        return JL._bn_train_core(None, xx, s, b, jnp.asarray(m0))

    (jy, jm, jv), vjp = jax.vjp(jf, jnp.asarray(_nhwc(x)), jnp.asarray(scale),
                                jnp.asarray(bias))
    jdx, jds, jdb = vjp((jnp.asarray(_nhwc(gy)), jnp.asarray(gm), jnp.asarray(gv)))
    _close(_nhwc(np.concatenate([r[0] for r in ranks])), jy, "y")
    for r in ranks:
        _close(r[1], jm, "mean")
        _close(r[2], jv, "var")
    _close(_nhwc(np.concatenate([r[3] for r in ranks])), jdx, "dx")
    _close(sum(r[4] for r in ranks), jds, "dscale")
    _close(sum(r[5] for r in ranks), jdb, "dbias")


# --------------------------------------------------------------- losses ---

LOSS_CASES = ("aux_ota_nl4", "ota", "ota_padded_out", "plain")


def _loss_input(name, tmp_path):
    """(kind, JAX head, port head, raw maps, labels, mask) of batch 2: one
    image a rank. padded_out: image 1 has no label, so rank 1 has no
    positive and the global counts differ from each rank's."""
    if name == "aux_ota_nl4":
        jhead, thead = _aux_heads(4, tmp_path)
        return ("aux_ota", jhead, thead) + _aux_case(0, thead)
    jhead, thead = _heads(80)
    raw, labels, mask = _case(3 if name.endswith("padded_out") else 0,
                              pad_out=name.endswith("padded_out"))
    return (name.split("_")[0], jhead, thead, raw, labels, mask)


@pytest.fixture(scope="module")
def loss_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_losses")
    inputs = {k: _loss_input(k, tmp) for k in LOSS_CASES}
    cases = [(kind, th, raw, lb, mk) for kind, _, th, raw, lb, mk in
             (inputs[k] for k in LOSS_CASES)]
    outs = _launch(W.loss_rank, cases)
    return inputs, {k: [o[i] for o in outs] for i, k in enumerate(LOSS_CASES)}


JLOSSES = {"plain": jloss, "ota": jloss_ota, "aux_ota": jloss_aux}


@pytest.mark.parametrize("case", LOSS_CASES)
def test_loss_two_ranks_match_jax(loss_runs, case):
    """Each rank's loss on its image, normalized over the whole batch: the
    ranks' totals sum to JAX's total on both images, every rank's items are
    JAX's (all-reduced), and the raw maps' grads of the ranks' totals are
    JAX's within 1e-5 of each map's largest |grad| (tests/
    test_torch_port_losses.py's limits)."""
    inputs, runs = loss_runs
    kind, jhead, _, raw, labels, mask = inputs[case]
    ranks = runs[case]
    jf = JLOSSES[kind](jhead, JHyp())
    (want, witems), want_g = jax.value_and_grad(
        lambda r: jf(r, jnp.asarray(labels), jnp.asarray(mask)), has_aux=True)(
        [jnp.asarray(r) for r in raw])
    np.testing.assert_allclose(sum(r[0] for r in ranks), float(want), rtol=1e-5)
    for _, items, _ in ranks:
        assert set(items) == {"box", "obj", "cls"}
        for k in items:
            np.testing.assert_allclose(items[k], float(witems[k]), rtol=1e-5, atol=1e-7)
    for li, w in enumerate(want_g):
        w = np.asarray(w)
        g = np.concatenate([r[2][li] for r in ranks])
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())
    if case == "ota_padded_out":
        assert ranks[0][0] != ranks[1][0]


# ----------------------------------------------------------- train step ---

# (loss, make_train_step options): SGD, fp32, yolov7 training form at width
# 0.25, 128 px, a global batch of 4 (2 a rank)
STEP_CASES = {"ota": ("ota", {}), "plain_accumulate2": ("plain", {"accumulate": 2}),
              "ota_no_sync_bn": ("ota", {"bn_shards": 2})}
SIZE, M = 128, 16


@pytest.fixture(scope="module")
def model():
    return jax_training_model(0.25, seed=0, stats_seed=1)


def _step_batch(rng, acc):
    lead = (acc,) if acc > 1 else ()
    images = rng.uniform(0, 1, lead + (4, SIZE, SIZE, 3)).astype(np.float32)
    labels = np.zeros(lead + (4, M, 5), np.float32)
    mask = np.zeros(lead + (4, M), bool)
    for idx in np.ndindex(*lead, 4):
        k = int(rng.integers(3, 9))
        labels[idx][:k] = np.concatenate([rng.integers(0, 80, (k, 1)),
                                          rng.uniform(0.15, 0.85, (k, 2)),
                                          rng.uniform(0.05, 0.5, (k, 2))], 1)
        mask[idx][:k] = True
    return images, labels, mask


LR, MOM = np.asarray([0.01, 0.01, 0.05], np.float32), np.float32(0.9)


@pytest.fixture(scope="module")
def step_runs(model):
    """The JAX step on a 2-device mesh (the conftest's virtual CPU devices)
    and the port's on 2 ranks, each case from the same JAX-initialized
    state; the state before, as numpy trees."""
    jplan, params, state, _, _, _ = model
    mesh = jmesh.make_mesh(n_data=2)
    cfg = training_cfg(0.25)
    jcfg = joptim.OptimConfig()
    before, batches, jax_out, cases = {}, {}, {}, []
    for i, name in enumerate(sorted(STEP_CASES)):
        kind, opts = STEP_CASES[name]
        acc = opts.get("accumulate", 1)
        batches[name] = _step_batch(np.random.default_rng(i), acc)
        jts = jstep.init_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                                     jax.tree_util.tree_map(jnp.asarray, state), jcfg)
        before[name] = jax.tree_util.tree_map(np.asarray, jts._asdict())
        jts = jax.device_put(jts, jmesh.replicated(mesh))
        jlf = (jloss_ota if kind == "ota" else jloss)(jplan.head, JHyp())
        jfn = jstep.make_train_step(jplan, jlf, jcfg, mesh=mesh, compute_dtype=jnp.float32,
                                    **opts)
        bsh = NamedSharding(mesh, P(None, "data") if acc > 1 else P("data"))
        new, jm = jfn(jts, *(jax.device_put(jnp.asarray(a), bsh) for a in batches[name]),
                      jnp.asarray(LR), jnp.asarray(MOM))
        new = jax.tree_util.tree_map(np.asarray, new._asdict())
        jax_out[name] = ({k: new[k] for k in ("params", "state", "ema_params", "ema_state")}
                         | {"v": new["opt_state"]["v"]}, {k: float(v) for k, v in jm.items()})
        cases.append((cfg, kind, before[name], batches[name], LR, MOM, opts))
    outs = _launch(W.step_rank, cases)
    port = {k: [o[i] for o in outs] for i, k in enumerate(sorted(STEP_CASES))}
    return before, batches, jax_out, port


def _leaves(tree):
    return [np.asarray(a, np.float64) for a in jax.tree_util.tree_leaves(tree)]


def _state_close(got, want, what):
    for a, b in zip(_leaves(got), _leaves(want)):
        assert np.abs(a - b).max() <= STEP_STATE_REL * np.abs(b).max(), what


# The two ranks' step against the port's one-process step from the same
# state: the losses within 1e-5 relative and the new BN and EMA state within
# 1e-5 of each leaf's largest value (tests/test_torch_port_train.py's
# limits), and the updates of the params, the EMA params and the momentum
# buffer within PARALLEL_UPDATE_L2 relative L2 (measured 1.0e-4 to 1.9e-4:
# fp32 sums in another order, moved further by max-pool near-ties; a MEAN
# all-reduce, or the BN scale and bias grads summed twice, moves 50-100%).
# Against JAX's mesh step the losses and state are held to the same limits,
# and the update to lie no further from it than the one-process port step
# lies, plus PARALLEL_UPDATE_L2. The one-process port step's own distance to
# JAX's mesh step is held to MESH_UPDATE_L2: the gradient jumps at max-pool
# near-ties, which the libraries' roundings route apart; on
# plain_accumulate2's batch the port lies 2.3e-2 from JAX's one-device step
# and JAX's mesh step 7.5e-3 from JAX's one-device step (the other cases
# 1.6e-4 to 2.2e-3), the limit of tests/test_torch_port_p6_train.py.
PARALLEL_UPDATE_L2, MESH_UPDATE_L2 = 1e-3, 3e-2


def _hold(got, want, before, what, update_l2):
    """The step's losses and state against a reference from the same state
    `before`, with tests/test_torch_port_train.py's limits; returns each
    updated tree's relative L2 distance to the reference's update, each
    within update_l2 (a {tree: limit} dict)."""
    (gt, gm), (wt, wm) = got, want
    assert set(gm) == set(wm) == {"box", "obj", "cls", "total"}
    for k in gm:
        np.testing.assert_allclose(gm[k], wm[k], rtol=STEP_LOSS_RTOL, err_msg=f"{what} {k}")
    for k in ("state", "ema_state"):
        _state_close(gt[k], wt[k], f"{what} {k}")
    errs = {}
    for k, limit in update_l2.items():
        errs[k] = rel_l2(gt[k], wt[k], before[k])
        assert errs[k] <= limit, (what, k, errs[k], limit)
    return errs


UPDATED = ("params", "ema_params", "v")


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_two_ranks_matches_jax_mesh(step_runs, model, case):
    """`make_train_step(mesh=group)` on 2 gloo ranks against the port's
    one-process step and JAX's `make_train_step(mesh=make_mesh(n_data=2))`,
    from the same state on the same global batch: the losses, the new BN
    state and EMA state, and the updates of the params, the EMA params and
    the momentum buffer (limits above). Both ranks end with the same state,
    bit for bit."""
    before, batches, jax_out, port = step_runs
    ranks = port[case]
    for a, b in zip(_leaves(ranks[0][0]), _leaves(ranks[1][0])):
        np.testing.assert_array_equal(a, b)
    assert ranks[0][1] == ranks[1][1]

    kind, opts = STEP_CASES[case]
    _, _, _, tplan, _, _ = model
    lf = (make_compute_loss_ota if kind == "ota" else make_compute_loss)(tplan.head, LossHyp())
    fn = make_train_step(tplan, lf, OptimConfig(), compute_dtype=torch.float32, **opts)
    one = W.step_result(*fn(W.port_train_state(tplan, before[case]), *batches[case], LR, MOM))
    b = before[case]
    b = {"params": b["params"], "ema_params": b["ema_params"], "v": b["opt_state"]["v"]}
    _hold(ranks[0], one, b, "against one process", dict.fromkeys(UPDATED, PARALLEL_UPDATE_L2))
    floor = _hold(one, jax_out[case], b, "one process against JAX's mesh",
                  dict.fromkeys(UPDATED, MESH_UPDATE_L2))
    _hold(ranks[0], jax_out[case], b, "against JAX's mesh",
          {k: floor[k] + PARALLEL_UPDATE_L2 for k in UPDATED})
