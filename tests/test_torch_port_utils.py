"""The port's utilities against the JAX package on the CPU: `profile_fn`,
`model_info`, `profile_layers` / `Model.profile`, `chip_rate`,
`prune_model` and `sparsity`, `setup_logging`, `log_dataset_artifact`,
and `data/tools`. Weights drawn by the port (`port_drawn_model`), fp32."""

import logging
import shutil

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_util import port_drawn_model, to_numpy, zoo_cfg
from yolo_series_tpu.data import tools as jtools
from yolo_series_tpu.models import reparam as jreparam
from yolo_series_tpu.models.layers import Ctx as JCtx
from yolo_series_tpu.models.model import apply_model as japply_model
from yolo_series_tpu.models.model import profile_layers as jprofile_layers
from yolo_series_tpu.obs import loggers as jloggers
from yolo_series_tpu.utils import general as jgeneral
from yolo_series_tpu_torch.data import tools as ttools
from yolo_series_tpu_torch.models import reparam as treparam
from yolo_series_tpu_torch.models.convert import to_jax_tree
from yolo_series_tpu_torch.models.model import Model, apply_model
from yolo_series_tpu_torch.obs import loggers as tloggers
from yolo_series_tpu_torch.utils import chiprate
from yolo_series_tpu_torch.utils import general as tgeneral

torch.set_num_threads(2)

# GFLOPs against the JAX package's XLA cost analysis, in two parts
# (`FlopCounter.dense` and `.pointwise`). The convolutions' and matmuls'
# multiply-adds over the taps inside the input and the max pools' compares
# are the same arithmetic in both: equal, with no tolerance, to XLA's count
# of those operations (`_xla_dense`: each conv_general_dilated,
# dot_general, reduce_window_max and the tiled pool's reduce_max, compiled
# alone), for the whole model and layer by layer. The rest, the pointwise
# work, is spelled apart by the two libraries (XLA counts SiLU 4 operations
# an element and LeakyReLU 3, the port one an aten op; XLA adds the conv
# bias as its own op): the port's rest lies within POINTWISE_RANGE of XLA's
# rest (measured 0.58-0.66 whole models, 0.67-0.73 a conv layer and 0.36 the
# IDetect decode at 64 px). The rest is 0.7-1.2% of XLA's total there.
POINTWISE_RANGE = (0.3, 1.0)
DENSE_PRIMITIVES = ("conv_general_dilated", "dot_general", "reduce_window_max", "reduce_max")


def _xla_dense(jaxpr, cache) -> float:
    """XLA's cost-analysis operations of the DENSE_PRIMITIVES of `jaxpr`
    (nested jaxprs included), each compiled alone on its operands' shapes
    (`cache` holds one count a signature)."""
    total = 0.0
    for e in jaxpr.eqns:
        if e.primitive.name in DENSE_PRIMITIVES:
            avals = [jax.ShapeDtypeStruct(v.aval.shape, v.aval.dtype) for v in e.invars]
            key = (e.primitive.name, str(avals), str(sorted(e.params.items())))
            if key not in cache:
                fn = jax.jit(lambda *a, e=e: e.primitive.bind(*a, **e.params))
                ca = fn.lower(*avals).compile().cost_analysis()
                cache[key] = (ca[0] if isinstance(ca, list) else ca)["flops"]
            total += cache[key]
        for v in e.params.values():
            for sub in v if isinstance(v, (list, tuple)) else (v,):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    total += _xla_dense(sub, cache)
    return total


def _hold_flops(counter, xla_total, xla_dense, what):
    """`counter`'s dense part equal to XLA's, its pointwise part within
    POINTWISE_RANGE of XLA's rest."""
    assert counter.dense == xla_dense, (what, counter.dense, xla_dense)
    rest = xla_total - xla_dense
    lo, hi = POINTWISE_RANGE
    assert lo * rest <= counter.pointwise <= hi * rest + 1, (what, counter.pointwise, rest)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_profile_fn_times_the_calls():
    """Mean seconds a call after a warm-up call, on the host clock for CPU
    outputs; every call runs."""
    calls = []

    def fn(a):
        calls.append(1)
        return a * 2

    dt = tgeneral.profile_fn(fn, torch.ones(4), n=5, name="probe")
    assert len(calls) == 6 and 0 < dt < 0.5


@pytest.mark.parametrize("name,kind", [("yolov7", "deploy"), ("yolov7-tiny", "deploy"),
                                       ("yolov7-tiny", "training")])
def test_model_info_matches_jax(name, kind):
    """Layers and parameters equal to JAX's `model_info`; its GFLOPs of one
    64 px image the sum of the forward's `FlopCounter` parts, held against
    XLA's cost analysis as the module's comment says."""
    jplan, params, state, tplan, tp, ts = port_drawn_model(zoo_cfg(name, kind), seed=0)
    jp, js = _jax(params), _jax(state)
    want = jgeneral.model_info(jplan, jp, js, img_size=64)
    got = tgeneral.model_info(tplan, tp, ts, img_size=64)
    assert got["layers"] == want["layers"] and got["parameters"] == want["parameters"]
    with torch.inference_mode(), tgeneral.FlopCounter() as c:
        apply_model(tplan, tp, ts, torch.zeros((1, 64, 64, 3)))
    assert got["gflops"] == c.flops / 1e9
    closed = jax.make_jaxpr(lambda p, s, x: japply_model(jplan, p, s, x)[0]["pred"])(
        jp, js, jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))
    dense = _xla_dense(closed.jaxpr, {})
    assert dense > 0.9 * want["gflops"] * 1e9
    _hold_flops(c, want["gflops"] * 1e9, dense, name)


def test_profile_layers_match_jax(monkeypatch):
    """`Model.profile` as tests/test_profile.py holds JAX's: one row a
    layer, the head's included, the head row IDetect, every time positive,
    the params summing to the model's; each row's params equal to JAX's
    row, its GFLOPs the sum of its `FlopCounter`'s parts, held against
    XLA's cost of JAX's row as the module's comment says."""
    counters = []

    class Recorded(tgeneral.FlopCounter):
        def __init__(self):
            super().__init__()
            counters.append(self)

    monkeypatch.setattr(tgeneral, "FlopCounter", Recorded)
    jplan, params, state, tplan, tp, ts = port_drawn_model(
        zoo_cfg("yolov7-tiny", "training"), seed=1)
    jp, js = _jax(params), _jax(state)
    m = Model(tplan, tp, ts)
    x = np.random.default_rng(0).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    rows = m.profile(torch.from_numpy(x), iters=1)
    assert len(rows) == len(tplan.layers) == len(counters)
    assert all(r["ms"] > 0 for r in rows)
    assert rows[-1]["module"] == "IDetect"
    assert sum(r["params"] for r in rows) == m.num_params()
    want = jprofile_layers(jplan, jp, js, jnp.asarray(x), iters=1, printout=False)
    assert [r["idx"] for r in rows] == [r["idx"] for r in want]
    ctx, cache = JCtx(training=False), {}
    y, saved = jax.ShapeDtypeStruct(x.shape, jnp.float32), {}
    for spec, g, w, c in zip(jplan.layers, rows, want, counters):
        idx = g["idx"]
        assert (g["module"], g["params"]) == (w["module"], w["params"]), idx
        nchw = g["shape"] if len(g["shape"]) != 4 else (
            g["shape"][0], g["shape"][2], g["shape"][3], g["shape"][1])
        assert tuple(nchw) == tuple(w["shape"]), idx
        assert g["gflops"] == c.flops / 1e9, idx
        inp = ([y if j == -1 else saved[j] for j in spec.frm] if isinstance(spec.frm, tuple)
               else y if spec.frm == -1 else saved[spec.frm])

        def layer(p, s, inp, spec=spec):   # JAX's profile_layers' layer_fn
            if spec.n_seq > 1:
                for r in range(spec.n_seq):
                    inp, _ = spec.block.apply(p[r], s[r], inp, ctx)
                return inp
            return spec.block.apply(p, s, inp, ctx)[0]

        lp, ls = jp["layers"][idx], js["layers"][idx]
        dense = _xla_dense(jax.make_jaxpr(layer)(lp, ls, inp).jaxpr, cache)
        _hold_flops(c, w["gflops"] * 1e9, dense, f"l{idx} {g['module']}")
        y = jax.eval_shape(layer, lp, ls, inp)
        if idx in jplan.save:
            saved[idx] = y


def test_chip_rate_slope():
    """As tests/test_profile.py holds JAX's: a sane small magnitude (the N
    and 2N runs ran; on the CPU the slope of a micro-op is noise, so not
    its sign), every call made, timed on the host clock."""
    calls = {"n": 0}

    def fn(x):
        calls["n"] += 1
        return x.to(torch.int32).sum(dim=(1, 2, 3)) % 7

    x = torch.ones((2, 16, 16, 3), dtype=torch.uint8)
    per = chiprate.chip_rate(fn, x, iters=4, reps=1)
    assert abs(per) < 0.5
    assert calls["n"] == 1 + 4 + 8 and chiprate.chip_rate.mode == "host"


def test_prune_and_sparsity_match_jax():
    """Per-leaf L1 pruning bit-equal with JAX's on the same fused tiny tree,
    and on a leaf whose k-th smallest |w| is tied (every tie at the
    threshold zeroed in both); `sparsity` equal; the pruned model still
    runs (tests/test_reparam.py:161)."""
    jplan, params, state, tplan, tp, ts = port_drawn_model(
        zoo_cfg("yolov7-tiny", "deploy", 0.5), seed=2)
    jp, _ = jreparam.fuse_model(jplan, _jax(params), _jax(state))
    fp, fs = treparam.fuse_model(tplan, tp, ts)
    # ties: 10 of the first conv's weights set to +-(its k-th smallest |w|),
    # which then is the threshold, held by 11 or more weights
    w = fp["layers"][0]["w"]
    k = int(w.numel() * 0.3)
    tie = float(w.abs().flatten().sort().values[k - 1])
    idx = torch.randperm(w.numel(), generator=torch.Generator().manual_seed(0))[:10]
    w.view(-1)[idx] = torch.tensor([tie, -tie] * 5)
    jp["layers"][0]["w"] = jnp.asarray(to_jax_tree(fp)["layers"][0]["w"])
    s0 = treparam.sparsity(fp)
    assert s0 == jreparam.sparsity(jp)
    got, want = treparam.prune_model(fp, 0.3), jreparam.prune_model(jp, 0.3)
    g = jax.tree_util.tree_leaves_with_path(to_jax_tree(got))
    wl = jax.tree_util.tree_leaves_with_path(to_numpy(want))
    assert [p for p, _ in g] == [p for p, _ in wl]
    for (path, a), (_, b) in zip(g, wl):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(path))
    first = got["layers"][0]["w"]
    assert int((first == 0).sum()) > k and not (first.abs() == tie).any()   # ties went too
    s1 = treparam.sparsity(got)
    assert s1 == jreparam.sparsity(want) and s1 > s0 + 0.2
    with torch.no_grad():
        out, _ = apply_model(tplan, got, fs, torch.ones((1, 64, 64, 3)))
    assert torch.isfinite(out["pred"]).all()


@pytest.mark.parametrize("rank,verbose", [(0, True), (-1, True), (1, True), (0, False)])
def test_setup_logging_levels_as_jax(rank, verbose, monkeypatch):
    """The root level each package's `setup_logging` sets by rank."""
    levels = []
    for mod in (tloggers, jloggers):
        root = logging.getLogger()
        monkeypatch.setattr(root, "handlers", [])
        mod.setup_logging(rank, verbose)
        levels.append(root.level)
    assert levels[0] == levels[1] == (logging.INFO if verbose and rank in (-1, 0)
                                      else logging.WARNING)


def test_log_dataset_artifact_without_wandb(tmp_path):
    """No wandb here: both packages skip and return None."""
    data = tmp_path / "data.yaml"
    data.write_text("train: x\nval: y\n")
    assert tloggers.log_dataset_artifact(str(data)) is None
    assert jloggers.log_dataset_artifact(str(data)) is None


def _tree(root):
    """A synthetic images + labels tree, as tests/test_data.py's coco_tree
    (8 images, 1-4 drawn boxes each), one image without a label file."""
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.default_rng(0)
    for i in range(8):
        h, w = int(rng.integers(200, 400)), int(rng.integers(200, 400))
        img = np.full((h, w, 3), 60, np.uint8)
        rows = []
        for _ in range(int(rng.integers(1, 5))):
            bw, bh = rng.uniform(0.1, 0.4, 2)
            cx, cy = rng.uniform(bw / 2, 1 - bw / 2), rng.uniform(bh / 2, 1 - bh / 2)
            cls = int(rng.integers(0, 3))
            x1, y1 = int((cx - bw / 2) * w), int((cy - bh / 2) * h)
            cv2.rectangle(img, (x1, y1), (int((cx + bw / 2) * w), int((cy + bh / 2) * h)),
                          (0, 0, 255), -1)
            rows.append(f"{cls} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}")
        cv2.imwrite(str(root / "images" / f"img{i}.jpg"), img)
        if i != 7:
            (root / "labels" / f"img{i}.txt").write_text("\n".join(rows))


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def test_data_tools_match_jax(tmp_path):
    """flatten_recursive, extract_boxes and autosplit (plain, and
    annotated_only) on copies of the same tree: the same files with the
    same bytes, the same split lists (their paths relative to each tree)."""
    src = tmp_path / "src"
    _tree(src)
    out = {}
    for side, mod in (("port", ttools), ("jax", jtools)):
        root = tmp_path / side / "coco"   # the crops are named after the root
        shutil.copytree(src, root)
        flat = mod.flatten_recursive(root / "images")
        crops = mod.extract_boxes(root)
        lists = mod.autosplit(root / "images", weights=(0.5, 0.3, 0.2), seed=0)
        splits = [p.read_text().replace(str(root), "") if p.exists() else None
                  for p in lists]
        lists2 = mod.autosplit(root / "images", weights=(0.6, 0.4, 0.0),
                               annotated_only=True, seed=1)
        splits2 = [p.read_text().replace(str(root), "") if p.exists() else None
                   for p in lists2]
        out[side] = (_files(flat), _files(crops), splits, splits2)
    assert out["port"] == out["jax"]
    flat, crops, splits, splits2 = out["port"]
    assert len(flat) == 8 + 0 and len(crops) > 8
    assert sum(s.count("\n") for s in splits if s) == 8
    assert sum(s.count("\n") for s in splits2 if s) == 7
