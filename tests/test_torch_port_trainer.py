"""The port's trainer, checkpoints and CLIs against the JAX package on the
CPU: both trainers start from one JAX-written `--weights` checkpoint on a
synthetic shapes set (yolov7 training form at width 0.25, 128 px, batch 2,
fp32, the default hyp, autoanchor on, JAX's `fast_stem` off) with the same
seed, and their first optimizer step is held to the limits of
tests/test_torch_port_train.py. Checkpoints cross both ways, resume
continues from the saved state, strip and `get_latest_run` match, and the
two test CLIs give the same metrics on one checkpoint."""

import os
import random
import shutil
import types
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests._torch_port_util import (assert_trees_close, jax_model, to_jax_tree, to_numpy,
                                    training_cfg)
from tests.test_torch_port_train import STEP_STATE_REL, STEP_UPDATE_L2, _update_l2
from yolo_series_tpu.cli import test as jcli_test
from yolo_series_tpu.models.model import Model as JModel
from yolo_series_tpu.train import checkpoints as jck
from yolo_series_tpu.train import optim as joptim
from yolo_series_tpu.train import step as jstep
from yolo_series_tpu.train import trainer as jtrainer
from yolo_series_tpu_torch.cli import test as cli_test
from yolo_series_tpu_torch.cli import train as cli_train
from yolo_series_tpu_torch.models.convert import to_jax_params
from yolo_series_tpu_torch.models.model import tree_leaves as leaves
from yolo_series_tpu_torch.models.model import tree_map
from yolo_series_tpu_torch.train import checkpoints as ck
from yolo_series_tpu_torch.train import optim
from yolo_series_tpu_torch.train import trainer
from yolo_series_tpu_torch.train.step import TrainState, init_train_state

torch.set_num_threads(2)

SIZE, NC, WIDTH = 128, 3, 0.25
# The first step's loss items against JAX's: the step itself (not the
# trainer) differs from JAX's by up to 3.0e-5 relative in a loss item on
# random batches of this size (fp32 sums over the positives in another
# order; tests/torch_port_train_noise.py, eight batches), above the 1e-5
# that tests/test_torch_port_train.py's three cases meet. A wrong batch,
# hyp scaling or loss moves the items by 1% or more.
LOSS_RTOL = 1e-4


def _write_set(root, n, seed, shapes):
    """n noise JPEGs of the given (h, w) with 1-3 filled boxes each over NC
    classes, YOLO labels beside them."""
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        img = rng.integers(30, 100, (h, w, 3)).astype(np.uint8)
        rows = []
        for _ in range(int(rng.integers(1, 4))):
            bw, bh = rng.uniform(0.15, 0.45, 2)
            cx, cy = rng.uniform(0.3, 0.7, 2)
            cv2.rectangle(img, (int((cx - bw / 2) * w), int((cy - bh / 2) * h)),
                          (int((cx + bw / 2) * w), int((cy + bh / 2) * h)),
                          tuple(int(v) for v in rng.integers(120, 256, 3)), -1)
            rows.append(f"{int(rng.integers(0, NC))} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}")
        cv2.imwrite(str(root / "images" / f"im{i}.jpg"), img)
        (root / "labels" / f"im{i}.txt").write_text("\n".join(rows))


@pytest.fixture(scope="module")
def shapes_set(tmp_path_factory):
    """Two training and two validation images, a data.yaml and the model
    cfg file (yolov7 training form, width 0.25, NC classes)."""
    root = tmp_path_factory.mktemp("shapes")
    _write_set(root / "train", 2, 7, ((96, 128), (128, 112)))
    _write_set(root / "val", 2, 8, ((120, 160), (128, 128)))
    data = root / "data.yaml"
    data.write_text(yaml.dump({"train": str(root / "train" / "images"),
                               "val": str(root / "val" / "images"),
                               "nc": NC, "names": ["a", "b", "c"]}))
    cfg = root / "yolov7-w025.yaml"
    cfg.write_text(yaml.dump(training_cfg(WIDTH, nc=NC)))
    return root, str(data), str(cfg)


@pytest.fixture(scope="module")
def weights(shapes_set, tmp_path_factory):
    """A checkpoint written by the JAX package's save_checkpoint from its
    own init (seed 4): the start of both trainers."""
    cfg = training_cfg(WIDTH, nc=NC)
    m = JModel.from_yaml(cfg, key=jax.random.PRNGKey(4))
    ts = jstep.init_train_state(m.params, m.state, joptim.OptimConfig())
    path = tmp_path_factory.mktemp("weights") / "init.ckpt"
    jck.save_checkpoint(str(path), ts, cfg)
    return str(path)


def _snapshot(ts):
    """A TrainState of either package as numpy trees in the JAX layout
    (copies)."""
    if isinstance(ts, jstep.TrainState):
        return {k: jax.tree_util.tree_map(lambda a: np.array(a, copy=True), v)
                for k, v in ts._asdict().items()}
    return {k: (to_jax_tree(v) if k != "step" else v) for k, v in ts._asdict().items()}


def _spy(monkeypatch, module, name, calls):
    """Record the arguments of every call of module.name, as floats."""
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append([float(a) for a in args] + sorted(kwargs.items()))
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


@pytest.fixture(scope="module")
def jax_run(shapes_set, weights, tmp_path_factory):
    """One epoch (one optimizer step) of the JAX trainer, no val; the
    global random and np.random seeded with the trainers' seed. Also the
    arguments of its warmup_factors calls."""
    _, data, cfg = shapes_set
    snaps, calls = [], []
    tc = jtrainer.TrainConfig(
        cfg=cfg, data=data, epochs=1, batch_size=2, img_size=SIZE, nominal_batch_size=2,
        weights=weights, save_dir=str(tmp_path_factory.mktemp("jrun") / "exp"),
        compute_dtype=jnp.float32, fast_stem=False, max_labels=16, noval=True, seed=0)
    random.seed(0)
    np.random.seed(0)
    with pytest.MonkeyPatch.context() as mp:
        _spy(mp, jtrainer, "warmup_factors", calls)
        out = jtrainer.train(tc, callbacks={"on_epoch_end": lambda e, r, ts: snaps.append(
            _snapshot(ts))})
    return out, snaps, calls


@pytest.fixture(scope="module")
def port_run(shapes_set, weights, tmp_path_factory):
    """Two epochs of the port's trainer on the CPU, with per-epoch val."""
    _, data, cfg = shapes_set
    snaps, calls = [], []
    tc = trainer.TrainConfig(
        cfg=cfg, data=data, epochs=2, batch_size=2, img_size=SIZE, nominal_batch_size=2,
        weights=weights, save_dir=str(tmp_path_factory.mktemp("prun") / "exp"),
        compute_dtype=torch.float32, max_labels=16, seed=0, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        _spy(mp, trainer, "warmup_factors", calls)
        out = trainer.train(tc, callbacks={"on_epoch_end": lambda e, r, ts: snaps.append(
            _snapshot(ts))})
    return out, snaps, calls


def test_first_step_matches_jax(weights, jax_run, port_run):
    """After the first optimizer step (warmup step 0: the weights' lr is 0,
    the biases' 0.1, so the momentum slot holds the whole gradient): the
    losses within LOSS_RTOL, BN state and its EMA within
    STEP_STATE_REL, the updates of the params, the momentum slot and the
    EMA params within STEP_UPDATE_L2 of JAX's. The checkpoints' cfg (with
    autoanchor's anchors) are equal."""
    (jout, jsnaps, jcalls), (pout, psnaps, pcalls) = jax_run, port_run
    # the warmup's step, epoch and hyp (the runs' epochs differ: 2 and 1)
    assert pcalls[0][:3] + pcalls[0][4:] == jcalls[0][:3] + jcalls[0][4:]
    blob = jck.load_checkpoint(weights)
    before = {"params": jax.tree_util.tree_map(lambda a: a.astype(np.float32), blob["params"]),
              "ema_params": jax.tree_util.tree_map(lambda a: a.astype(np.float32),
                                                   blob["ema_params"]),
              "v": blob["opt_state"]["v"]}
    got, want = psnaps[0], jsnaps[0]
    for k in ("box", "obj", "cls", "total"):
        np.testing.assert_allclose(pout["results"][0][f"train/{k}"],
                                   jout["results"][0][f"train/{k}"], rtol=LOSS_RTOL)
    assert got["step"] == int(want["step"]) == 1
    for k in ("state", "ema_state"):   # relative L2 of the tree, as chip_smoke's (b)
        assert _tree_rel_l2(got[k], want[k]) <= STEP_STATE_REL, k
    for name, g, w, b in (("params", got["params"], want["params"], before["params"]),
                          ("v", got["opt_state"]["v"], want["opt_state"]["v"], before["v"]),
                          ("ema_params", got["ema_params"], want["ema_params"],
                           before["ema_params"])):
        err = _update_l2(ck.from_jax_tree(g), w, b)
        assert err <= STEP_UPDATE_L2, (name, err)
    cfgs = [jck.load_checkpoint(Path(o["save_dir"]) / "weights" / "epoch_000.ckpt")["cfg"]
            for o in (jout, pout)]
    assert cfgs[0] == cfgs[1]


def _tree_rel_l2(got, want):
    g, w = (np.concatenate([np.ravel(np.asarray(x, np.float64))
                            for x in jax.tree_util.tree_leaves(t)]) for t in (got, want))
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def test_port_run_writes_the_run_directory(port_run):
    """hyp.yaml, opt.yaml, results.jsonl, the per-epoch val rows, last and
    best stripped, epoch_000/001 kept with their optimizer state, DONE."""
    out, snaps, _ = port_run
    d = Path(out["save_dir"])
    assert {"hyp.yaml", "opt.yaml", "results.jsonl", "DONE"} <= {p.name for p in d.iterdir()}
    opt = yaml.safe_load((d / "opt.yaml").read_text())
    assert opt["device"] == "cpu" and opt["epochs"] == 2 and "compute_dtype" not in opt
    assert [r["epoch"] for r in out["results"]] == [0, 1]
    for r in out["results"]:
        assert {"val/map50", "val/map", "time_s", "wait_s"} <= set(r)
        assert all(np.isfinite(r[f"train/{k}"]) for k in ("box", "obj", "cls", "total"))
    assert out["final_results"]["seen"] == 2
    # best.ckpt is written when an epoch's fitness is above 0 and the best
    fits = [0.1 * r["val/map50"] + 0.9 * r["val/map"] for r in out["results"]]
    assert (d / "weights" / "best.ckpt").exists() == (max(fits) > 0)
    for name in ("last.ckpt", "best.ckpt"):
        if (d / "weights" / name).exists():
            blob = ck.load_checkpoint(d / "weights" / name)
            assert blob["opt_state"] is None and blob["epoch"] == -1
    blob = ck.load_checkpoint(d / "weights" / "epoch_001.ckpt")
    assert blob["epoch"] == 1 and blob["step"] == 2 and set(blob["opt_state"]) == {"v"}
    assert len(snaps) == 2 and snaps[1]["step"] == 2


def _same_blob_trees(a, b, keys=("params", "state", "ema_params", "ema_state", "opt_state")):
    for k in keys:
        la, lb = (jax.tree_util.tree_leaves_with_path(x[k]) for x in (a, b))
        assert [p for p, _ in la] == [p for p, _ in lb], k
        for (p, x), (_, y) in zip(la, lb):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, (k, p)
            np.testing.assert_array_equal(x, y)


def test_checkpoints_cross_both_ways(jax_run, port_run, tmp_path):
    """The port's epoch-0 checkpoint has JAX's layout (keys, nesting,
    dtypes, shapes), loads into JAX's load_checkpoint_any and
    restore_train_state as the port's state (params and EMA through fp16);
    JAX's loads into the port's restore_train_state as JAX's state."""
    (jout, jsnaps, _), (pout, psnaps, _) = jax_run, port_run
    pblob = jck.load_checkpoint(Path(pout["save_dir"]) / "weights" / "epoch_000.ckpt")
    jblob = ck.load_checkpoint(Path(jout["save_dir"]) / "weights" / "epoch_000.ckpt")
    assert pblob.keys() == jblob.keys() and pblob["format"] == jblob["format"]
    for k in ("params", "state", "ema_params", "ema_state", "opt_state"):
        assert (jax.tree_util.tree_structure(pblob[k])
                == jax.tree_util.tree_structure(jblob[k])), k
        for x, y in zip(jax.tree_util.tree_leaves(pblob[k]), jax.tree_util.tree_leaves(jblob[k])):
            assert x.dtype == y.dtype and x.shape == y.shape, k

    half = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: a.astype(np.float16).astype(np.float32) if a.dtype == np.float32 else a, t)
    # the port's checkpoint in JAX
    jts = jck.restore_train_state(pblob, joptim.OptimConfig())
    snap = psnaps[0]
    for k in ("params", "ema_params"):
        _same_blob_trees({k: to_numpy(getattr(jts, k))}, {k: half(snap[k])}, (k,))
    for k in ("state", "ema_state", "opt_state"):
        _same_blob_trees({k: to_numpy(getattr(jts, k))}, {k: snap[k]}, (k,))
    assert int(jts.step) == snap["step"] == 1
    plan, params, state = jck.load_checkpoint_any(
        str(Path(pout["save_dir"]) / "weights" / "epoch_000.ckpt"))
    _same_blob_trees({"p": to_numpy(params), "s": to_numpy(state)},
                     {"p": half(snap["ema_params"]), "s": snap["ema_state"]}, ("p", "s"))
    # JAX's checkpoint in the port
    pts = ck.restore_train_state(jblob, optim.OptimConfig(), device="cpu")
    snap = jsnaps[0]
    for k in ("params", "ema_params"):
        _same_blob_trees({k: to_jax_tree(getattr(pts, k))}, {k: half(snap[k])}, (k,))
    for k in ("state", "ema_state", "opt_state"):
        _same_blob_trees({k: to_jax_tree(getattr(pts, k))}, {k: snap[k]}, (k,))
    assert pts.step == 1


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_save_restore_gives_back_the_state(kind, tmp_path):
    """save_checkpoint then restore_train_state: every tree as saved (the
    params and EMA params through fp16), Adam's `t` an int32 scalar in the
    file and an int back; the JAX package restores the same trees."""
    cfg = training_cfg(0.125, nc=2)
    plan = ck.compile_graph(cfg)
    from yolo_series_tpu_torch.models.model import init_model
    params, state = init_model(plan, torch.Generator().manual_seed(1))
    ts = init_train_state(params, state, optim.OptimConfig(kind=kind), device="cpu")
    gen = torch.Generator().manual_seed(2)
    rnd = lambda t: tree_map(lambda x: torch.randn(x.shape, generator=gen), t)  # noqa: E731
    opt = {k: rnd(v) for k, v in ts.opt_state.items() if k != "t"}
    if kind == "adam":
        opt["t"] = 3
    ts = TrainState(rnd(ts.params), rnd(ts.state), opt, rnd(ts.params), rnd(ts.state), 3)
    path = tmp_path / "a.ckpt"
    ck.save_checkpoint(path, ts, cfg, epoch=5, best_fitness=0.25, results=[{"epoch": 5}])
    assert not Path(str(path) + ".tmp").exists()
    blob = ck.load_checkpoint(path)
    if kind == "adam":
        assert blob["opt_state"]["t"].dtype == np.int32 and blob["opt_state"]["t"] == 3
    back = ck.restore_train_state(blob, optim.OptimConfig(kind=kind), device="cpu")
    assert back.step == 3 and back.opt_state.get("t") == ts.opt_state.get("t")
    for k in ("params", "state", "ema_params", "ema_state"):
        for x, y in zip(leaves(getattr(back, k)), leaves(getattr(ts, k))):
            y = y.half().float() if k in ("params", "ema_params") else y
            assert torch.equal(x, y), k
    for x, y in zip(leaves(back.opt_state), leaves(ts.opt_state)):
        assert torch.equal(x, y)
    # the trees in the file are to_jax_params' (params through fp16)
    pj, sj = to_jax_params(plan, ts.params, ts.state)
    _same_blob_trees({"p": blob["params"], "s": blob["state"]},
                     {"p": jax.tree_util.tree_map(lambda a: a.astype(np.float16), pj), "s": sj},
                     ("p", "s"))
    jts = jck.restore_train_state(blob, joptim.OptimConfig(kind=kind))
    slots = [k for k in back.opt_state if k != "t"]
    _same_blob_trees({k: to_numpy(jts.opt_state[k]) for k in slots},
                     {k: to_jax_tree(back.opt_state[k]) for k in slots}, slots)
    if kind == "adam":
        assert int(jts.opt_state["t"]) == back.opt_state["t"] == 3


def test_resume_continues_at_the_next_epoch(port_run, tmp_path, monkeypatch):
    """`cli/train.py --resume <epoch_000.ckpt>` in a copy of the run: the
    run's recorded options, the state restored as it was saved, epoch 1
    only, one more step."""
    out, snaps, _ = port_run
    run = tmp_path / "exp"
    shutil.copytree(out["save_dir"], run)
    for name in ("last.ckpt", "best.ckpt", "epoch_001.ckpt"):
        (run / "weights" / name).unlink(missing_ok=True)
    restored = []
    real = trainer.restore_train_state

    def spy(*a, **kw):
        restored.append(real(*a, **kw))
        return restored[-1]

    monkeypatch.setattr(trainer, "restore_train_state", spy)
    res = cli_train.main(["--resume", str(run / "weights" / "epoch_000.ckpt")])
    assert [r["epoch"] for r in res["results"]] == [1]
    assert res["train_state"].step == snaps[0]["step"] + 1
    assert Path(res["save_dir"]) == run and (run / "weights" / "epoch_001.ckpt").exists()
    half = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: a.astype(np.float16).astype(np.float32), t)
    got = _snapshot(restored[0])
    for k in ("params", "ema_params"):
        _same_blob_trees({k: got[k]}, {k: half(snaps[0][k])}, (k,))
    for k in ("state", "ema_state", "opt_state"):
        _same_blob_trees({k: got[k]}, {k: snaps[0][k]}, (k,))


def test_strip_and_latest_run_match_jax(port_run, tmp_path):
    """strip_checkpoint writes the file the JAX package's writes;
    get_latest_run picks the same newest last.ckpt."""
    out, _, _ = port_run
    src = Path(out["save_dir"]) / "weights" / "epoch_000.ckpt"
    mine, ref = tmp_path / "mine.ckpt", tmp_path / "ref.ckpt"
    shutil.copyfile(src, mine)
    shutil.copyfile(src, ref)
    assert ck.strip_checkpoint(str(mine)) == str(mine)
    jck.strip_checkpoint(str(ref))
    assert mine.read_bytes() == ref.read_bytes()
    for i, name in enumerate(("a/weights", "b/weights", "c/x/weights")):
        (tmp_path / "runs" / name).mkdir(parents=True)
        f = tmp_path / "runs" / name / "last.ckpt"
        f.write_bytes(b"")
        os.utime(f, ns=(10 ** 18 + i * 10 ** 9 if i != 1 else 2 * 10 ** 18,) * 2)
    assert ck.get_latest_run(tmp_path / "runs") == jck.get_latest_run(tmp_path / "runs")
    assert ck.get_latest_run(tmp_path / "runs").endswith("b/weights/last.ckpt")
    assert ck.get_latest_run(tmp_path / "none") == jck.get_latest_run(tmp_path / "none") == ""


@pytest.fixture(scope="module")
def eval_case(tmp_path_factory):
    """A livened yolov7 training form (IDetect, width 0.25, 4 classes) in a
    JAX-written checkpoint, and a val set of four noise images (two aspect
    ratios) labelled with the model's own confident detections, jittered,
    plus one box it does not find an image (so mAP is neither 0 nor 1)."""
    import yolo_series_tpu_torch.data.datasets as PD
    from yolo_series_tpu_torch.eval.evaluator import scale_coords_np
    from yolo_series_tpu_torch.models.convert import from_jax_params
    from yolo_series_tpu_torch.models.model import apply_model
    from yolo_series_tpu_torch.ops import nms

    root = tmp_path_factory.mktemp("evalset")
    cfg = training_cfg(WIDTH, nc=4)
    plan, params, state = jax_model(WIDTH, seed=2, size=SIZE, candidates=40, cfg=cfg)
    ts = types.SimpleNamespace(step=0, params=params, state=state, ema_params=params,
                               ema_state=state, opt_state={})
    ckpt = root / "livened.ckpt"
    jck.save_checkpoint(str(ckpt), ts, cfg)
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(9)
    for i, (h, w) in enumerate(((128, 128), (96, 128), (128, 128), (96, 128))):
        cv2.imwrite(str(root / "images" / f"v{i}.png"),
                    rng.integers(0, 256, (h, w, 3), np.uint8))
    # the model's detections on the letterboxed val batches, mapped back
    tplan, p16, s16 = ck.load_checkpoint_any(str(ckpt))
    ds = PD.DetectionDataset(str(root / "images"), img_size=SIZE, batch_size=2, rect=True,
                             pad=0.5, stride=32)
    for b in PD.create_loader(ds, batch_size=2, shuffle=False, drop_last=False):
        with torch.inference_mode():
            out, _ = apply_model(tplan, p16, s16, torch.from_numpy(b["images"]).float() / 255)
            dets = nms.nms_output_to_dets(nms.batched_nms(out["pred"], max_det=6))
        for si, d in enumerate(dets):
            (h0, w0), ratio_pad = b["shapes"][si]
            xyxy = scale_coords_np(b["images"].shape[1:3], d[:, :4].copy(), (h0, w0),
                                   ratio_pad) + rng.normal(0, 1.0, (len(d), 4))
            xywh = np.concatenate([(xyxy[:, :2] + xyxy[:, 2:]) / 2,
                                   xyxy[:, 2:] - xyxy[:, :2]], 1) / [w0, h0, w0, h0]
            rows = [f"{int(c)} " + " ".join(f"{v:.6f}" for v in np.clip(r, 0.001, 0.999))
                    for c, r in zip(d[:, 5], xywh)] + [f"{si % 4} 0.5 0.5 0.2 0.3"]
            stem = Path(b["paths"][si]).stem
            (root / "labels" / f"{stem}.txt").write_text("\n".join(rows))
    data = root / "data.yaml"
    data.write_text(yaml.dump({"val": str(root / "images"), "nc": 4,
                               "names": ["a", "b", "c", "d"]}))
    return str(ckpt), str(data)


def _jax_opt(ckpt, data, project, **kw):
    """The JAX test CLI's options (its main parses sys.argv)."""
    opt = dict(weights=ckpt, cfg=None, data=data, img_size=SIZE, batch_size=2,
               conf_thres=0.001, iou_thres=0.65, max_labels=16, workers=1, task="val",
               half=False, augment=False, no_rect=False, no_fuse=False, single_cls=False,
               save_json=False, save_txt=False, save_hybrid=False, save_conf=False,
               v5_metric=False, verbose=False, plots=False, project=project, name="exp",
               exist_ok=False)
    opt.update(kw)
    return types.SimpleNamespace(**opt)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "no_fuse"])
def test_cli_test_matches_jax(eval_case, tmp_path, capsys, fuse):
    """`cli/test.py --device cpu` and the JAX CLI on one checkpoint: P, R,
    mAP@.5, mAP@.5:.95 within 1e-3 (the limit of
    tests/test_torch_port_eval.py), the same images and output line
    format."""
    ckpt, data = eval_case
    want = jcli_test.run_eval(_jax_opt(ckpt, data, str(tmp_path / "j"), no_fuse=not fuse))
    jline = capsys.readouterr().out.strip().splitlines()[-1]
    got = cli_test.main(["--weights", ckpt, "--data", data, "--img-size", str(SIZE),
                         "--batch-size", "2", "--max-labels", "16", "--device", "cpu",
                         "--project", str(tmp_path / "p")] + ([] if fuse else ["--no-fuse"]))
    pline = capsys.readouterr().out.strip().splitlines()[-1]
    assert got["seen"] == want["seen"] == 4
    assert 0.05 < want["map50"] < 0.999, want["map50"]
    for key in ("mp", "mr", "map50", "map"):
        assert abs(got[key] - want[key]) <= 1e-3, (key, got[key], want[key])
    assert pline.split(" (")[0].split()[0] == jline.split(" (")[0].split()[0]
    assert [w.split("=")[0] for w in pline.split()[:5]] == \
        [w.split("=")[0] for w in jline.split()[:5]]


# (options, exception, match). Training on several devices, --no-sync-bn,
# --evolve, the device-augment tail, --bbox_interval, the layout passes
# (split_concat, fast_stem), test --augment, --plots and --task study are
# ported: their
# cases hold the errors those options raise (a global batch that does not
# divide over the devices, fewer cards visible than --devices asks for) or
# show the option reaching training or evaluation, which then fails on the
# missing file "x" or "y".
REFUSED_TRAIN = {
    "n_data_devices": (dict(n_data_devices=2, batch_size=3), ValueError,
                       "batch 3 does not divide over 2"),
    "device_aug": (dict(device_aug=True), FileNotFoundError, "'x'"),
    "bbox_interval": (dict(bbox_interval=1), FileNotFoundError, "'x'"),
    "split_concat": (dict(split_concat=True), FileNotFoundError, "'x'"),
    "fast_stem": (dict(fast_stem=True), FileNotFoundError, "'x'"),
}
REFUSED_CLI = {
    "train_evolve": (cli_train, ["--cfg", "x", "--data", "y", "--evolve", "--device", "cpu"],
                     FileNotFoundError, "'y'"),
    "train_devices": (cli_train, ["--cfg", "x", "--data", "y", "--devices", "2"],
                      RuntimeError, "needs 2 CUDA devices; 0 are visible"),
    "train_no_sync_bn": (cli_train, ["--cfg", "x", "--data", "y", "--no-sync-bn", "--device",
                                     "cpu", "--devices", "2", "--batch-size", "5"],
                         ValueError, "batch 5 does not divide over 2"),
    "test_augment": (cli_test, ["--weights", "x", "--data", "y", "--augment"],
                     FileNotFoundError, "'y'"),
    "test_plots": (cli_test, ["--weights", "x", "--data", "y", "--plots"],
                   FileNotFoundError, "'y'"),
    "test_study": (cli_test, ["--weights", "x", "--data", "y", "--task", "study"],
                   FileNotFoundError, "'y'"),
}


@pytest.mark.parametrize("case", sorted(REFUSED_TRAIN) + sorted(REFUSED_CLI))
def test_unported_options_raise(case, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if case in REFUSED_TRAIN:
        kw, exc, match = REFUSED_TRAIN[case]
        with pytest.raises(exc, match=match):
            trainer.train(trainer.TrainConfig(cfg="x", save_dir=str(tmp_path), device="cpu",
                                              **kw))
    else:
        mod, argv, exc, match = REFUSED_CLI[case]
        with pytest.raises(exc, match=match):
            mod.main(argv + (["--project", str(tmp_path)] if mod is cli_train else []))


def test_entry_points_need_a_card_unless_cpu(shapes_set, weights, tmp_path, monkeypatch):
    """Without `--device cpu` the trainer and both CLIs take the card, and
    raise when none is visible."""
    _, data, cfg = shapes_set
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.train(trainer.TrainConfig(cfg=cfg, data=data, save_dir=str(tmp_path / "t")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_train.main(["--cfg", cfg, "--data", data, "--project", str(tmp_path / "r")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_test.main(["--weights", weights, "--data", data, "--img-size", str(SIZE),
                       "--project", str(tmp_path / "e")])


def test_options_run_on_the_cpu(shapes_set, weights, tmp_path, monkeypatch):
    """quad (loss x 4, 2x images), multi-scale buckets past a zero warmup,
    accumulation to nbs 8 with the warmup ramp off, Adam, image weights,
    rect off, nosave: the run finishes with finite losses and only the
    final checkpoint."""
    root, data, cfg = shapes_set
    tc = trainer.TrainConfig(
        cfg=cfg, data=data, epochs=2, batch_size=4, img_size=64, nominal_batch_size=8,
        weights=weights, save_dir=str(tmp_path / "exp"), compute_dtype=torch.float32,
        max_labels=16, noval=True, quad=True, multi_scale=True, warmup_min_steps=0,
        hyp={"warmup_epochs": 0}, warmup_accumulate=False, adam=True, image_weights=True,
        nosave=True, autoanchor=False, device="cpu")
    seen = []
    real = trainer.make_train_step

    def spy(*a, **kw):
        seen.append((kw["accumulate"], kw["resize_to"], kw["loss_scale"]))
        return real(*a, **kw)

    monkeypatch.setattr(trainer, "make_train_step", spy)
    # the two training images four times over: two quad batches an epoch
    ds = trainer.DetectionDataset([str(root / "train" / "images")] * 4, img_size=64,
                                  augment=True, seed=0)
    out = trainer.train(tc, train_ds=ds)
    assert [r["epoch"] for r in out["results"]] == [0, 1]
    assert all(np.isfinite(r["train/total"]) for r in out["results"])
    assert {a for a, _, _ in seen} == {2} and {s for _, _, s in seen} == {4.0}
    assert {r for _, r, _ in seen} <= {32, 64, 96}   # quad feeds 128 px, the buckets resize
    assert sorted(p.name for p in (Path(out["save_dir"]) / "weights").iterdir()) == \
        ["epoch_001.ckpt", "last.ckpt"]
    assert out["train_state"].opt_state["t"] == out["train_state"].step
