"""The port's trainer on several devices on the CPU (2 gloo ranks): a
tiny shapes set (yolov7 training form at width 0.25, 128 px, a global batch
of 4, nbs 4: one optimizer step an epoch; the hyp's augmentation off, so
the 2 ranks' global batch is the one-process batch). In fp32,
`train(n_data_devices=2)` against the one-process run, and a run resumed
on another number of devices (1 -> 2 ranks and 2 -> 1) against the run it
continues. Through `cli/train.py --device cpu --devices 2` (bf16, as the
CLI trains): rank 0 alone validates and writes the run directory, and the
checkpoints read back in the JAX package."""

import dataclasses
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from tests._torch_port_util import rel_l2, training_cfg
from tests.test_torch_port_train import STEP_STATE_REL, STEP_UPDATE_L2
from tests.test_torch_port_trainer import LOSS_RTOL, _write_set
from yolo_series_tpu.train import checkpoints as jck
from yolo_series_tpu.train import optim as joptim
from yolo_series_tpu_torch.cli import train as cli_train
from yolo_series_tpu_torch.train import checkpoints as ck
from yolo_series_tpu_torch.train import trainer

torch.set_num_threads(2)

SIZE, NC, WIDTH = 128, 3, 0.25
# every augmentation off: each sample is its letterboxed image, warped by a
# fixed scale (the warp draws its scale from U(1 - scale, 1.1 + scale), the
# reference's bound: scale -0.05 pins it at 1.05)
HYP = {"mosaic": 0.0, "mixup": 0.0, "paste_in": 0.0, "copy_paste": 0.0, "hsv_h": 0.0,
       "hsv_s": 0.0, "hsv_v": 0.0, "degrees": 0.0, "translate": 0.0, "scale": -0.05,
       "shear": 0.0, "perspective": 0.0, "flipud": 0.0, "fliplr": 0.0}
# a spawned run of 2 epochs takes ~30 s here: one still running after this
# long has hung, and is killed
SPAWN_TIMEOUT_S = 600


@pytest.fixture(scope="module")
def shapes_set(tmp_path_factory):
    """Four training and two validation images, data.yaml, the hyp and the
    model cfg."""
    root = tmp_path_factory.mktemp("pshapes")
    _write_set(root / "train", 4, 17, ((96, 128), (128, 112)))
    _write_set(root / "val", 2, 18, ((120, 160), (128, 128)))
    data = root / "data.yaml"
    data.write_text(yaml.dump({"train": str(root / "train" / "images"),
                               "val": str(root / "val" / "images"),
                               "nc": NC, "names": ["a", "b", "c"]}))
    (root / "hyp.yaml").write_text(yaml.dump(HYP))
    cfg = root / "model.yaml"
    cfg.write_text(yaml.dump(training_cfg(WIDTH, nc=NC)))
    return root


def _train(tc):
    """trainer.train with a spawn timeout."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "SPAWN_TIMEOUT_S", SPAWN_TIMEOUT_S)
        return trainer.train(tc)


@pytest.fixture(scope="module")
def runs(shapes_set, tmp_path_factory):
    """2 epochs in fp32 on the CPU without validation, in one process and
    on 2 ranks."""
    tmp = tmp_path_factory.mktemp("pruns")
    return tuple(_train(trainer.TrainConfig(
        cfg=str(shapes_set / "model.yaml"), data=str(shapes_set / "data.yaml"),
        hyp=str(shapes_set / "hyp.yaml"), epochs=2, batch_size=4, nominal_batch_size=4,
        img_size=SIZE, max_labels=16, noval=True, save_dir=str(tmp / f"run{n}"),
        compute_dtype=torch.float32, device="cpu", n_data_devices=n)) for n in (1, 2))


@pytest.fixture(scope="module")
def cli_run(shapes_set, tmp_path_factory):
    """`cli/train.py --device cpu --devices 2`, 2 epochs with validation."""
    root = shapes_set
    argv = ["--cfg", str(root / "model.yaml"), "--data", str(root / "data.yaml"),
            "--hyp", str(root / "hyp.yaml"), "--epochs", "2", "--batch-size", "4",
            "--nbs", "4", "--img-size", str(SIZE), "--max-labels", "16", "--device", "cpu",
            "--project", str(tmp_path_factory.mktemp("pcli")), "--devices", "2"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "SPAWN_TIMEOUT_S", SPAWN_TIMEOUT_S)
        return cli_train.main(argv)


def _blob(out, name):
    return ck.load_checkpoint(Path(out["save_dir"]) / "weights" / name)


def _leaves(tree):
    return [np.asarray(a, np.float64) for a in jax.tree_util.tree_leaves(tree)]


def _same_step(got, want, before_v, what):
    """Two checkpoints of one step: the BN state and its EMA within
    STEP_STATE_REL (relative L2 of the tree), the momentum buffer within
    STEP_UPDATE_L2 of the reference's update (at warmup step 0 the weights'
    lr is 0 and the buffer holds the step's whole gradient; the params are
    kept in fp16, below the update's size), the params within one fp16
    rounding."""
    assert got["step"] == want["step"] and got["epoch"] == want["epoch"], what
    for k in ("state", "ema_state"):
        assert rel_l2(got[k], want[k]) <= STEP_STATE_REL, (what, k)
    err = rel_l2(got["opt_state"]["v"], want["opt_state"]["v"], before_v)
    assert err <= STEP_UPDATE_L2, (what, err)
    for a, b in zip(_leaves(got["params"]), _leaves(want["params"])):
        assert np.abs(a - b).max() <= 2 ** -10 * max(np.abs(b).max(), 1.0), what


def _same_losses(got_row, want_row, what):
    for k in ("box", "obj", "cls", "total"):
        np.testing.assert_allclose(got_row[f"train/{k}"], want_row[f"train/{k}"],
                                   rtol=LOSS_RTOL, err_msg=f"{what} {k}")


def test_two_ranks_first_step_matches_one_process(runs):
    """The 2-rank run's first optimizer step (epoch_000.ckpt) against the
    one-process run's, and the losses of both epochs (the trainer's limits,
    tests/test_torch_port_trainer.py); every loss finite."""
    one, two = runs
    zero = jax.tree_util.tree_map(np.zeros_like, _blob(one, "epoch_000.ckpt")["opt_state"]["v"])
    _same_step(_blob(two, "epoch_000.ckpt"), _blob(one, "epoch_000.ckpt"), zero, "step 1")
    for r1, r2 in zip(one["results"], two["results"]):
        _same_losses(r2, r1, f"epoch {r1['epoch']}")
        assert all(np.isfinite(r2[f"train/{k}"]) for k in ("box", "obj", "cls", "total"))
    assert two["train_state"] is None and two["plan"] is None


def test_rank_zero_alone_writes_and_validates(cli_run):
    """One row an epoch in results.jsonl (each rank would add its own),
    each with rank 0's validation and finite losses; last and best
    stripped; the epoch checkpoints read back in the JAX package
    (restore_train_state), and the final evaluation ran on the validation
    images."""
    two = cli_run
    d = Path(two["save_dir"])
    assert {"hyp.yaml", "opt.yaml", "results.jsonl", "DONE"} <= {p.name for p in d.iterdir()}
    assert len((d / "results.jsonl").read_text().strip().splitlines()) == 2
    assert yaml.safe_load((d / "opt.yaml").read_text())["n_data_devices"] == 2
    assert [r["epoch"] for r in two["results"]] == [0, 1]
    for r in two["results"]:
        assert {"val/map50", "val/map", "val/mp", "val/mr"} <= set(r)
        assert all(np.isfinite(r[f"train/{k}"]) for k in ("box", "obj", "cls", "total"))
    assert two["final_results"]["seen"] == 2
    blob = _blob(two, "last.ckpt")
    assert blob["opt_state"] is None and blob["epoch"] == -1
    for name in ("epoch_000.ckpt", "epoch_001.ckpt"):
        jblob = jck.load_checkpoint(d / "weights" / name)
        jts = jck.restore_train_state(jblob, joptim.OptimConfig())
        assert int(jts.step) == int(name[6:9]) + 1
    assert sorted(p.name for p in (d / "weights").iterdir()) == sorted(
        ["last.ckpt", "epoch_000.ckpt", "epoch_001.ckpt"]
        + (["best.ckpt"] if (d / "weights" / "best.ckpt").exists() else []))


def _resume(src, run, devices):
    """A copy of the run `src` under `run`, resumed from its epoch_000.ckpt
    on `devices` devices with its opt.yaml's options (as `--resume ...
    --devices N` builds them), in fp32; the resumed run's dict."""
    shutil.copytree(src["save_dir"], run)
    (run / "DONE").unlink()
    saved = yaml.safe_load((run / "opt.yaml").read_text())
    fields = {f.name for f in dataclasses.fields(trainer.TrainConfig)}
    out = _train(trainer.TrainConfig(**{
        **{k: v for k, v in saved.items() if k in fields},
        "resume": str(run / "weights" / "epoch_000.ckpt"), "save_dir": str(run),
        "n_data_devices": devices, "compute_dtype": torch.float32}))
    assert [r["epoch"] for r in out["results"]] == [1]
    assert yaml.safe_load((run / "opt.yaml").read_text())["n_data_devices"] == devices
    return out


@pytest.mark.parametrize("devices", [1, 2])
def test_resume_on_another_number_of_devices(runs, tmp_path, devices):
    """A run's epoch_000.ckpt resumed on the other number of devices: its
    second epoch (epoch_001.ckpt and the loss row) equals that of the same
    checkpoint resumed on the run's own number (a checkpoint keeps the
    params in fp16, so the run's own second epoch, from fp32 params, is
    no reference)."""
    one, two = runs
    src, own = (two, 2) if devices == 1 else (one, 1)
    got = _resume(src, tmp_path / "other", devices)
    want = _resume(src, tmp_path / "own", own)
    before_v = _blob(src, "epoch_000.ckpt")["opt_state"]["v"]
    _same_step(_blob(got, "epoch_001.ckpt"), _blob(want, "epoch_001.ckpt"), before_v,
               f"resumed on {devices}")
    _same_losses(got["results"][0], want["results"][0], f"resumed on {devices}")
