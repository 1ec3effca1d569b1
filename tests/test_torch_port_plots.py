"""The port's plots against the JAX package on the CPU, and the call sites
that draw them: `plot_images` and `plot_skeleton_kpts` (cv2) bit-equal
with JAX's on the same inputs, `output_to_target` / `output_to_keypoint`
equal, each matplotlib plot writing its file (and tolerating empty data
where JAX's does), then `cli/test.py --plots` and `--task study`, the
trainer's mosaics, results plot and `bbox_interval` panels, and
`plot_evolution` over the port's evolve.txt."""

import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml

from tests._torch_port_util import training_cfg
from tests.test_torch_port_trainer import _write_set
from yolo_series_tpu.obs import plots as jplots
from yolo_series_tpu_torch.cli import test as cli_test
from yolo_series_tpu_torch.models.model import Model
from yolo_series_tpu_torch.obs import plots as tplots
from yolo_series_tpu_torch.train import evolve as tevolve
from yolo_series_tpu_torch.train import trainer
from yolo_series_tpu_torch.train.checkpoints import save_checkpoint
from yolo_series_tpu_torch.train.optim import OptimConfig
from yolo_series_tpu_torch.train.step import init_train_state

torch.set_num_threads(2)

SIZE, NC, WIDTH = 128, 3, 0.25


def _batch(rng, b, h, w, m=6):
    """uint8 NHWC RGB images of a non-square size and normalized cls-xywh
    label rows, some masked out."""
    images = rng.integers(0, 256, (b, h, w, 3), np.uint8)
    xy = rng.uniform(0.2, 0.8, (b, m, 2))
    wh = rng.uniform(0.05, 0.3, (b, m, 2))
    labels = np.concatenate([rng.integers(0, 5, (b, m, 1)), xy, wh], -1).astype(np.float32)
    mask = rng.uniform(size=(b, m)) < 0.7
    return images, labels, mask


@pytest.mark.parametrize("b,h,w,max_size,names", [
    (5, 96, 160, 640, None),            # 3 x 3 grid, non-square tiles
    (4, 320, 200, 128, ("a", "b")),     # downscaled tiles, names and a missing name
    (20, 64, 48, 640, None),            # more than max_subplots
])
def test_plot_images_bit_equal_jax(tmp_path, b, h, w, max_size, names):
    """The mosaic array and the written JPEG, bit-equal with JAX's (a
    transposed tile would move every box on a non-square image)."""
    images, labels, mask = _batch(np.random.default_rng(b), b, h, w)
    out = {}
    for side, mod in (("port", tplots), ("jax", jplots)):
        f = tmp_path / f"{side}.jpg"
        out[side] = mod.plot_images(images, labels, mask, fname=str(f), names=names,
                                    max_size=max_size)
        assert f.stat().st_size > 0
    np.testing.assert_array_equal(out["port"], out["jax"])
    assert (tmp_path / "port.jpg").read_bytes() == (tmp_path / "jax.jpg").read_bytes()
    assert out["port"].shape[0] != out["port"].shape[1] or h == w


def test_plot_skeleton_kpts_bit_equal_jax():
    """Keypoints and limbs on a BGR image, with low-confidence and
    off-image points skipped, bit-equal with JAX's; steps 2 and 3."""
    rng = np.random.default_rng(3)
    for steps in (3, 2):
        kpts = np.concatenate([rng.uniform(-20, 200, (17, 2)), rng.uniform(0, 1, (17, 1))],
                              1)[:, :steps].ravel()
        im = rng.integers(0, 256, (180, 240, 3), np.uint8)
        got = tplots.plot_skeleton_kpts(im.copy(), kpts, steps=steps)
        want = jplots.plot_skeleton_kpts(im.copy(), kpts, steps=steps)
        np.testing.assert_array_equal(got, want)
        assert (got != im).any()


def test_output_to_target_and_keypoint_equal_jax():
    rng = np.random.default_rng(4)
    num = np.array([3, 0, 5])
    boxes = rng.uniform(0, 100, (3, 6, 4)).astype(np.float32)
    boxes[..., 2:] += boxes[..., :2]
    scores = rng.uniform(size=(3, 6)).astype(np.float32)
    classes = rng.integers(0, 80, (3, 6))
    kpts = rng.uniform(0, 100, (3, 6, 51)).astype(np.float32)
    np.testing.assert_array_equal(tplots.output_to_target(num, boxes, scores, classes),
                                  jplots.output_to_target(num, boxes, scores, classes))
    got = tplots.output_to_keypoint(num, boxes, scores, classes, kpts)
    np.testing.assert_array_equal(got, jplots.output_to_keypoint(num, boxes, scores,
                                                                 classes, kpts))
    assert got.shape == (8, 58)


def _draw_all(mod, d, empty):
    """Every matplotlib plot of `mod` into d; `empty`: no data."""
    rng = np.random.default_rng(5)
    px = np.linspace(0, 1, 1000)
    nc = 0 if empty else 3
    py = [np.sort(rng.uniform(size=1000))[::-1] for _ in range(nc)]
    ap = rng.uniform(size=(nc, 10))
    mod.plot_pr_curve(px, py, ap, d / "PR_curve.png", names=("a", "b", "c")[:nc])
    mod.plot_mc_curve(px, rng.uniform(size=(max(nc, 1), 1000)), d / "F1_curve.png",
                      names=("a", "b", "c")[:nc], ylabel="F1")
    mod.plot_confusion_matrix(rng.integers(0, 5, (nc + 1, nc + 1)).astype(float), nc, d,
                              names=("a", "b", "c")[:nc])
    mod.plot_lr_scheduler([] if empty else list(np.linspace(0.01, 0.001, 30)), d)
    rows = [] if empty else [{"epoch": i, "train/box": 1.0 / (i + 1), "val/map": 0.1 * i}
                             for i in range(4)]
    mod.plot_results(rows, d)
    if not empty:
        np.savetxt(d / "study_a_b.txt", rng.uniform(size=(5, 10)), fmt="%10.4g")
    mod.plot_study_txt(path=d)
    mod.plot_labels_histogram(np.zeros((0, 5)) if empty else rng.uniform(size=(40, 5)) * 3,
                              nc=3, save_dir=d)


@pytest.mark.parametrize("empty", [False, True], ids=["data", "empty"])
def test_matplotlib_plots_write_their_files_as_jax(tmp_path, empty):
    """Each plot writes the file JAX's writes, with no error on empty data;
    with no rows or no study files, neither package writes one."""
    files = {}
    for side, mod in (("port", tplots), ("jax", jplots)):
        d = tmp_path / side
        d.mkdir()
        _draw_all(mod, d, empty)
        files[side] = sorted(f.name for f in d.iterdir()
                             if f.suffix == ".png" and f.stat().st_size > 0)
    assert files["port"] == files["jax"]
    want = {"PR_curve.png", "F1_curve.png", "confusion_matrix.png", "LR.png", "labels.png"}
    if not empty:
        want |= {"results.png", "study.png"}
    assert set(files["port"]) == want


def test_plot_evolution_over_port_rows(tmp_path):
    """`plot_evolution` over rows the port's evolve appends: the port's
    own `fitness` and `EVOLVE_META`, the same panels as JAX's."""
    rng = np.random.default_rng(6)
    txt = tmp_path / "evolve.txt"
    for _ in range(4):
        hyp = {k: float(rng.uniform(lo, hi)) for k, (_, lo, hi) in tevolve.EVOLVE_META.items()}
        tevolve.append_result(txt, list(rng.uniform(size=4)), hyp)
    for side, mod in (("port", tplots), ("jax", jplots)):
        (tmp_path / side).mkdir()
        out = mod.plot_evolution(txt, save_dir=tmp_path / side)
        assert out.name == "evolve.png" and out.stat().st_size > 0


def test_no_matplotlib_at_import():
    """The port's modules on the serving, eval and train paths (plots
    among them) import without loading matplotlib."""
    code = ("import sys\n"
            "import yolo_series_tpu_torch.obs.plots, yolo_series_tpu_torch.eval.evaluator\n"
            "import yolo_series_tpu_torch.eval.metrics, yolo_series_tpu_torch.infer.serving\n"
            "import yolo_series_tpu_torch.train.trainer, yolo_series_tpu_torch.cli.test\n"
            "import yolo_series_tpu_torch.cli.train, yolo_series_tpu_torch.train.evolve\n"
            "print('MPL', sorted(m for m in sys.modules if m.startswith('matplotlib')))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
    assert "MPL []" in res.stdout, res.stdout


@pytest.fixture(scope="module")
def toy_set(tmp_path_factory):
    """Four training and two validation images (non-square), a data.yaml,
    the model cfg (yolov7 training form, width 0.25) and a checkpoint of
    the port's seeded init."""
    root = tmp_path_factory.mktemp("plots_set")
    _write_set(root / "train", 4, 7, ((96, 128), (128, 112)))
    _write_set(root / "val", 2, 8, ((120, 160), (128, 128)))
    data = root / "data.yaml"
    data.write_text(yaml.dump({"train": str(root / "train" / "images"),
                               "val": str(root / "val" / "images"),
                               "nc": NC, "names": ["a", "b", "c"]}))
    cfg = training_cfg(WIDTH, nc=NC)
    cfg_path = root / "model.yaml"
    cfg_path.write_text(yaml.dump(cfg))
    m = Model.from_yaml(cfg, seed=4, device="cpu")
    ckpt = root / "init.ckpt"
    save_checkpoint(ckpt, init_train_state(m.params, m.state, OptimConfig(), device="cpu"),
                    cfg)
    return root, str(data), str(cfg_path), str(ckpt)


def test_test_cli_plots_and_study(toy_set, tmp_path, monkeypatch):
    """`cli/test.py --plots` writes the first batch's mosaics and the
    confusion matrix into its run directory, as the JAX CLI does;
    `--task study` writes the sweep's rows (one an image size) and
    study.png into --project."""
    _, data, _, ckpt = toy_set
    common = ["--weights", ckpt, "--data", data, "--batch-size", "2", "--device", "cpu"]
    cli_test.main(common + ["--img-size", str(SIZE), "--plots", "--project",
                            str(tmp_path / "p"), "--name", "exp"])
    names = sorted(f.name for f in (tmp_path / "p" / "exp").iterdir())
    assert names == ["confusion_matrix.png", "test_batch0_labels.jpg",
                     "test_batch0_pred.jpg"]
    assert cv2.imread(str(tmp_path / "p" / "exp" / "test_batch0_pred.jpg")) is not None
    monkeypatch.setattr(cli_test, "STUDY_SIZES", (96, 128))
    rows = cli_test.main(common + ["--task", "study", "--project", str(tmp_path / "s")])
    study = tmp_path / "s" / "study_data_init.txt"
    assert len(rows) == 2 and np.loadtxt(study).shape == (2, 10)
    assert (tmp_path / "s" / "study.png").stat().st_size > 0


def test_trainer_writes_mosaics_results_and_bbox_panels(toy_set, tmp_path, monkeypatch):
    """One epoch with `bbox_interval=1`: the first batches' mosaics
    train_batch{0,1}.jpg, results.png, and the val mosaics of the epoch,
    each test_batch*_pred.jpg logged once, as the JAX trainer writes and
    logs them."""
    from yolo_series_tpu_torch.obs import loggers

    _, data, cfg, ckpt = toy_set
    logged = []
    monkeypatch.setattr(loggers.ExperimentLogger, "log_image",
                        lambda self, tag, path, step=0: logged.append((tag, step)))
    save = tmp_path / "run"
    trainer.train(trainer.TrainConfig(
        cfg=cfg, data=data, weights=ckpt, epochs=1, batch_size=2, img_size=SIZE,
        save_dir=str(save), device="cpu", autoanchor=False, warmup_min_steps=1,
        compute_dtype=torch.float32, bbox_interval=1))
    names = {f.name for f in save.iterdir() if f.suffix in (".jpg", ".png")}
    assert names == {"train_batch0.jpg", "train_batch1.jpg", "results.png",
                     "test_batch0_labels.jpg", "test_batch0_pred.jpg"}
    assert logged == [("val/test_batch0_pred", 0)]
