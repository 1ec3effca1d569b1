"""The port stands alone: it imports no jax and no module of the JAX package,
and its entry points refuse to fall back to the CPU silently."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "yolo_series_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in PKG.rglob("*.py"))


def test_every_module_imports_without_jax():
    """Import every port module in a fresh interpreter (tests/conftest.py has
    already imported jax into this one) and check that neither jax nor any
    module of `yolo_series_tpu` was loaded."""
    code = ("import sys\n"
            f"for m in {MODULES!r}: __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'yolo_series_tpu' or "
            "m.startswith('yolo_series_tpu.'))\n"
            "print('LOADED', bad)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout
    assert len(MODULES) >= 15, MODULES
    # the train step's modules, the loader, trainer and CLIs, the aux loss,
    # the .pt bridge, the data-parallel layer, evolution, TTA, the hub, the
    # export CLI, the device-augment tail, the long-tail blocks, the bin and
    # ranking losses are among those imported
    assert {f"yolo_series_tpu_torch.{m}" for m in (
        "losses", "losses.targets", "losses.yolo_loss", "losses.ota", "losses.aux_ota",
        "models.torch_import", "models.torch_export", "train.optim",
        "train.schedules", "train.ema", "train.step", "utils.general", "data.parsers",
        "data.augment", "data.datasets", "eval.coco_eval", "cli.test", "models.convert",
        "train.checkpoints", "utils.autoanchor", "obs.loggers", "obs.artifacts",
        "train.trainer", "cli.train", "parallel", "parallel.dist",
        "train.evolve", "hub", "models.tta", "cli.export", "data.device_aug",
        "models.extra", "models.attention", "losses.bin", "losses.bin_ota",
        "losses.ranking")} <= {
        m.removesuffix(".__init__") for m in MODULES}


_FORBIDDEN = re.compile(
    r"^\s*(import jax|from jax|import yolo_series_tpu(\.|\s|$)"
    r"|from yolo_series_tpu(\.|\s))", re.M)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")] + ["chip_smoke.py"]))
def test_source_has_no_jax_import(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(text), path


def test_entry_points_raise_without_cuda(monkeypatch):
    from yolo_series_tpu_torch.device import device
    from yolo_series_tpu_torch.infer.serving import ServingEngine
    from yolo_series_tpu_torch.models.model import Model
    from yolo_series_tpu_torch.train.optim import OptimConfig
    from yolo_series_tpu_torch.train.step import init_train_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model.from_yaml(str(PKG / "models/cfg/deploy/yolov7.yaml"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(None, None, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state({"layers": []}, {"layers": []}, OptimConfig())
    assert device("cpu") == torch.device("cpu")


def test_kernel_wrappers_take_plain_version_only_on_cpu():
    """A CPU tensor runs the plain version and counts no launch; a tensor on
    another device is refused rather than silently computed."""
    from yolo_series_tpu_torch.ops import nms_keep

    before = nms_keep.nms_keep_mask.launches
    boxes = torch.tensor([[[0, 0, 10, 10], [1, 1, 10, 10], [50, 50, 60, 60]]],
                         dtype=torch.float32)
    keep = nms_keep.nms_keep_mask(boxes, torch.ones((1, 3), dtype=torch.bool), 0.45)
    assert keep.tolist() == [[True, False, True]]
    assert nms_keep.nms_keep_mask.launches == before
    with pytest.raises(ValueError):
        nms_keep.nms_keep_mask(boxes.to("meta"),
                               torch.ones((1, 3), dtype=torch.bool, device="meta"),
                               0.45)
    np.testing.assert_array_equal(keep.numpy(), [[True, False, True]])
