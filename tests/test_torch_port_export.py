"""The port's hub, export CLI and K4 operator against the JAX package on the
CPU: `hub.create` detects, `hub.custom` gives JAX's rows on one
JAX-written checkpoint, the export CLI's deploy and int8 checkpoints are
read by the JAX Detector and equal JAX's own exports, its `--pt2` program
equals the eager forward bit for bit, and `torch.library.opcheck` passes
on the registered K4 op."""

import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_detect import _same_rows
from tests.test_torch_port_trainer import eval_case  # noqa: F401 (a fixture)
from yolo_series_tpu import hub as jhub
from yolo_series_tpu.cli import export as jexport
from yolo_series_tpu.infer.detector import Detector as JDetector
from yolo_series_tpu.train import checkpoints as jck
from yolo_series_tpu_torch import hub
from yolo_series_tpu_torch.cli import export as cli_export
from yolo_series_tpu_torch.ops import int8_mm
from yolo_series_tpu_torch.train import checkpoints as ck

torch.set_num_threads(2)

SIZE = 128
SHAPES = ((100, 150), (128, 128), (90, 200))


def _images(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*hw, 3), np.uint8) for hw in SHAPES]


def test_hub_create_detects():
    """hub.create on the port's tiny cfg, as tests/test_infer.py drives the
    JAX hub: a Detector whose call gives (n, 6) rows."""
    det = hub.create("yolov7-tiny", img_size=SIZE, device="cpu")
    img = np.random.default_rng(0).integers(0, 255, (160, 200, 3), dtype=np.uint8)
    rows = det(img)
    assert isinstance(rows, np.ndarray) and rows.shape[1] == 6


def test_hub_custom_matches_jax(eval_case):  # noqa: F811
    """hub.custom on a JAX-written checkpoint (fp32 in both, `dtype`
    passing through **kw): the rows of JAX's hub.custom (_same_rows)."""
    ckpt, _ = eval_case
    imgs = _images(1)
    want = jhub.custom(ckpt, img_size=SIZE, dtype=jnp.float32)(imgs)
    got = hub.custom(ckpt, img_size=SIZE, dtype=torch.float32, device="cpu")(imgs)
    assert sum(len(w) for w in want) > 3
    for g, w in zip(got, want):
        _same_rows(g, w)


@pytest.fixture(scope="module")
def exports(eval_case, tmp_path_factory):  # noqa: F811
    """Both export CLIs on copies of one JAX-written checkpoint, plain and
    --int8 calibrated on its 4 val images; the port's with --pt2."""
    ckpt, data = eval_case
    calib = str(Path(data).parent / "images")
    out = {}
    for side in ("jax", "port"):
        d = tmp_path_factory.mktemp(side)
        src = str(d / "w.ckpt")
        shutil.copy(ckpt, src)
        for kind, extra in (("deploy", []), ("int8", ["--int8", "--calib-images", calib])):
            argv = ["--weights", src, "--img-size", str(SIZE), "--batch-size", "1"] + extra
            if side == "jax":
                saved = sys.argv
                sys.argv = ["export"] + argv
                try:
                    jexport.main()
                finally:
                    sys.argv = saved
            else:
                res = cli_export.main(argv + ["--device", "cpu", "--pt2",
                                              str(d / f"{kind}.pt2")])
                assert res["deploy"] == str(d / f"w.{kind}.ckpt")
            out[side, kind] = str(d / f"w.{kind}.ckpt")
        out[side] = d
    return out


def test_export_deploy_read_by_jax(exports):
    """The port's .deploy.ckpt in the JAX format: JAX's Detector reads it
    and gives the rows it gives on JAX's own export (fp32, _same_rows: the
    two packages fold BN in fp32 in another order); the cfg is carried."""
    imgs = _images(2)
    want = JDetector.from_checkpoint(exports["jax", "deploy"], img_size=SIZE,
                                     dtype=jnp.float32)(imgs)
    got = JDetector.from_checkpoint(exports["port", "deploy"], img_size=SIZE,
                                    dtype=jnp.float32)(imgs)
    assert sum(len(w) for w in want) > 3
    for g, w in zip(got, want):
        _same_rows(g, w)
    pb, jb = (jck.load_checkpoint(exports[s, "deploy"]) for s in ("port", "jax"))
    assert pb["format"] == jb["format"] == "yolo-series-tpu-ckpt-v1"
    assert pb["cfg"] == jb["cfg"] and pb["epoch"] == -1


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{path}/{i}")]
    return [(path, np.asarray(tree))]


def test_export_int8_equals_jax(exports):
    """The --int8 trees leaf by leaf: the int8 weights equal; the weight and
    activation scales and biases within 1e-5 relative (the fused weights'
    and the calibration percentiles' fp32 rounding)."""
    got, want = (_leaves(jck.load_checkpoint(exports[s, "int8"])["params"])
                 for s in ("port", "jax"))
    assert [p for p, _ in got] == [p for p, _ in want]
    n_int8 = 0
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if w.dtype == np.int8:
            n_int8 += 1
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7, err_msg=path)
    assert n_int8 > 50


@pytest.mark.parametrize("kind", ["deploy", "int8"])
def test_pt2_program_equals_eager(exports, kind):
    """torch.export.load(...).module() on uint8 frames equals the eager
    forward of the exported checkpoint (`Program`), bit for bit; the int8
    program holds the K4 op as a call."""
    ep = torch.export.load(str(exports["port"] / f"{kind}.pt2"))
    calls = [n for n in ep.graph.nodes
             if n.target == torch.ops.yolo_series_tpu_torch.int8_matmul_dequant.default]
    assert (len(calls) > 0) == (kind == "int8")
    plan, params, state = ck.load_checkpoint_any(exports["port", kind])
    eager = cli_export.Program(plan, params, state, torch.device("cpu"))
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (1, SIZE, SIZE, 3),
                                                           np.uint8))
    got, want = ep.module()(x), eager(x)
    assert got.shape == want.shape and got.shape[:2] == (1, 3 * (16 ** 2 + 8 ** 2 + 4 ** 2))
    assert torch.equal(got, want)


def test_k4_op_opcheck():
    """The registered K4 op: opcheck (schema, fake kernel, autograd
    registration) on a K4 shape, and the plain product through it."""
    g = torch.Generator().manual_seed(0)
    xq = torch.randint(-127, 128, (200, 256), dtype=torch.int8, generator=g)
    wq = torch.randint(-127, 128, (128, 256), dtype=torch.int8, generator=g).t()
    scale, bias = torch.rand(128, generator=g), torch.rand(128, generator=g)
    torch.library.opcheck(int8_mm.int8_matmul_dequant_op, (xq, wq, scale, bias))
    torch.library.opcheck(int8_mm.int8_matmul_dequant_op, (xq, wq, scale, bias, [128, 64]))
    assert torch.equal(int8_mm.int8_matmul_dequant(xq, wq, scale, bias),
                       int8_mm.int8_matmul_dequant_plain(xq, wq, scale, bias))
    with pytest.raises(ValueError, match="multiples of 128"):
        int8_mm.int8_matmul_dequant(xq[:, :200], wq[:200], scale, bias)
