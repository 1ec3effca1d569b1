"""The port's TTA in evaluation against the JAX package on the CPU:
`evaluate(augment=True)` on rect batches, and the detect and test CLIs
with --augment on one JAX-written checkpoint (the functions themselves and
the Detector: tests/test_torch_port_tta.py)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_port_eval import eval_setup  # noqa: F401 (a fixture)
from tests.test_torch_port_trainer import _jax_opt, eval_case  # noqa: F401 (a fixture)
from yolo_series_tpu.cli import detect as jcli_detect
from yolo_series_tpu.cli import test as jcli_test
from yolo_series_tpu.eval import evaluator as jev
from yolo_series_tpu.infer.detector import Detector as JDetector
from yolo_series_tpu_torch.cli import detect as cli_detect
from yolo_series_tpu_torch.cli import test as cli_test
from yolo_series_tpu_torch.eval import evaluator as tev
from yolo_series_tpu_torch.infer.detector import Detector

torch.set_num_threads(2)


def test_evaluate_tta_matches_jax(eval_setup):  # noqa: F811
    """evaluate(augment=True) over two rect batches (128 x 128 and 96 x
    128: TTA scales height and width apart): P, R, mAP@.5 and mAP@.5:.95
    within 1e-3 of JAX's, the limit of tests/test_torch_port_eval.py (P and
    R are read at a confidence the fp32 scores place: 1e-6 apart here)."""
    plan, jp, js, tplan, tp, ts, batches = eval_setup
    want = jev.evaluate(plan, jp, js, batches, augment=True)
    got = tev.evaluate(tplan, tp, ts, batches, augment=True, device="cpu")
    assert 0.0 < want["map50"] < 1.0
    for key in ("mp", "mr", "map50", "map"):
        assert abs(got[key] - want[key]) <= 1e-3, (key, got[key], want[key])
    plain = tev.evaluate(tplan, tp, ts, batches, device="cpu")
    assert plain["map50"] != got["map50"] or plain["mp"] != got["mp"]


def _read_txt(d):
    return {p.name: np.array([[float(v) for v in ln.split()]
                              for ln in p.read_text().splitlines()])
            for p in sorted(Path(d).glob("*.txt"))}


def test_cli_detect_and_test_augment_match_jax(eval_case, tmp_path, capsys,  # noqa: F811
                                               monkeypatch):
    """One JAX-written checkpoint (yolov7 training form at width 0.25,
    livened) through both CLIs with --augment. detect, with both CLIs'
    Detectors made fp32 (their bf16 differs between the packages by more
    than a row comparison can hold): the same label files, rows within
    _same_rows's limits (xywh normalized: 1e-4 relative and 2e-4 on the
    score). test (fp32): P, R, mAP@.5, mAP@.5:.95 within 1e-3, the limit
    of test_torch_port_trainer's CLI test."""
    import yolo_series_tpu.infer.detector as jdet_mod
    import yolo_series_tpu_torch.infer.detector as tdet_mod

    class JDetector32(JDetector):
        def __init__(self, *a, **k):
            super().__init__(*a, dtype=jnp.float32, **k)

    class Detector32(Detector):
        def __init__(self, *a, **k):
            super().__init__(*a, dtype=torch.float32, **k)

    monkeypatch.setattr(jdet_mod, "Detector", JDetector32)
    monkeypatch.setattr(tdet_mod, "Detector", Detector32)
    ckpt, data = eval_case
    src = str(Path(data).parent / "images")
    common = ["--weights", ckpt, "--source", src, "--img-size", "128", "--augment",
              "--save-txt", "--save-conf", "--nosave", "--name", "exp"]
    jcli_detect.detect(jcli_detect.make_parser().parse_args(
        common + ["--project", str(tmp_path / "jd")]))
    save_dir = cli_detect.main(common + ["--project", str(tmp_path / "pd"), "--device", "cpu"])
    want = _read_txt(tmp_path / "jd" / "exp" / "labels")
    got = _read_txt(Path(save_dir) / "labels")
    assert sorted(got) == sorted(want) and want
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        np.testing.assert_allclose(g[:, 1:5], w[:, 1:5], rtol=1e-4, atol=2e-4)
        np.testing.assert_allclose(g[:, 5], w[:, 5], rtol=0, atol=2e-4)

    jres = jcli_test.run_eval(_jax_opt(ckpt, data, str(tmp_path / "jt"), augment=True))
    capsys.readouterr()
    pres = cli_test.main(["--weights", ckpt, "--data", data, "--img-size", "128",
                          "--batch-size", "2", "--max-labels", "16", "--augment",
                          "--device", "cpu", "--project", str(tmp_path / "pt")])
    assert pres["seen"] == jres["seen"] == 4
    for key in ("mp", "mr", "map50", "map"):
        assert abs(pres[key] - jres[key]) <= 1e-3, (key, pres[key], jres[key])
