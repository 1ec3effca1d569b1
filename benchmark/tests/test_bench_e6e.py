"""The yolov7-e6e cell: its configuration's frozen counts against the
arithmetic of `harness/flops.py`, the cell run through `run.main` at a tiny
size on the CPU (sound: correct; a served answer altered: not correct), and
on the card the int8 control failing the cell's limits at the cell's own
size (`cuda`; PERF.md has the readings the limits were set from):

    python -m pytest --noconftest -m cuda benchmark/tests/test_bench_e6e.py -q
"""

import pytest
import torch

from benchmark import run
from benchmark.harness import common, flops
from benchmark.readings import readings
from benchmark.reference.yolo import Net
from benchmark.tests._tiny import tiny

CELL = "yolov7-e6e.serve-b8"


def test_e6e_frozen_counts():
    """Deploy GFLOPs and parameters as `flops` counts them (1.4% and 0.01%
    under the README's 843.2 and 151.7), and the conv_silu bound, operations
    and bytes of the 198 span convs listed: 22 spans, each x4, x5, six
    chained 3x3 and the output conv (its concat left out)."""
    cfg = common.load_json(common.BENCH / "configs" / "yolov7-e6e.json")
    net = Net(cfg["cfg_deploy"])
    assert flops.gflops(net, cfg["img"]) == pytest.approx(cfg["counted"]["gflops_deploy"],
                                                          abs=1e-6)
    assert flops.params_m(net) == pytest.approx(cfg["counted"]["params_m_deploy"], abs=1e-6)
    k = cfg["kernels"]["conv_silu"]
    bound, ops, nbytes = flops.bound_ms(net, cfg["img"], k["batch"], k["layers"])
    assert bound == pytest.approx(k["bound_ms"], abs=1e-6)
    assert ops == k["ops"] and nbytes == k["bytes"]
    assert len(k["layers"]) == 198 and k["launches_per_forward"] == 22 * 8
    kinds = [net.layers[i]["kind"] for i in k["layers"]]
    assert set(kinds) == {"conv"}


@pytest.mark.parametrize("fault", [None, "alter"])
def test_e6e_cell_runs_at_a_tiny_size(monkeypatch, fault):
    """The cell through `run.main` on the CPU at a tiny size: correct when
    sound, not correct with a served answer moved to the next class."""
    monkeypatch.setattr(common, "check_program", lambda: None)
    with tiny(monkeypatch):
        r = run.main(["--workload", CELL, "--seed", str(2**31 + 7), "--seconds", "2",
                      "--trace", "0"], fault=fault)
    assert r["metrics"]["img_per_s"]["value"] > 0
    assert r["correct"] == (fault is None), r["checks"]


@pytest.mark.cuda
def test_e6e_control_fails():
    """The int8 control at the cell's size fails the cell's limits on every
    seed read, by at least one key."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is the program's int8 path on the card")
    limits = common.load_json(common.BENCH / "limits" / f"{CELL}.json")
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        r, _ = readings(CELL, seed, "control")
        assert any(r[k] > lim for k, lim in limits.items()), r
