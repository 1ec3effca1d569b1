"""The lower-precision controls on the card, at each cell's own size (its
whole frame pool, its batches): each comes out not correct against the
cell's limits, as `benchmark/readings.py` reads them (PERF.md). The int8
engine fails the serving check by the anchors it leaves unexplained, which
a pool of 16 frames at 640 px, or 320 px frames, may not hold: so the size
is the cell's. Marked `cuda`: each test decides itself whether a card is
there.

    python -m pytest --noconftest -m cuda benchmark/tests/test_bench_control.py -q
"""

import pytest
import torch

from benchmark.harness import common
from benchmark.readings import readings


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is the program's int8 path on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["yolov7.serve-b8", "yolov7-w6.serve-b8"])
def test_serving_control_fails(workload):
    _card()
    limits = common.load_json(common.BENCH / "limits" / f"{workload}.json")
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        r, _ = readings(workload, seed, "control")
        assert any(r[k] > lim for k, lim in limits.items()), r


@pytest.mark.cuda
def test_training_control_fails():
    _card()
    limits = common.load_json(common.BENCH / "limits" / "yolov7.train-b32.json")
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        r, _ = readings("yolov7.train-b32", seed, "control")
        assert any(r[k] > lim for k, lim in limits.items()), r
