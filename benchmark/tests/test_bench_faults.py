"""Whole runs of the harness at a tiny size on the CPU, its look for a card
skipped: a sound run comes out correct, and a run whose timed path is
broken underneath comes out not correct, once for each fault the cell can
have (an answer altered where it is produced; half of the batch left out;
a step that returns its state unchanged; a learning rate 1.5 times too
large; no momentum)."""

import pytest

from benchmark import run
from benchmark.tests._tiny import tiny


def _run(monkeypatch, workload, fault=None, seconds=3.0):
    with tiny(monkeypatch):
        return run.main(["--workload", workload, "--seed", str(2**31 + 3), "--seconds",
                         str(seconds), "--trace", "0"], fault=fault)


def test_sound_serving_run_is_correct(monkeypatch):
    r = _run(monkeypatch, "yolov7.serve-b8")
    assert r["correct"] and r["metrics"]["img_per_s"]["value"] > 0
    assert r["checks"]["det_gap"]["value"] < r["checks"]["det_gap"]["limit"]


@pytest.mark.parametrize("workload,fault", [("yolov7.serve-b8", "alter"),
                                            ("yolov7.serve-b8", "half"),
                                            ("yolov7-w6.serve-b8", "alter")])
def test_broken_serving_run_is_not_correct(monkeypatch, workload, fault):
    r = _run(monkeypatch, workload, fault)
    assert not r["correct"]


def test_sound_training_updates_follow_sgds_rule(monkeypatch):
    """The program's own updates against SGD-nesterov's rule hold to fp32
    rounding: at this size the worst leaf is the head's bias (about 6.7
    from the objectness prior), whose rounding is 0.4% of its small update.
    The other numbers' limits are set at the cell's size and precision,
    not at this one's."""
    r = _run(monkeypatch, "yolov7.train-b32", seconds=1.0)
    assert r["checks"]["opt_gap"]["value"] < r["checks"]["opt_gap"]["limit"]
    assert r["metrics"]["train_img_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", ["half", "stale", "lr", "momentum"])
def test_broken_training_run_is_not_correct(monkeypatch, fault):
    r = _run(monkeypatch, "yolov7.train-b32", fault, seconds=1.0)
    assert not r["correct"]
