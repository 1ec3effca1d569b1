"""The benchmark's files: names and units, discovery by name, the seeded
generators, and the frozen arithmetic against the configurations' files."""

import json
import re
import shutil

import numpy as np
import pytest

from benchmark.harness import common, flops, traffic
from benchmark.reference.yolo import Net

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_names_units_and_files():
    spec = common.spec()
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]]
    metrics = spec["end_to_end"] + spec["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for n in names + [w["config"] for w in spec["workloads"]] + \
            [w["traffic"] for w in spec["workloads"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
        assert common.reader_path(m["name"]).is_file(), m["name"]
    for m in spec["per_layer"]:
        assert line(m["layer"]) and m["moves"] in {e["name"] for e in spec["end_to_end"]}
    for c in spec["configs"]:
        assert line(c["source"]) and line(c["why"])
        assert (common.ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in spec["workloads"]:
        assert line(w["why"]) and w["chips"] in (1, 4)
        for sub in ("configs", "traffic", "limits"):
            key = {"configs": "config", "traffic": "traffic", "limits": "name"}[sub]
            assert (common.BENCH / sub / f"{w[key]}.json").is_file(), (sub, w)
    for p in common.BENCH.rglob("*"):
        if "__pycache__" not in p.parts:
            assert PATH.match(str(p.relative_to(common.ROOT))), p


def test_a_new_cell_and_metric_are_found_by_name(tmp_path, monkeypatch):
    """A configuration, a mix, a limit file and a metric reader added as
    files, with BENCHMARK.json entries, are found with no edit of the
    harness."""
    root = tmp_path / "checkout"
    shutil.copytree(common.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = common.spec()
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "yolov7.json").read_text())
    cfg["name"] = "yolov7-copy"
    (bench / "configs" / "yolov7-copy.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "serve-b4.json").write_text(json.dumps(
        {"kind": "batch", "batch": 4, "pool": 16, "inflight": 2, "warmup_s": 0.5}))
    (bench / "limits" / "yolov7-copy.serve-b4.json").write_text('{"det_gap": 0.5}')
    (bench / "metrics" / "answers_per_batch.py").write_text(
        "def read(r):\n    return r['images'] / max(r['counters']['batches'], 1)\n")
    spec["configs"].append({"name": "yolov7-copy", "source": "https://example.org/cfg",
                            "file": "benchmark/configs/yolov7-copy.json", "reduced": [],
                            "why": "a copy"})
    spec["workloads"].append({"name": "yolov7-copy.serve-b4", "config": "yolov7-copy",
                              "traffic": "serve-b4", "chips": 1, "why": "batch 4"})
    spec["per_layer"].append({"name": "answers_per_batch", "unit": "img", "better": "higher",
                              "source": "program_counter", "layer": "engine", "moves": "img_per_s",
                              "workloads": ["yolov7-copy.serve-b4"]})
    spec["end_to_end"][0]["workloads"].append("yolov7-copy.serve-b4")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(common, "BENCH", bench)
    monkeypatch.setattr(common, "ROOT", root)
    wl, c, mix = common.cell("yolov7-copy.serve-b4")
    assert c["name"] == "yolov7-copy" and mix["batch"] == 4
    per_layer = [m["name"] for m in common.cell_metrics("yolov7-copy.serve-b4", "per_layer")]
    assert per_layer == ["answers_per_batch"]
    e2e = [m["name"] for m in common.cell_metrics("yolov7-copy.serve-b4", "end_to_end")]
    assert e2e == ["img_per_s", "setup_s"]
    assert common.reader("answers_per_batch")({"images": 80, "counters": {"batches": 20}}) == 4
    # a quantity split by cells needs no reader of its own for a new split
    assert common.reader("idle_share.copy")({"trace": {"window_s": 2.0, "busy_s": 1.5}}) == 25.0


def test_generators_are_seeded():
    a = traffic.frame_pool(2**31 + 7, 3, (16, 24), device="cpu")
    assert a.shape == (3, 16, 24, 3) and a.dtype == np.uint8
    assert np.array_equal(a, traffic.frame_pool(2**31 + 7, 3, (16, 24), device="cpu"))
    assert not np.array_equal(a, traffic.frame_pool(2**31 + 8, 3, (16, 24), device="cpu"))
    t1 = traffic.train_batches(9, 2, 4, 32, 80, 40, 7.3, 0.9, device="cpu")
    t2 = traffic.train_batches(9, 2, 4, 32, 80, 40, 7.3, 0.9, device="cpu")
    t3 = traffic.train_batches(10, 2, 4, 32, 80, 40, 7.3, 0.9, device="cpu")
    for x, y in zip(t1, t2):
        assert all(np.array_equal(u, v) for u, v in zip(x, y))
    counts = lambda t: sorted(int(m.sum()) for _, _, mk in t for m in mk)  # noqa: E731
    assert counts(t1) == counts(t3)               # the same work, in another order
    assert not all(np.array_equal(x[1], y[1]) for x, y in zip(t1, t3))


def test_label_counts_are_heavy_tailed_with_cocos_mean():
    c = traffic.label_counts(128, 7.3, 0.9, 256)
    assert 6.5 < c.mean() < 8.0 and c.min() >= 1 and c.max() >= 3 * np.median(c)


@pytest.mark.parametrize("name", ["yolov7", "yolov7-w6"])
def test_frozen_arithmetic_gives_the_recorded_numbers(name):
    cfg = common.load_json(common.BENCH / "configs" / f"{name}.json")
    net = Net(cfg["cfg_deploy"])
    counted = cfg["counted"]
    assert flops.gflops(net, cfg["img"]) == pytest.approx(counted["gflops_deploy"], abs=1e-6)
    assert flops.params_m(net) == pytest.approx(counted["params_m_deploy"], abs=1e-6)
    # the published parameter count (fused deploy form) within rounding
    assert abs(counted["params_m_deploy"] - cfg["published"]["params_m"]) < 0.06
    if "cfg_training" in cfg:
        t = Net(cfg["cfg_training"])
        assert flops.gflops(t, cfg["img"], "training") == pytest.approx(
            counted["gflops_training"], abs=1e-6)
    k = cfg["kernels"]["conv_silu"]
    bound, ops, nbytes = flops.bound_ms(net, cfg["img"], k["batch"], k["layers"])
    assert bound == pytest.approx(k["bound_ms"], abs=1e-6)
    assert ops == k["ops"] and nbytes == k["bytes"]


def test_taps_inside_the_input():
    # a 3x3 stride-1 pad-1 conv over 4 pixels: 3 + 2 + ... = 2 + 3 + 3 + 2 taps
    assert flops._taps(4, 4, 3, 1, 1) == 10
    assert flops._taps(4, 2, 3, 2, 1) == 5
