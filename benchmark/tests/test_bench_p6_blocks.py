"""The reference and the frozen counts of the P6 models built from E-ELAN
blocks (yolov7-e6, -d6, -e6e): downc and shortcut are known, the cells
already there read what they read before, and an e6e cell is added by new
files and entries alone."""

import hashlib
import json
import shutil

import pytest
import torch
import yaml

from benchmark import run
from benchmark.harness import common, flops
from benchmark.reference import yolo as ref
from benchmark.tests._tiny import tiny

DEPLOY = common.ROOT / "yolo_series_tpu_torch" / "models" / "cfg" / "deploy"

# Net.entries() and the state dict that Net.draw(0, "cpu") makes, as the
# accepted cells' limits were set from them: (entries, sha256 of the
# entries, sha256 of the drawn state dict)
RECORDED = {
    ("yolov7", "cfg_deploy"): (
        558, "c37f91bb218cfbcceb46e60dc8e692f5b7d688536865cdc8aea1af26e6a1eab3",
        "e60c01b8956af9f20dc4a70989aaabda29c9af6304640f8964107c5dc120104a"),
    ("yolov7", "cfg_training"): (
        564, "ffb2c9176354aa1a7091f53234c68f988730d6c34bd3233d176149d0140afab1",
        "5f799a970034f103b41b9a0b9e265643bc45c9e9e9d69af56d13f19e9ada414a"),
    ("yolov7-w6", "cfg_deploy"): (
        626, "85f1f79c2ad21f4bb9bc9b53d9d3ac4da4f2062747d4a7ffc31f167e9fb9bf5e",
        "ca5d40a07c56aeadad92b0305545ba35af505d6e6f96909c3ce719494173497e"),
}

# deploy form at 1280 px: (parameters M, GFLOPs an image) as counted, and
# the README's (params M, GFLOPs) beside them; the counted GFLOPs lie 1.4%
# under the README's, as w6's 355.06 lie under its 360.0
COUNTED = {"yolov7-e6e": (151.68742, 831.613138, (151.7, 843.2)),
           "yolov7-e6": (97.20294, 508.012525, (97.2, 515.2))}


def _deploy(name: str) -> dict:
    return yaml.safe_load((DEPLOY / f"{name}.yaml").read_text())


@pytest.mark.parametrize("name,key", sorted(RECORDED))
def test_existing_cells_draw_what_they_drew(name, key):
    cfg = common.load_json(common.BENCH / "configs" / f"{name}.json")[key]
    net = ref.Net(cfg)
    ent = net.entries()
    n, entries_digest, draw_digest = RECORDED[(name, key)]
    assert len(ent) == n
    assert hashlib.sha256(repr(ent).encode()).hexdigest() == entries_digest
    h = hashlib.sha256()
    for k, t in net.draw(0, "cpu").items():
        h.update(k.encode())
        h.update(repr((tuple(t.shape), str(t.dtype))).encode())
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == draw_digest


@pytest.mark.parametrize("name", sorted(COUNTED))
def test_p6_counts(name):
    net = ref.Net(_deploy(name))
    params, gflops, published = COUNTED[name]
    assert flops.params_m(net) == pytest.approx(params, abs=1e-5)
    assert abs(flops.params_m(net) - published[0]) <= 0.05     # the README's rounding
    assert flops.gflops(net, 1280) == pytest.approx(gflops, abs=1e-6)
    assert 0.98 < flops.gflops(net, 1280) / published[1] < 0.99


def test_downc_counts_its_three_convs_and_its_pool():
    net = ref.Net(_deploy("yolov7-e6"))
    rows = [c for c in flops.convs(net, 1280) if c["layer"] == 2]     # downc [160] of 80
    assert [c["name"] for c in rows] == ["cv1", "cv2", "mp", "cv3"]
    cv1, cv2, mp, cv3 = rows
    assert (cv1["cin"], cv1["cout"], cv1["k"], cv1["hout"]) == (80, 80, 1, 640)
    assert (cv2["cin"], cv2["cout"], cv2["k"], cv2["s"], cv2["hout"]) == (80, 80, 3, 2, 320)
    assert mp["ops"] == 80 * 320 * 320 * 3
    assert (cv3["cin"], cv3["cout"], cv3["hin"], cv3["hout"]) == (80, 80, 320, 320)


@pytest.mark.parametrize("name", ["yolov7-e6", "yolov7-d6", "yolov7-e6e"])
def test_the_reference_builds_the_p6_deploy_cfgs(name):
    net = ref.Net(_deploy(name))
    keys = [k for k, _, _ in net.entries()]
    assert len(keys) == len(set(keys))
    assert "model.2.cv1.conv.weight" in keys and "model.2.cv3.bn.running_var" in keys
    assert net.nl == 4 and net.head["kind"] == "detect"


def test_downc_and_shortcut_forward():
    cfg = {"nc": 1, "anchors": [[10, 13, 16, 30]],
           "backbone": [[-1, 1, "conv", [8, 3, 1]], [-1, 1, "downc", [16]],
                        [-1, 1, "conv", [16, 1, 1]], [[-1, -2], 1, "shortcut", [1]]],
           "head": [[[-1], 1, "detect", ["nc", "anchors"]]]}
    net = ref.Net(cfg)
    assert [L["c2"] for L in net.layers[:4]] == [8, 16, 16, 16]
    sd = net.draw(3, "cpu")
    x = torch.rand(2, 3, 16, 16)
    run_ = ref._Run(sd, "eval", None, None)
    y0 = run_.layer(net.layers[0], [x])
    y1 = run_.layer(net.layers[1], [y0])
    a = run_.conv("model.1.cv2", run_.conv("model.1.cv1", y0, 1, 1), 3, 2)
    b = run_.conv("model.1.cv3", torch.nn.functional.max_pool2d(y0, 2, 2), 1, 1)
    assert y1.shape == (2, 16, 8, 8) and torch.equal(y1, torch.cat([a, b], 1))
    y2 = run_.layer(net.layers[2], [y1])
    assert torch.equal(run_.layer(net.layers[3], [y2, y1]), y2 + y1)
    bad = json.loads(json.dumps(cfg))
    bad["backbone"][2][3][0] = 24
    with pytest.raises(ValueError, match="shortcut"):
        ref.Net(bad)


def _swap_downc_halves(monkeypatch):
    layer = ref._Run.layer

    def swapped(self, L, inp):
        y = layer(self, L, inp)
        if L["kind"] == "downc":
            h = y.shape[1] // 2
            y = torch.cat([y[:, h:], y[:, :h]], 1)
        return y

    monkeypatch.setattr(ref._Run, "layer", swapped)


def _new(path, text):
    assert not path.exists(), path          # a new file, never an edit
    path.write_text(text)


@pytest.mark.parametrize("fault", [None, "alter", "swapped"])
def test_an_e6e_cell_is_added_by_files_and_entries(tmp_path, monkeypatch, fault):
    """An e6e configuration, its limit and a serve-b8 cell, added to a copy
    of the benchmark as new files and BENCHMARK.json entries, run through
    `run.main` at a tiny size: sound, correct; with a served answer altered,
    or with the reference's downc halves swapped, not correct."""
    root = tmp_path / "checkout"
    shutil.copytree(common.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "yolov7-w6.json").read_text())
    deploy = _deploy("yolov7-e6e")
    net = ref.Net(deploy)
    cfg.pop("kernels")                   # no K2/K3 span covers e6e's convs yet
    cfg.update(name="yolov7-e6e", cfg_deploy=deploy,
               source="https://github.com/WongKinYiu/yolov7 (cfg/deploy/yolov7-e6e.yaml)",
               published={"params_m": 151.7, "gflops": 843.2},
               counted={"gflops_deploy": flops.gflops(net, 1280),
                        "params_m_deploy": flops.params_m(net)})
    _new(bench / "configs" / "yolov7-e6e.json", json.dumps(cfg))
    _new(bench / "limits" / "yolov7-e6e.serve-b8.json", '{"det_gap": 0.25}')
    spec = common.spec()
    spec["configs"].append({"name": "yolov7-e6e", "source": cfg["source"],
                            "file": "benchmark/configs/yolov7-e6e.json", "reduced": ["data"],
                            "why": "E-ELAN"})
    cell = "yolov7-e6e.serve-b8"
    spec["workloads"].append({"name": cell, "config": "yolov7-e6e", "traffic": "serve-b8",
                              "chips": 1, "why": "1280 px frames in batches of 8"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "yolov7-w6.serve-b8" in m.get("workloads", []):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(common, "BENCH", bench)
    monkeypatch.setattr(common, "ROOT", root)
    monkeypatch.setattr(common, "check_program", lambda: None)   # the copy holds no program
    assert [m["name"] for m in common.cell_metrics(cell, "end_to_end")] == ["img_per_s",
                                                                            "setup_s"]
    if fault == "swapped":
        _swap_downc_halves(monkeypatch)
    with tiny(monkeypatch):
        r = run.main(["--workload", cell, "--seed", str(2**31 + 5), "--seconds", "2",
                      "--trace", "0"], fault=fault if fault == "alter" else None)
    assert r["metrics"]["img_per_s"]["value"] > 0
    if fault is None:
        assert r["correct"], r["checks"]
    else:
        assert not r["correct"], r["checks"]
