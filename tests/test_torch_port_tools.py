"""The port's last two user tools against the JAX package's:
`tools/torch_convert_cfg.py` (reference-format cfg -> canonical cfg)
against `tools/convert_cfg.py` on reference-format cfgs written here (the
port's 28 cfgs mapped back through the inverse of `graph._REF_NAMES`, with
`nn.LeakyReLU(0.1)`, `'None'` and `'True'` arguments), and
`tools/torch_resume_runs.py` against `tools/resume_runs.py` on a run tree
written in a temp dir (`--dry-run`: no relaunch)."""

import importlib.util
import pickle
import sys
from pathlib import Path

import pytest
import yaml

from yolo_series_tpu_torch.models.graph import _REF_NAMES, compile_graph

ROOT = Path(__file__).resolve().parents[1]
PORT_CFGS = sorted((ROOT / "yolo_series_tpu_torch/models/cfg").rglob("*.yaml"))
# canonical name -> one reference name
_TO_REF = {}
for ref, canon in _REF_NAMES.items():
    _TO_REF.setdefault(canon, ref)


def _tool(path, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return (_tool("tools/torch_convert_cfg.py", "torch_convert_cfg"),
            _tool("tools/convert_cfg.py", "jax_convert_cfg"),
            _tool("tools/torch_resume_runs.py", "torch_resume_runs"),
            _tool("tools/resume_runs.py", "jax_resume_runs"))


def _to_reference(cfg):
    """A canonical cfg written as the reference writes it: module names as
    `_REF_NAMES` lists them, activation strings as torch modules, None and
    booleans as the strings its eval() reads."""
    def arg(a):
        if a is None:
            return "None"
        if a is True or a is False:
            return str(a)
        if isinstance(a, str) and a.startswith("leaky_relu"):
            return f"nn.LeakyReLU({a.split(':')[1] if ':' in a else '0.01'})"
        if a == "silu":
            return "nn.SiLU()"
        return a

    out = dict(cfg)
    for section in ("backbone", "head"):
        out[section] = [[f, n, _TO_REF.get(m, m), [arg(a) for a in args]]
                        for f, n, m, args in cfg[section]]
    return out


def test_convert_cfg_matches_jax(tools, tmp_path):
    """Every port cfg, in reference form, converts to the same dict with
    both tools; the dict compiles to the original cfg's plan, block for
    block; a row with LeakyReLU, 'None' and 'True' arguments converts as
    JAX's tool converts it; dump() writes YAML that reads back equal."""
    tconv, jconv, _, _ = tools
    n_ref = 0
    for path in PORT_CFGS:
        with open(path) as f:
            cfg = yaml.safe_load(f)
        ref = _to_reference(cfg)
        n_ref += sum(r[2] != c[2] for s in ("backbone", "head")
                     for r, c in zip(ref[s], cfg[s]))
        got = tconv.convert(ref)
        assert got == jconv.convert(ref), path.name
        a, b = compile_graph(got), compile_graph(cfg)
        assert [type(s.block).__name__ for s in a.layers] == \
            [type(s.block).__name__ for s in b.layers], path.name
        assert [s.cout for s in a.layers] == [s.cout for s in b.layers], path.name
    assert n_ref > 100
    extra = {"nc": 80, "anchors": [[10, 13, 16, 30, 33, 23]],
             "backbone": [[-1, 1, "Conv", [32, 3, 1, "None", 1, "nn.LeakyReLU(0.1)"]],
                          [-1, 1, "Conv", [64, 3, 2, "None", 1, "nn.SiLU()"]],
                          [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
                          [[-1, 0], 1, "Concat", [1]]],
             "head": [[-1, 1, "Shortcut", ["True"]],
                      [[-1], 1, "IDetect", ["nc", "anchors"]]]}
    got = tconv.convert(extra)
    assert got == jconv.convert(extra)
    assert got["backbone"][0][3] == [32, 3, 1, None, 1, "leaky_relu:0.1"]
    assert got["head"][0][3] == [True]
    tconv.dump(got, tmp_path / "c.yaml")
    with open(tmp_path / "c.yaml") as f:
        assert yaml.safe_load(f) == got
    src = tmp_path / "ref"
    src.mkdir()
    with open(src / "a.yaml", "w") as f:
        yaml.safe_dump(extra, f)
    tconv.main(["--all", str(src), str(tmp_path / "out")])
    with open(tmp_path / "out" / "a.yaml") as f:
        assert yaml.safe_load(f) == got


def test_resume_runs_matches_jax(tools, tmp_path, capsys):
    """Both tools find the same interrupted runs (a last.ckpt and no DONE),
    in the same order, skipping a finished run; the port's --dry-run
    builds the port's train command and relaunches nothing."""
    _, _, tres, jres = tools
    root = tmp_path / "runs" / "train"
    for name, epoch, done in (("exp", 3, False), ("exp2", 9, True), ("exp3", 0, False)):
        w = root / name / "weights"
        w.mkdir(parents=True)
        with open(w / "last.ckpt", "wb") as f:
            pickle.dump({"epoch": epoch}, f)
        if done:
            (root / name / "DONE").touch()
    got = list(tres.find_interrupted(root))
    assert got == list(jres.find_interrupted(root))
    assert [run.name for _, run in got] == ["exp", "exp3"]
    cmds = tres.main(["--root", str(root), "--dry-run"])
    assert cmds == [[sys.executable, "-m", "yolo_series_tpu_torch.cli.train", "--resume",
                     str(root / n / "weights" / "last.ckpt")] for n in ("exp", "exp3")]
    out = capsys.readouterr().out
    assert "from epoch 3" in out and "from epoch 0" in out and "exp2" not in out
