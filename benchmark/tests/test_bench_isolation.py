"""What the benchmark loads: nothing of JAX or the JAX package anywhere in
a run's process, and nothing of the program in the reference."""

import ast
import json
import subprocess
import sys

from benchmark.harness import common

HARNESS = ["benchmark.run", "benchmark.readings", "benchmark.harness.common",
           "benchmark.harness.compare", "benchmark.harness.flops", "benchmark.harness.port",
           "benchmark.harness.serve", "benchmark.harness.trace", "benchmark.harness.traffic",
           "benchmark.harness.train"]
REFERENCE = ["benchmark.reference.yolo", "benchmark.reference.ota",
             "benchmark.reference.train"]
# everything of the program that the harness's port boundary imports
PROGRAM = ["yolo_series_tpu_torch.models.graph", "yolo_series_tpu_torch.models.torch_import",
           "yolo_series_tpu_torch.models.torch_export", "yolo_series_tpu_torch.models.reparam",
           "yolo_series_tpu_torch.infer.serving", "yolo_series_tpu_torch.infer.quant",
           "yolo_series_tpu_torch.losses.ota", "yolo_series_tpu_torch.losses.yolo_loss",
           "yolo_series_tpu_torch.train.optim", "yolo_series_tpu_torch.train.schedules",
           "yolo_series_tpu_torch.train.step", "yolo_series_tpu_torch.train.trainer"]


def _loaded(modules):
    code = ("import json, sys\n" + "".join(f"import {m}\n" for m in modules)
            + "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT, capture_output=True,
                         text=True, timeout=240, env={"PATH": "/usr/bin:/bin",
                                                      "USE_FLAX": "0", "HOME": "/nonexistent"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_by_whole_top_level_name():
    tops = _loaded(HARNESS + REFERENCE + PROGRAM)
    assert "yolo_series_tpu_torch" in tops           # the port is not the JAX package
    assert not tops & set(common.FORBIDDEN), tops & set(common.FORBIDDEN)


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "yolo_series_tpu_torch_like", sys)
    assert "yolo_series_tpu_torch_like" not in common.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake_sub", sys)
    assert "jaxlib" in common.forbidden_modules()


def test_the_reference_imports_nothing_of_the_program():
    tops = _loaded(REFERENCE)
    assert "yolo_series_tpu_torch" not in tops and not tops & set(common.FORBIDDEN)
    for path in (common.BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("yolo_series_tpu_torch", "yolo_series_tpu",
                                               "jax", "jaxlib", "flax"), (path, n)
                assert not n.startswith("benchmark.harness"), (path, n)
