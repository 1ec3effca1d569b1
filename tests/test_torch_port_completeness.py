"""The port covers the JAX package: every module of `yolo_series_tpu/` has
its counterpart of the same path in `yolo_series_tpu_torch/`, every public
top-level name (function, class, assignment) of a JAX module is defined in
its counterpart, and every JAX tool under tools/ has its `tools/torch_*`
counterpart, save the rows of the tables below, each with its reason.
Both packages are parsed with `ast`; neither is imported."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "yolo_series_tpu", ROOT / "yolo_series_tpu_torch"

# JAX module -> the port's modules that hold its work instead
MODULES_ELSEWHERE = {
    "ops/pallas_nms.py": ("ops/nms_keep.py",),      # K1 (csrc/nms_keep.cu)
    "ops/pallas_stem.py": ("ops/fused_stem.py",),   # K2 (csrc/conv_silu.cu)
    "ops/pallas_elan.py": ("ops/fused_elan.py",),   # K3 (csrc/conv_silu.cu)
    "ops/pallas_int8.py": ("ops/int8_mm.py",),      # K4, K4b (csrc/int8_mm.cu)
}
# (JAX module, name) -> ("module" or "module:name" of the port that holds
# it, or None, reason)
NAMES_ELSEWHERE = {
    ("models/layers.py", "Params"): (None, "a type alias (Dict[str, Any]) for annotations"),
    ("models/layers.py", "State"): (None, "a type alias (Dict[str, Any]) for annotations"),
    ("ops/nms.py", "nms_keep_mask"): ("ops/nms_keep.py:nms_keep_mask_large",
                                      "the tiled keep-mask above 1024 rows is K1L"),
    ("ops/nms.py", "nms_keep_mask_full"): ("ops/nms_keep.py:nms_keep_mask_plain",
                                           "the whole-matrix keep-mask is K1's plain version"),
    ("parallel/mesh.py", "host_local_slice"): ("parallel/dist.py", "the process layer"),
    ("parallel/mesh.py", "init_distributed"): ("parallel/dist.py", "the process layer"),
    ("parallel/mesh.py", "sync_processes"): ("parallel/dist.py", "the process layer"),
    ("parallel/mesh.py", "batch_sharding"): (
        None, "a jax.sharding placement: the port's ranks hold their slice of the batch "
        "(parallel/dist.host_local_slice), and a grid row its slice (ShardedServingEngine)"),
    ("parallel/mesh.py", "replicated"): (
        None, "a jax.sharding placement: each rank holds a replica "
        "(parallel/dist.broadcast_tensors)"),
    ("parallel/mesh.py", "shard_batch"): (
        None, "a jax.device_put over the mesh: each rank loads its own slice "
        "(data/datasets.create_loader(shard=))"),
    ("parallel/mesh.py", "global_batch_from_host_local"): (
        None, "assembles one global jax.Array: the port's ranks keep their slices"),
}
# JAX tools with no tools/torch_* counterpart: each a TPU experiment or bench
# whose card counterpart is a chip_smoke.py phase or tools/ab_torch_fused.py
TOOLS_NOT_CARRIED = {
    "_merge_w6_kernels.py": "merges TPU KERNELS.json rows; K3 on w6 is chip_smoke.py phase 9",
    "bench_int8.py": "XLA int8 lowering probe; K4 against torch._int_mm is ab_torch_fused.py",
    "bench_int8_pallas.py": "the Pallas matmul bench (K4b); K4b is chip_smoke.py and "
                            "ab_torch_fused.py",
    "bench_kernels.py": "XLA compiler-drift gate of the Pallas rewrites; the port's is "
                        "ab_torch_fused.py",
    "bench_loader.py": "loader throughput; chip_smoke.py phase 8 times the port's loader",
    "bench_loader_stages.py": "loader stage model; chip_smoke.py phase 8 splits decode and "
                              "sample",
    "bench_train_pipeline.py": "loader + device aug + step; chip_smoke.py phases 8 and 12 (f)",
    "bench_zoo.py": "zoo serving on a TPU; chip_smoke.py phases 11 and 14",
    "exp_bn_cost.py": "a TPU BN-cost probe; phase 7's profile splits the step's BN",
    "exp_int8_serve.py": "TPU bf16 against int8 serving; chip_smoke.py phase 4b",
    "exp_multiscale.py": "TPU multi-scale bucketing A/B",
    "exp_split_concat.py": "TPU split_concat A/B; chip_smoke.py phase 15 (b)",
    "exp_stem.py": "TPU stem micro-experiments; K2 is chip_smoke.py phase 3",
    "exp_train_mfu.py": "TPU train-step MFU experiments; chip_smoke.py phases 7 and 15",
    "profile_trace.py": "an XLA TPU trace; chip_smoke.py profiles with torch.profiler",
    "train_accuracy_compare.py": "trains the reference and JAX to accuracy on a TPU host",
    "client.py": "imports neither package: the HTTP client of both servers",
}


def _public_names(path: Path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                elts = t.elts if isinstance(t, ast.Tuple) else [t]
                out |= {e.id for e in elts if isinstance(e, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_")}


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("module", JAX_MODULES)
def test_module_has_its_counterpart(module):
    """The JAX module's path exists in the port (or its work lives in the
    listed port modules), and each of its public names is defined there or
    in the module its table row names."""
    homes = MODULES_ELSEWHERE.get(module, (module,))
    for h in homes:
        assert (PORT_PKG / h).exists(), f"{module}: no {h} in the port"
    if module in MODULES_ELSEWHERE:
        return
    have = _public_names(PORT_PKG / module)
    for name in sorted(_public_names(JAX_PKG / module) - have):
        row = NAMES_ELSEWHERE.get((module, name))
        assert row is not None, f"{module}: {name} has no counterpart in the port"
        where, reason = row
        assert reason
        if where is not None:
            path, _, other = where.partition(":")
            assert (other or name) in _public_names(PORT_PKG / path), f"{module}: {name}"


def test_tables_hold_no_stale_rows():
    """Each exception row is still needed: its name is missing from the
    counterpart, and each not-carried tool is a JAX tool without one."""
    for (module, name), _ in NAMES_ELSEWHERE.items():
        assert name in _public_names(JAX_PKG / module)
        assert name not in _public_names(PORT_PKG / module)
    for module in MODULES_ELSEWHERE:
        assert (JAX_PKG / module).exists() and not (PORT_PKG / module).exists()
    for tool in TOOLS_NOT_CARRIED:
        assert (ROOT / "tools" / tool).exists()
        assert not (ROOT / "tools" / f"torch_{tool}").exists()


@pytest.mark.parametrize("tool", sorted(
    p.name for p in (ROOT / "tools").glob("*.py")
    if not p.name.startswith("torch_") and p.name != "ab_torch_fused.py"))
def test_tool_has_its_counterpart(tool):
    """A JAX tool has tools/torch_<name>, or a row of TOOLS_NOT_CARRIED."""
    assert (ROOT / "tools" / f"torch_{tool}").exists() or tool in TOOLS_NOT_CARRIED, tool
