"""The share of the served forward's operations that the program hands to
its conv + SiLU kernel (K2, K3: the rewrites of `ops/fused_stem` and
`ops/fused_elan`): the engine's own count of one batch's operations in the
convs it routes through `conv_silu` (counter `engine.conv_silu_ops`, from
`obs/trace.snapshot()`), over the configuration's frozen deploy count of a
batch, in percent (kind "batch"; None where the program keeps no such
count)."""


def read(r):
    if r.get("kind") != "batch":
        return None
    try:
        from yolo_series_tpu_torch.obs import trace
    except ImportError:
        return None
    ops = trace.snapshot()["counters"].get("engine.conv_silu_ops")
    if not ops:
        return None
    return 100.0 * ops / (r["config"]["counted"]["gflops_deploy"] * 1e9 * r["batch"])
