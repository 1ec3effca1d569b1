"""The conv + SiLU kernel's share of its roofline (K2, K3: `ops/fused_stem`,
`ops/fused_elan` -> `ops/conv_silu`): the bound of the convs those spans
cover (the configuration's frozen `kernels.conv_silu.bound_ms` a forward),
times the forwards' worth of launches the trace holds, over the device
time of those launches, in percent (kind "batch")."""


def read(r):
    t = r.get("trace") or {}
    k = r["config"].get("kernels", {}).get("conv_silu")
    if r.get("kind") != "batch" or not t or not k:
        return None
    secs = launches = 0
    for name, (s, n) in t["kernels"].items():
        if any(x in name for x in k["names"]):
            secs += s
            launches += n
    if not launches or not secs:
        return None
    forwards = launches / k["launches_per_forward"]
    return 100.0 * k["bound_ms"] * 1e-3 * forwards / secs
