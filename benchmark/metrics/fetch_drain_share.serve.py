"""The share of the traced window's fetches (`ServingEngine.to_host`) that
left the card with none of the engine's calls still running, in percent:
the program's counters `engine.fetches_drained` over `engine.fetches`,
from `obs/trace.snapshot()` (kind "batch"; None where the program counts
no fetches). 100% by construction while a fetch copies on the stream of
the calls it waits for, as `to_host` does: it tells something only once
the fetch has a stream of its own."""


def read(r):
    if r.get("kind") != "batch":
        return None
    try:
        from yolo_series_tpu_torch.obs import trace
    except ImportError:
        return None
    c = trace.snapshot()["counters"]
    if not c.get("engine.fetches"):
        return None
    return 100.0 * c.get("engine.fetches_drained", 0) / c["engine.fetches"]
