"""The share of the traced window's fetches (`ServingEngine.to_host`) that
left the card with none of the engine's calls still running, in percent:
the program's counters `engine.fetches_drained` over `engine.fetches`,
from `obs/trace.snapshot()` (kind "batch"; None where the program counts
no fetches). `to_host` waits for its own batch's event and copies on a
stream of its own, so the calls dispatched after that batch stay queued
and the share is low while the engine keeps batches in flight; a fetch
that waited for the whole stream would read 100%."""


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
