"""Mean host milliseconds of a `ServingEngine.infer_async` call (staging,
copy, replay, clone enqueued), by the harness's span (kind "batch")."""


def read(r):
    d = r["spans"].get("infer_async")
    if r.get("kind") != "batch" or not d:
        return None
    return 1e3 * sum(d) / len(d)
