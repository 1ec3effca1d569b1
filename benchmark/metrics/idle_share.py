"""The share of the traced window in which no kernel, copy or memset ran
on the card, in percent: the reader of every `idle_share.<cells>`."""


def read(r):
    t = r.get("trace") or {}
    if not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
