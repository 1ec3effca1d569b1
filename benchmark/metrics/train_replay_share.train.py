"""The share of the traced window's train steps that replayed a captured
CUDA graph, in percent: the program's counters `train.replays` over
`train.steps`, from `obs/trace.snapshot()` (kind "train"; None where the
program counts no step as replayed, captured or eager, as a program
without the step's graph). A step that replays enqueues one graph launch
in place of the step's several thousand kernels, so the share is 100
while the card, and not the host's enqueueing, sets the training pace;
the steps that ran eagerly count under `train.eager.<why>`."""


def read(r):
    if r.get("kind") != "train":
        return None
    try:
        from yolo_series_tpu_torch.obs import trace
    except ImportError:
        return None
    c = trace.snapshot()["counters"]
    paths = ("train.replays", "train.captures")
    if not c.get("train.steps") or not any(k in paths or k.startswith("train.eager.")
                                           for k in c):
        return None
    return 100.0 * c.get("train.replays", 0) / c["train.steps"]
