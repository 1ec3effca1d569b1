"""Host milliseconds a train step spends enqueuing the forward (`_images`,
`apply_model`: BN-train and the convs): the program's `train.forward`
spans over its counter `train.steps`.

`read` below is every program-span reader's: each reads
`obs/trace.snapshot()` in the run's own process, which holds what the
tracer recorded while the profiler ran, the traced sub-window. So these
are host times under the profiler, which records every aten op: they
inflate the phases unevenly (the backward most) and may rank them in
another order than an untraced step. Read a change as a change of the
same phase under the same profiler, not as the phases' shares of a
plain step."""


def read(r, span="train.forward", kind="train", per_step=True, own=False):
    """Milliseconds of the program's span `span`: summed over the window
    and divided by the steps counted (`train.steps`), or, not per_step, a
    call's mean (own: of its self time, the spans nested in it left out).
    None outside runs of `kind`, and where the program records no such
    span (a program without `obs/trace`)."""
    if r.get("kind") != kind:
        return None
    try:
        from yolo_series_tpu_torch.obs import trace
    except ImportError:
        return None
    snap = trace.snapshot()
    d = snap["self" if own else "spans"].get(span)
    n = snap["counters"].get("train.steps") if per_step else len(d or ())
    return 1e3 * sum(d) / n if d and n else None
