"""The port's spans and counters: where the host time of a serving call, a
batcher's request or a train step goes.

    from yolo_series_tpu_torch.obs import trace

    with trace.span("engine.stage"):
        ...
    trace.count("engine.fetches")
    trace.snapshot()   # {"spans": {name: [s]}, "self": {name: [s]}, "counters": {name: n}}

The tracer is on while a torch profiler records in this process (so a
profiled run gets the spans with no switch of its own), or after
`enable(True)`. Off, `span` reads two flags and returns a shared no-op, and
`count` does nothing: no clock read, no `record_function`, no allocation.

On, a span records its name, start and end on the host clock
(`time.perf_counter`), its self time (its duration less the spans nested in
it on its thread), its parent (the enclosing span of its thread, or one
handed across threads as `parent=`, a span's `sid`) and an identifier that
ties the spans of one request, batch or step together. While a profiler
records, each span is also a `torch.profiler.record_function` of its name,
so it sits in the profiler's Chrome trace on the clock of the kernels and
copies: that trace is the tracer's file export.

The store keeps the newest `MAX_RECORDS` spans of each name; counters count
only while the tracer is on, so a ratio of two belongs to one traced window.
`snapshot` also reads the counts the port keeps itself, on or off, from
the holders that registered them with `watch`: the kernels' `.launches`
and the live serving engines' `batches` / `replays`.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
import weakref
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

MAX_RECORDS = 4096   # spans kept a name, the oldest dropped


class Record(NamedTuple):
    name: str
    sid: int                 # this span's number, unique in the process
    start: float             # host clock, s
    end: float
    self_s: float            # duration less the spans nested in it on its thread
    parent: Optional[int]    # the parent's sid
    ident: object            # the request's, batch's or step's identifier


_forced = False
_records: Dict[str, collections.deque] = {}
_counters: collections.Counter = collections.Counter()
_lock = threading.Lock()
_local = threading.local()
_sids = itertools.count(1)
_watched: Dict[str, tuple] = {}   # name -> (attribute, WeakSet of its holders)


def on() -> bool:
    """Whether spans and counts are recorded now."""
    return _forced or _profiler._is_profiler_enabled


def enable(flag: bool = True):
    """Record with no profiler running (an operator's long run), or stop."""
    global _forced
    _forced = bool(flag)


class _Off:
    sid = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _keep(rec: Record):
    d = _records.get(rec.name)
    if d is None:
        d = _records.setdefault(rec.name, collections.deque(maxlen=MAX_RECORDS))
    d.append(rec)


class _Span:
    __slots__ = ("name", "parent", "ident", "sid", "outer", "covered", "rf", "start")

    def __init__(self, name, parent, ident):
        self.name, self.parent, self.ident = name, parent, ident
        self.covered = 0.0
        self.rf = None

    def __enter__(self):
        stack = _stack()
        self.outer = stack[-1] if stack else None
        if self.parent is None and self.outer is not None:
            self.parent = self.outer.sid
        self.sid = next(_sids)
        stack.append(self)
        if _profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _stack().pop()
        dur = end - self.start
        if self.outer is not None:
            self.outer.covered += dur
        _keep(Record(self.name, self.sid, self.start, end, dur - self.covered,
                     self.parent, self.ident))
        return False


def span(name: str, parent: Optional[int] = None, ident=None):
    """A context manager that records the block as the span `name` (module
    docstring). parent: a span's `sid`, for work handed across threads;
    the enclosing span of this thread when not given. `with span(...) as s`
    gives `s.sid` (None when the tracer is off)."""
    if not (_forced or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, parent, ident)


def interval(name: str, start: float, parent: Optional[int] = None, ident=None):
    """Record the span `name` from `start` (host clock, taken in any thread)
    to now, with no profiler annotation: a wait that began elsewhere, such
    as a request's time in a queue."""
    if on():
        end = time.perf_counter()
        _keep(Record(name, next(_sids), start, end, end - start, parent, ident))


def count(name: str, n: int = 1):
    """Add n to the counter `name` while the tracer is on."""
    if _forced or _profiler._is_profiler_enabled:
        with _lock:
            _counters[name] += n


def watch(name: str, holder, attr: str):
    """Read `holder.<attr>` into `snapshot`'s counters as `name`, summed
    over the holders registered under it that still live (a kernel
    function's `.launches`, an engine's `batches`)."""
    with _lock:
        _watched.setdefault(name, (attr, weakref.WeakSet()))[1].add(holder)


def records(name: str) -> List[Record]:
    """The kept spans of `name`, oldest first."""
    return list(_records.get(name, ()))


def snapshot() -> dict:
    """{"spans": {name: [durations s]}, "self": {name: [self durations s]},
    "counters": {name: n}}: the kept spans, the counters counted while on,
    and the port's own counts registered by `watch`
    (`launches.<module>.<function>`, `engine.batches`, `engine.replays`:
    totals since the process began)."""
    spans, selfs = {}, {}
    for name, d in list(_records.items()):
        rs = list(d)
        spans[name] = [r.end - r.start for r in rs]
        selfs[name] = [r.self_s for r in rs]
    with _lock:
        counters = dict(_counters)
        watched = [(name, attr, list(holders)) for name, (attr, holders) in _watched.items()]
    for name, attr, holders in watched:
        counters[name] = sum(getattr(h, attr, 0) for h in holders)
    return {"spans": spans, "self": selfs, "counters": counters}


def reset():
    """Forget the kept spans and the counters."""
    with _lock:
        _records.clear()
        _counters.clear()
