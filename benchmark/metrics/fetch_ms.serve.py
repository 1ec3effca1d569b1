"""Mean host milliseconds of a `ServingEngine.to_host` call (it waits for
its own batch's event, then copies on the engine's fetch stream, while
the batches dispatched after it run): the program's `engine.fetch` span,
under the profiler (`fwd_host_ms.train`'s reader)."""

import functools

from benchmark.harness.common import reader

read = functools.partial(reader("fwd_host_ms.train"), kind="batch", per_step=False,
                         span="engine.fetch")
