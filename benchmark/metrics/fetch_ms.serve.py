"""Mean host milliseconds of a `ServingEngine.to_host` call (its `.cpu()`
waits for all the work queued on the engine's stream): the program's
`engine.fetch` span, under the profiler (`fwd_host_ms.train`'s reader)."""

import functools

from benchmark.harness.common import reader

read = functools.partial(reader("fwd_host_ms.train"), kind="batch", per_step=False,
                         span="engine.fetch")
