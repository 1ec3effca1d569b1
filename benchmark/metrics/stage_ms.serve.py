"""Mean host milliseconds of the engine's staging in a
`ServingEngine.infer_async` call (pad, tensor, `pin_memory`): the program's
`engine.stage` span, under the profiler (`fwd_host_ms.train`'s reader)."""

import functools

from benchmark.harness.common import reader

read = functools.partial(reader("fwd_host_ms.train"), kind="batch", per_step=False,
                         span="engine.stage")
