"""Mean host milliseconds of a train step outside its phases (input
placement, the tree walks): the self time of the program's `train.step`
span, under the profiler (`fwd_host_ms.train`'s reader)."""

import functools

from benchmark.harness.common import reader

read = functools.partial(reader("fwd_host_ms.train"), span="train.step", per_step=False, own=True)
