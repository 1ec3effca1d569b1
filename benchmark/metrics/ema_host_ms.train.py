"""Host milliseconds a train step spends enqueuing the EMA of the params and
the BN state (`train/ema`): the program's `train.ema` spans over its counter
`train.steps`, under the profiler (`fwd_host_ms.train`'s reader)."""

import functools

from benchmark.harness.common import reader

read = functools.partial(reader("fwd_host_ms.train"), span="train.ema")
