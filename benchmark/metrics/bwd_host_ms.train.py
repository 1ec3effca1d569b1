"""Host milliseconds a train step spends enqueuing the backward
(`torch.autograd.grad` and the zeros of unused gradients): the program's
`train.backward` spans over its counter `train.steps`, under the profiler,
which inflates this phase most (`fwd_host_ms.train`'s reader)."""

import functools

from benchmark.harness.common import reader

read = functools.partial(reader("fwd_host_ms.train"), span="train.backward")
