"""Launch calls a step inside the span ``egopack.optimizer`` of the train
step: ``optimizer.apply``, the fused Adam's launch (optimizer kernel
layer). CUDA runtime and driver calls that queue kernels, copies or
fills, counted where their host interval lies inside the span, over the
stretches that recorded the host's operations, over their steps
(``harness/spans.py``)."""

from benchmark.harness.spans import launches_per_step


def read(ctx):
    return launches_per_step(ctx, "egopack.optimizer")
