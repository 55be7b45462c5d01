"""Median host milliseconds of the span ``egopack.norms`` inside the train
step: the global gradient and parameter norms logged every step (step
layer). Over the program's unprofiled steps of the run (the checked
ones, the warm-up and the window), as
``egopack_torch.tracing.summary()`` keeps them."""

from benchmark.harness.spans import host_ms


def read(ctx):
    return host_ms(ctx, "egopack.norms")
