"""Median host milliseconds of the train step's span ``egopack.step``
(step layer: ``train/system.py:_make_inner_step``), over the program's
unprofiled steps of the run (the checked ones, the warm-up and the
window), as ``egopack_torch.tracing.summary()`` keeps them: the step's
dispatch as the program times it, phases and glue together."""

from benchmark.harness.spans import host_ms


def read(ctx):
    return host_ms(ctx, "egopack.step")
