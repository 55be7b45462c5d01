"""Kernels the card ran a step (step layer): kernel events of the
stretches that recorded the card alone, copies and fills left out, over
the steps in them."""

from benchmark.harness.trace import NOT_KERNELS


def read(ctx):
    stretches = ctx.device_stretches()
    steps = ctx.traced_steps(stretches)
    n = sum(1 for s in stretches for name, _, _ in s.device
            if not name.startswith(NOT_KERNELS))
    return n / steps if steps and n else None
