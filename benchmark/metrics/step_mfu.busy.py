"""The whole step's share of the card's dense bf16 peak while the card
works, in %: the frozen shape count of a step (``harness/counts.py``)
times the steps of the stretches that recorded the card alone, over the
union of their device intervals, over the peak (989.4 TFLOP/s on the H100
SXM). It bounds the kernels' rooflines that move the card's time a step,
whatever precision or kernel runs."""

from benchmark.harness import counts
from benchmark.harness.trace import device_totals


def read(ctx):
    stretches = ctx.device_stretches()
    busy, _ = device_totals(stretches)
    if not busy:
        return None
    rate = ctx.step_flops * ctx.traced_steps(stretches) / busy
    return 100.0 * rate / counts.bf16_peak(ctx.card)
