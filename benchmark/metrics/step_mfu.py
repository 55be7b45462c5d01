"""The whole step's share of the card's dense bf16 peak, in %: the frozen
shape count of a step (``harness/counts.py``) times the steps of the
stretches that recorded the card alone, over those stretches' device spans,
over the peak (989.4 TFLOP/s on the H100 SXM). The peak stays the same
whatever precision or kernel runs."""

from benchmark.harness import counts
from benchmark.harness.trace import device_totals


def read(ctx):
    stretches = ctx.device_stretches()
    _, span = device_totals(stretches)
    if not span:
        return None
    rate = ctx.step_flops * ctx.traced_steps(stretches) / span
    return 100.0 * rate / counts.bf16_peak(ctx.card)
