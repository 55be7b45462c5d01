"""The card's idle share, in % (device layer): one minus the union of the
device intervals over the spans of the stretches that recorded the card
alone."""

from benchmark.harness.trace import device_totals


def read(ctx):
    busy, span = device_totals(ctx.device_stretches())
    if not span:
        return None
    return 100.0 * (1.0 - busy / span)
