"""The 95th percentile of the window's step times, in ms (step layer):
each the gap between CUDA events recorded on the stream at consecutive
step boundaries, with no synchronize inside the window, so a stall the
card waits through lands in the step after it."""


def read(ctx):
    return ctx.window.p95_ms() if ctx.window.step_ms else None
