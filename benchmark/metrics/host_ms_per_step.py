"""Host milliseconds of each step call (step layer: ``train/system.py``),
summed over the window's untraced steps on the host clock with no
synchronize, divided by those steps: the dispatch cost that sets the pace
while the card idles."""


def read(ctx):
    w = ctx.window
    if not w.host_steps:
        return None
    return w.host_s / w.host_steps * 1e3
