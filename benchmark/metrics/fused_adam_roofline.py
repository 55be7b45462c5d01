"""The fused Adam kernel's share of its roofline, in % (optimizer layer:
``train/optim.py`` -> ``ops/fused_adam.py`` -> ``ops/csrc/fused_adam.cu``):
the least time of one step's update over the kernel's mean device
duration. Least time: the larger of the bytes (each trainable element's
p, g, m, v read and p, m, v written once: 28 B with float32 moments) over
the memory rate and 16 operations an element over the float32 peak; the
bytes bind."""

from benchmark.harness import counts


def read(ctx):
    ev = ctx.kernels("adam_kernel")
    if not ev:
        return None
    mean_s = sum(e - s for _, s, e in ev) / len(ev) / 1e6
    least = counts.adam_least_s(ctx.trainable_elements,
                                ctx.cfg["moments_dtype"], ctx.card)
    return 100.0 * least / mean_s
