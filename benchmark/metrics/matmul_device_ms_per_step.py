"""Device milliseconds a step of the matrix products (model layer:
cuBLAS through torch ops), as the profiler attributes self device time to
the ops ``aten::mm``, ``aten::addmm``, ``aten::bmm``, ``aten::baddbmm``,
``aten::mv`` and ``aten::addmv``, over the steps of the stretches that
recorded the host's operations."""

OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::mv",
       "aten::addmv")


def read(ctx):
    stretches = ctx.op_stretches()
    steps = ctx.traced_steps(stretches)
    us = sum(v for s in stretches for k, v in s.op_device_us.items()
             if k in OPS)
    if not steps or not us:
        return None
    return us / 1e3 / steps
