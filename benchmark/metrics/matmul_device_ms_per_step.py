"""Device milliseconds a step of the matrix products (model layer: cuBLAS
and CUTLASS through torch ops), by kernel name: the summed durations of
the kernels whose name holds ``gemm``, ``gemv`` or ``cublas`` (any case;
the last takes cuBLAS's split-K reductions, epilogues, scalings and dot
products, named by their parameter types), the k-NN's own ``knn_*``
kernels left out, over the stretches that recorded the card alone, over
their steps. Kernels are named alike whether the step runs eagerly or
replays a CUDA graph, so it reads under both. Left out: the fills and
torch's copies that a product op may launch, which no name tells from the
step's others. ``tests/test_bench_kernels.py`` holds the names, on the
card, to the kernels that the product ops launch in an eager step."""

GEMM = ("gemm", "gemv", "cublas")
NOT_GEMM = "knn_"


def is_product(name: str) -> bool:
    """Whether the kernel ``name`` is a matrix product's."""
    return any(g in name.lower() for g in GEMM) and NOT_GEMM not in name


def read(ctx):
    stretches = ctx.device_stretches()
    steps = ctx.traced_steps(stretches)
    us = sum(e - s for st in stretches for name, s, e in st.device
             if is_product(name))
    if not steps or not us:
        return None
    return us / 1e3 / steps
