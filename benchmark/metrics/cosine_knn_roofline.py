"""The cosine k-NN's share of its roofline, in % (k-NN layer:
``ops/knn.py`` -> ``ops/knn_topk.py`` -> ``ops/csrc/knn_topk.cu``): the
least time of one call over the device time of a call (all the k-NN
kernels' durations over the calls). Least time: the larger of the bytes
(each valid bank row, the features and the mask read once, the lists
written once) over the memory rate and the products' operations over the
TF32 tensor-core peak; at these shapes the bytes bind."""

from benchmark.harness import counts


def read(ctx):
    calls = sum(s.knn_calls for s in ctx.stretches)
    ev = ctx.kernels("knn_partial") + ctx.kernels("knn_merge")
    if not calls or not ev:
        return None
    per_call_s = sum(e - s for _, s, e in ev) / calls / 1e6
    least, _ = counts.knn_least_s(ctx.cfg, ctx.card)
    return 100.0 * least / per_call_s
