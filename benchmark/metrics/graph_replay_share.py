"""The share of the program's train steps that replayed a CUDA graph, in %
(step layer: ``train/system.py:_make_inner_step`` ->
``train/step_graph.py``): the count of span ``egopack.replay`` over the
count of span ``egopack.step`` in ``egopack_torch.tracing.summary()``, over
the run's unprofiled steps (the checked ones, the warm-up and the window).
None on the CPU, where no step is captured, and on a program without the
graphs; 0 where the program has them and no step replayed."""


def read(ctx):
    if ctx.card == "cpu":
        return None
    try:
        from egopack_torch import tracing
        from egopack_torch.train import step_graph  # noqa: F401
    except ImportError:
        return None
    rows = tracing.summary()
    steps = rows.get("egopack.step")
    if not steps:
        return None
    replays = rows.get("egopack.replay")
    return 100.0 * (replays["count"] if replays else 0) / steps["count"]
