"""Floating-point operations of one optimizer step of each bench line,
counted from the shapes of the configuration (the port's stand-in for the
XLA ``cost_analysis`` that ``bench.py:166-178`` reads).

Every matrix product of the step is counted at 2 operations per
multiply-add: forward, and in the backward pass each gradient that autograd
computes (a weight's always, an input's where the input depends on a
trainable parameter). Elementwise work, reductions, the optimizer and the
matrix-vector products of the concat layout's LayerNorm statistics (a few
``T × M`` each) are not counted. The count holds whatever runs the
products: cuBLAS in float32 or bf16, or a kernel of the port (the cosine kNN
counts its ``M × P`` products with every bank row, valid or not).
"""

from __future__ import annotations

from typing import Dict, Sequence

# graph sizes of the bench's tasks (data/graphs.py: ar_spec(9), lta_spec(2,
# 20), pnr_spec(16), oscc_spec)
NODES = {"ar": 9, "lta": 22, "pnr": 16, "oscc": 4}
N_VERBS, N_NOUNS = 115, 478
SEGMENTS, DEPTH = 3, 3
# the layout "auto" picks (train/system.py:CONCAT_AUTO_MAX_NODES)
CONCAT_AUTO_MAX_NODES = 1024


def linear(rows: int, k: int, n: int, input_grad: bool = True,
           train: bool = True) -> int:
    """``(rows, k) @ (k, n)``: forward; with ``train`` also the weight's
    gradient and, with ``input_grad``, the input's."""
    fwd = 2 * rows * k * n
    return fwd if not train else fwd * (2 + int(input_grad))


def _backbone(rows: Sequence[int], batch: int, feat_dim: int, hidden: int,
              layout: str) -> int:
    """Pooling over every task's nodes in one product, then the reason
    stack: ``layout`` "concat" aggregates over all rows at once, "slice"
    (and a single task) per task and sample."""
    r = sum(rows)
    out = (linear(r, SEGMENTS * feat_dim, hidden, input_grad=False)
           + 2 * linear(r, hidden, hidden))
    for _ in range(DEPTH):
        out += 3 * linear(r, hidden, hidden)  # lin_project, lin_l, lin_r
        if layout == "concat":
            agg = 2 * r * r * hidden
        else:
            agg = sum(2 * rt * (rt // batch) * hidden for rt in rows)
        out += 2 * agg  # forward, and the messages' gradient
    return out + linear(r, hidden, hidden)  # out_lin


def _projection(rows: int, hidden: int, train: bool = True) -> int:
    return (linear(rows, hidden, hidden, train=train)
            + linear(rows, hidden, hidden, train=train))


def mtl_step_flops(batch: int, feat_dim: int, hidden: int,
                   layout: str = "auto",
                   active: Sequence[str] = ("ar", "lta", "pnr")) -> int:
    """One phase-1 step over ``active`` (bench line 1: TRN hidden equal to
    ``hidden``, heads of width ``hidden``)."""
    rows = [batch * NODES[t] for t in active]
    if layout == "auto":
        layout = "concat" if sum(rows) <= CONCAT_AUTO_MAX_NODES else "slice"
    out = _backbone(rows, batch, feat_dim, hidden, layout)
    classes: Dict[str, Sequence[int]] = {"ar": (N_VERBS, N_NOUNS),
                                         "lta": (N_VERBS, N_NOUNS),
                                         "pnr": (1,), "oscc": (2,)}
    for t, r in zip(active, rows):
        out += _projection(r, hidden)
        cls_rows = batch if t == "oscc" else r  # OSCC classifies the pool
        out += sum(linear(cls_rows, hidden, c) for c in classes[t])
    return out


def egopack_step_flops(batch: int, feat_dim: int, hidden: int,
                       p_pad: int, k_aux: int = 3) -> int:
    """One phase-2 step (bench line 2): novel OSCC with late fusion over
    ``k_aux`` aux tasks, the backbone trained in eval mode, GraphONE of
    depth 3 with frozen banks of ``p_pad`` rows and width ``hidden``."""
    rows = batch * NODES["oscc"]
    out = _backbone([rows], batch, feat_dim, hidden, "slice")
    out += _projection(rows, hidden)  # the OSCC head's projection
    # the aux heads' projections, detached, forward only
    out += k_aux * _projection(rows, hidden, train=False)
    # cosine kNN over every bank row, no gradient
    out += 2 * k_aux * rows * p_pad * hidden
    # GraphONE: per stage three (T, M, F) x (F, H) products; the first
    # stage's inputs do not depend on a trainable parameter
    stage = 2 * k_aux * rows * hidden * hidden
    out += DEPTH * 3 * stage + 4 * stage + (DEPTH - 1) * 6 * stage
    # the primary and aux classifiers on the pooled features
    out += (1 + k_aux) * linear(batch, hidden, 2)
    return out


# ---------------- the products' count ----------------
# The float32 matrix products of a step that the linear layers and
# GraphONE's stages run (``ops/gemm.py``: one ``tf32x3_gemm`` launch each);
# SAGE's adjacency products and the LayerNorm statistics are not among them.

def products(input_grad: bool = True, train: bool = True) -> int:
    """One linear layer's products: the forward and, with ``train``, the
    weight's gradient and, with ``input_grad``, the input's."""
    return 1 if not train else 2 + int(input_grad)


def _backbone_products(train: bool = True) -> int:
    """Pooling's fc0 (its input is data), fc1 and fc_out, the SAGE layers'
    three linears each, out_lin."""
    return (products(input_grad=False, train=train)
            + (2 + 3 * DEPTH + 1) * products(train=train))


def mtl_step_products(active: Sequence[str] = ("ar", "lta", "pnr")) -> int:
    """One phase-1 step over ``active``: the backbone, and each task's
    projection (two linears) and classifiers (two for AR and LTA, one for
    PNR and OSCC)."""
    classes = {"ar": 2, "lta": 2, "pnr": 1, "oscc": 1}
    return _backbone_products() + sum(
        (2 + classes[t]) * products() for t in active)


def egopack_step_products(heads: int = 1, aux: int = 3, tasks: int = 3,
                          depth: int = DEPTH,
                          backbone_trains: bool = True) -> int:
    """One phase-2 step: the backbone (forward only when frozen), the novel
    task's projection (no input gradient into it over a frozen backbone),
    the ``tasks`` GraphONE tasks' projections forward only, the novel
    task's ``heads`` classifiers with ``aux`` aux sets each, and GraphONE's
    ``depth`` stages of three products (each with its weight's gradient;
    with its input's but for the first stage's two, whose inputs hold no
    gradient)."""
    out = _backbone_products(train=backbone_trains)
    out += (products(input_grad=backbone_trains) + products())
    out += tasks * 2 * products(train=False)
    out += heads * (1 + aux) * products()
    return out + 3 * depth * products() - 2
