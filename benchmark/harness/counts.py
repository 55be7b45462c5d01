"""The yardstick's arithmetic, frozen here so that later changes to the
program cannot move it: the card's peak rates, interval unions, and the
operations and bytes of the step and of each kernel, counted from the
configuration's shapes.

Peaks are NVIDIA's data-sheet and white-paper rates, dense, without
sparsity, at the card's full power limit, looked up by the name
``torch.cuda.get_device_name`` gives (copied from the program's
``profiling.py``). The step count is the program's ``flops.py`` made a
function of the configuration file: every matrix product at 2 operations a
multiply-add, forward and each gradient that autograd computes; elementwise
work, reductions and the optimizer are not counted.
"""

from __future__ import annotations

from typing import Iterable, Tuple

from ..reference.params import head_classes

# (SXM, NVL, PCIe) of each H100 part; the H200 has the SXM part's rates
# and faster memory
_HBM = {"SXM": 3.35e12, "NVL": 3.9e12, "PCIe": 2.0e12}
_FP32 = {"SXM": 67e12, "NVL": 60e12, "PCIe": 51e12}
_TF32 = {"SXM": 495e12, "NVL": 418e12, "PCIe": 378e12}
_BF16 = {"SXM": 989.4e12, "NVL": 835.5e12, "PCIe": 756e12}


def _variant(name: str) -> str:
    if "H200" in name:
        return "SXM"
    if "H100" in name:
        return "PCIe" if "PCIe" in name else "NVL" if "NVL" in name else "SXM"
    raise RuntimeError(f"no peak rates on record for {name!r}")


def hbm_bytes_per_s(name: str) -> float:
    return 4.8e12 if "H200" in name else _HBM[_variant(name)]


def fp32_peak(name: str) -> float:
    return _FP32[_variant(name)]


def tf32_peak(name: str) -> float:
    return _TF32[_variant(name)]


def bf16_peak(name: str) -> float:
    """Dense bf16 with float32 sums: 989.4 TFLOP/s on the H100 SXM."""
    return _BF16[_variant(name)]


def union_us(spans: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, start, end = 0.0, None, None
    for s, e in sorted(spans):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    return total if end is None else total + end - start


# ---------------- operations of one optimizer step ----------------

CONCAT_AUTO_MAX_NODES = 1024  # the program's "auto" layout rule


def linear(rows: int, k: int, n: int, input_grad: bool = True,
           train: bool = True) -> int:
    """``(rows, k) @ (k, n)``: forward; in training also the weight's
    gradient and, with ``input_grad``, the input's."""
    fwd = 2 * rows * k * n
    return fwd if not train else fwd * (2 + int(input_grad))


def _backbone(cfg: dict, rows, layout: str, train: bool = True) -> int:
    """Pooling over every task's nodes in one product (its input needs no
    gradient), then the SAGE stack: "concat" aggregates over all rows at
    once, "slice" per task and sample. Without ``train`` the forward
    alone."""
    b, h, tp = cfg["batch_size"], cfg["hidden_size"], cfg["tp_hidden_size"]
    r = sum(rows)
    out = (linear(r, cfg["num_segments"] * cfg["feature_dim"], tp,
                  input_grad=False, train=train)
           + linear(r, tp, tp, train=train) + linear(r, tp, h, train=train))
    for _ in range(cfg["depth"]):
        out += 3 * linear(r, h, h, train=train)  # lin_project, lin_l, lin_r
        if layout == "concat":
            agg = 2 * r * r * h
        else:
            agg = sum(2 * rt * (rt // b) * h for rt in rows)
        out += (2 if train else 1) * agg  # forward, and the messages' gradient
    return out + linear(r, h, h, train=train)  # out_lin


def _projection(rows: int, h: int, train: bool = True,
                input_grad: bool = True) -> int:
    return (linear(rows, h, h, input_grad=input_grad, train=train)
            + linear(rows, h, h, train=train))


def classified_rows(cfg: dict, task: str) -> int:
    """The rows a classifier of ``task`` sees: OSCC classifies the pool of
    each sample's nodes, the others every node."""
    b = cfg["batch_size"]
    return b if task == "oscc" else b * cfg["nodes"][task]


def phase1_step_flops(cfg: dict) -> int:
    b, h = cfg["batch_size"], cfg["hidden_size"]
    rows = [b * cfg["nodes"][t] for t in cfg["tasks"]]
    layout = cfg["fused_layout"]
    if layout == "auto":
        layout = ("concat" if sum(rows) <= CONCAT_AUTO_MAX_NODES
                  else "slice")
    out = _backbone(cfg, rows, layout)
    for t, r in zip(cfg["tasks"], rows):
        out += _projection(r, h)
        out += sum(linear(classified_rows(cfg, t), h, c)
                   for c in head_classes(cfg, t))
    return out


def phase2_step_flops(cfg: dict) -> int:
    """The novel task ``cfg["tasks"][0]`` with late fusion over the aux
    tasks: the backbone over the novel task's nodes, its backward products
    only where it trains (``backprop_temporal_graph``; its mode changes no
    product), and the novel head's projection taking its input's gradient
    only then; GraphONE's stages as three ``(T, M, F) x (F, H)`` products
    each, of which the first stage's two take inputs that need no
    gradient; the residual adds no product; the k-NN counts its products
    with every bank row, padded ones included; the novel head's primary
    and aux classifier sets at its widths."""
    task = cfg["tasks"][0]
    h = cfg["hidden_size"]
    k_aux = len(cfg["aux_tasks"])
    depth = cfg["graphone"]["depth"]
    trains = cfg["backprop_temporal_graph"]
    rows = cfg["batch_size"] * cfg["nodes"][task]
    out = _backbone(cfg, [rows], "slice", train=trains)
    out += _projection(rows, h, input_grad=trains)  # the novel head's
    out += k_aux * _projection(rows, h, train=False)  # aux, detached
    out += 2 * k_aux * rows * cfg["banks"]["rows"] * h  # k-NN, no gradient
    stage = 2 * k_aux * rows * h * cfg["graphone"]["hidden_size"]
    out += depth * 3 * stage + 4 * stage + (depth - 1) * 6 * stage
    out += (1 + k_aux) * sum(linear(classified_rows(cfg, task), h, c)
                             for c in head_classes(cfg, task))
    return out


def step_flops(cfg: dict) -> int:
    return phase1_step_flops(cfg) if cfg["phase"] == 1 \
        else phase2_step_flops(cfg)


# ---------------- kernels ----------------

ADAM_OPS_PER_ELEMENT = 16  # decay, two moments, corrections, sqrt, update


def adam_bytes(elements: int, moments_dtype: str = "float32") -> int:
    """Read p, g, m, v and write p, m, v once: 28 B an element with float32
    moments, 20 with bfloat16."""
    m = 4 if moments_dtype == "float32" else 2
    return elements * (4 + 4 + 2 * m + 4 + 2 * m)


def adam_least_s(elements: int, moments_dtype: str, card: str) -> float:
    return max(adam_bytes(elements, moments_dtype) / hbm_bytes_per_s(card),
               ADAM_OPS_PER_ELEMENT * elements / fp32_peak(card))


def knn_counts(tasks: int, rows: int, valid: int, padded: int, width: int,
               k: int) -> Tuple[int, int]:
    """(bytes, operations) of one call over ``tasks`` banks: every valid
    bank row, the features and the mask read once, the (index, distance)
    lists written once; the products of each feature row with each valid
    bank row."""
    nbytes = (tasks * valid * width * 4 + tasks * rows * width * 4
              + tasks * padded + tasks * rows * k * 8)
    return nbytes, 2 * tasks * rows * valid * width


def knn_least_s(cfg: dict, card: str) -> Tuple[float, str]:
    """Least time of one k-NN call and the bound that sets it; the query
    rows are every node of the novel task's batch."""
    rows = cfg["batch_size"] * cfg["nodes"][cfg["tasks"][0]]
    nbytes, ops = knn_counts(len(cfg["aux_tasks"]), rows,
                             cfg["banks"]["valid"], cfg["banks"]["rows"],
                             cfg["hidden_size"], cfg["graphone"]["k"])
    t_bytes = nbytes / hbm_bytes_per_s(card)
    t_ops = ops / tf32_peak(card)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
