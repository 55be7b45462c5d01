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


def _backbone(cfg: dict, rows, layout: str) -> int:
    """Pooling over every task's nodes in one product (its input needs no
    gradient), then the SAGE stack: "concat" aggregates over all rows at
    once, "slice" per task and sample."""
    b, h, tp = cfg["batch_size"], cfg["hidden_size"], cfg["tp_hidden_size"]
    r = sum(rows)
    out = (linear(r, cfg["num_segments"] * cfg["feature_dim"], tp,
                  input_grad=False)
           + linear(r, tp, tp) + linear(r, tp, h))
    for _ in range(cfg["depth"]):
        out += 3 * linear(r, h, h)  # lin_project, lin_l, lin_r
        if layout == "concat":
            agg = 2 * r * r * h
        else:
            agg = sum(2 * rt * (rt // b) * h for rt in rows)
        out += 2 * agg  # forward, and the messages' gradient
    return out + linear(r, h, h)  # out_lin


def _projection(rows: int, h: int, train: bool = True) -> int:
    return linear(rows, h, h, train=train) + linear(rows, h, h, train=train)


def phase1_step_flops(cfg: dict) -> int:
    b, h = cfg["batch_size"], cfg["hidden_size"]
    rows = [b * cfg["nodes"][t] for t in cfg["tasks"]]
    layout = cfg["fused_layout"]
    if layout == "auto":
        layout = ("concat" if sum(rows) <= CONCAT_AUTO_MAX_NODES
                  else "slice")
    out = _backbone(cfg, rows, layout)
    classes = {"ar": (cfg["n_verbs"], cfg["n_nouns"]),
               "lta": (cfg["n_verbs"], cfg["n_nouns"]), "pnr": (1,),
               "oscc": (2,)}
    for t, r in zip(cfg["tasks"], rows):
        out += _projection(r, h)
        cls_rows = b if t == "oscc" else r  # OSCC classifies the pool
        out += sum(linear(cls_rows, h, c) for c in classes[t])
    return out


def phase2_step_flops(cfg: dict) -> int:
    """Novel OSCC with late fusion over the aux tasks; the backbone is
    trained (its mode changes no product); GraphONE's stages as three
    ``(T, M, F) x (F, H)`` products each, of which the first stage's two
    take inputs that need no gradient; the residual adds no product; the
    k-NN counts its products with every bank row, padded ones included."""
    b, h = cfg["batch_size"], cfg["hidden_size"]
    k_aux = len(cfg["aux_tasks"])
    depth = cfg["graphone"]["depth"]
    rows = b * cfg["nodes"]["oscc"]
    out = _backbone(cfg, [rows], "slice")
    out += _projection(rows, h)  # the OSCC head's projection
    out += k_aux * _projection(rows, h, train=False)  # aux, detached
    out += 2 * k_aux * rows * cfg["banks"]["rows"] * h  # k-NN, no gradient
    stage = 2 * k_aux * rows * h * cfg["graphone"]["hidden_size"]
    out += depth * 3 * stage + 4 * stage + (depth - 1) * 6 * stage
    out += (1 + k_aux) * linear(b, h, 2)  # primary and aux classifiers
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
    """Least time of one k-NN call and the bound that sets it."""
    nbytes, ops = knn_counts(len(cfg["aux_tasks"]),
                             cfg["batch_size"] * cfg["nodes"]["oscc"],
                             cfg["banks"]["valid"], cfg["banks"]["rows"],
                             cfg["hidden_size"], cfg["graphone"]["k"])
    t_bytes = nbytes / hbm_bytes_per_s(card)
    t_ops = ops / tf32_peak(card)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
