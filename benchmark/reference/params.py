"""The parameters of each configuration: names, shapes and initialisation,
and which of them a step trains.

Names are the torch parameter names of the measured program's model
(``temporal_graph.pooling.fc0.weight``, ``task.recognition.cls0.TLinear_0
.bias``, ``graphone.w_l``, ...), so one dict of tensors serves the program
and the reference alike. Shapes follow the published model: TRN pooling
(``S*D -> tp_hidden -> tp_hidden -> hidden``), ``depth`` SAGE layers with a
projection, each with a graph LayerNorm, the output linear, four task heads
(a projection MLP and one classifier a label head; in phase 2 also one
classifier set per aux task of the head, :func:`head_aux`) and, in phase
2, GraphONE's stacked stages.

Init (``init`` of each entry): ``"uniform"`` draws U(-1/sqrt(fan_in),
1/sqrt(fan_in)) as torch's ``nn.Linear`` does for its weight and bias;
``"ones"`` and ``"zeros"`` are the LayerNorm affine.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch


class Leaf(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    init: str
    fan_in: int


def _linear(out: List[Leaf], name: str, fan_in: int, fan_out: int,
            bias: bool = True) -> None:
    out.append(Leaf(f"{name}.weight", (fan_out, fan_in), "uniform", fan_in))
    if bias:
        out.append(Leaf(f"{name}.bias", (fan_out,), "uniform", fan_in))


def _norm(out: List[Leaf], name: str, dim: int) -> None:
    out.append(Leaf(f"{name}.weight", (dim,), "ones", 0))
    out.append(Leaf(f"{name}.bias", (dim,), "zeros", 0))


HEAD_NAMES = {"ar": "recognition", "lta": "lta", "oscc": "oscc", "pnr": "pnr"}
# the aux classifier sets of each head in phase 2 where the configuration
# gives no ``head_aux``: the sets ``egopack-novel-oscc`` is built with,
# narrower than the published trainer's (each head gets the other three
# tasks); its leaf list, and so its one U[0, 1) draw, depend on them
PHASE2_AUX = {"ar": ("lta", "pnr"), "oscc": ("ar", "lta", "pnr"),
              "lta": ("ar", "pnr"), "pnr": ("ar", "lta")}


def head_aux(cfg: dict) -> Dict[str, Tuple[str, ...]]:
    """Each head's phase-2 aux classifier sets, in order: the
    configuration's ``head_aux``, else :data:`PHASE2_AUX`."""
    sets = cfg.get("head_aux", PHASE2_AUX)
    return {t: tuple(sets[t]) for t in HEAD_NAMES}


def head_classes(cfg: dict, task: str) -> Sequence[int]:
    if task in ("ar", "lta"):
        return (cfg["n_verbs"], cfg["n_nouns"])
    return (2,) if task == "oscc" else (1,)


def param_spec(cfg: dict) -> List[Leaf]:
    d, s, h = cfg["feature_dim"], cfg["num_segments"], cfg["hidden_size"]
    tp = cfg["tp_hidden_size"]
    out: List[Leaf] = []
    p = "temporal_graph.pooling"
    _linear(out, f"{p}.fc0", s * d, tp)
    _norm(out, f"{p}.ln0", tp)
    _linear(out, f"{p}.fc1", tp, tp)
    _norm(out, f"{p}.ln1", tp)
    _linear(out, f"{p}.fc_out", tp, h)
    for i in range(cfg["depth"]):
        _linear(out, f"temporal_graph.sage{i}.lin_project", h, h)
        _linear(out, f"temporal_graph.sage{i}.lin_l", h, h)
        _linear(out, f"temporal_graph.sage{i}.lin_r", h, h, bias=False)
        _norm(out, f"temporal_graph.gn{i}", h)
    _linear(out, "temporal_graph.out_lin", h, h)
    phase2 = cfg["phase"] == 2
    aux = head_aux(cfg) if phase2 else {}
    for task in ("ar", "lta", "oscc", "pnr"):
        head = f"task.{HEAD_NAMES[task]}"
        _linear(out, f"{head}.proj_fc0", h, h)
        _norm(out, f"{head}.proj_ln", h)
        _linear(out, f"{head}.proj_fc1", h, h)
        classes = head_classes(cfg, task)
        sets = [""] + [f"aux_{t}_" for t in aux.get(task, ())]
        for prefix in sets:
            if len(classes) == 1:
                _linear(out, f"{head}.{prefix}cls.TLinear_0", h, classes[0])
            else:
                for i, c in enumerate(classes):
                    _linear(out, f"{head}.{prefix}cls{i}.TLinear_0", h, c)
    if phase2:
        g = cfg["graphone"]
        dims = (g["depth"], len(cfg["aux_tasks"]))
        gh = g["hidden_size"]
        out += [Leaf("graphone.w_l", dims + (h, gh), "uniform", h),
                Leaf("graphone.w_r", dims + (h, gh), "uniform", h),
                Leaf("graphone.ln_scale", dims + (gh,), "ones", 0),
                Leaf("graphone.ln_bias", dims + (gh,), "zeros", 0),
                Leaf("graphone.w_proj", dims + (gh, h), "uniform", gh),
                Leaf("graphone.b_proj", dims + (h,), "uniform", gh)]
    return out


def trainable_prefixes(cfg: dict) -> Tuple[str, ...]:
    """Phase 1: the backbone and the active tasks' heads. Phase 2: the
    novel task's head, GraphONE, and the backbone where gradients flow
    back into it (``backprop_temporal_graph``); the aux heads stay
    frozen."""
    heads = tuple(f"task.{HEAD_NAMES[t]}." for t in cfg["tasks"])
    if cfg["phase"] == 1:
        return ("temporal_graph.",) + heads
    backbone = (("temporal_graph.",) if cfg["backprop_temporal_graph"]
                else ())
    return backbone + heads + ("graphone.",)


def trainable_names(cfg: dict) -> List[str]:
    pre = trainable_prefixes(cfg)
    return [leaf.name for leaf in param_spec(cfg) if leaf.name.startswith(pre)]


def trainable_elements(cfg: dict) -> int:
    pre = trainable_prefixes(cfg)
    n = 0
    for leaf in param_spec(cfg):
        if leaf.name.startswith(pre):
            n += int(torch.Size(leaf.shape).numel())
    return n


def init_params(cfg: dict, generator: torch.Generator,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """Every parameter from one U[0, 1) draw on ``device`` (one call for all
    the uniform leaves), scaled leaf by leaf; float32."""
    spec = param_spec(cfg)
    total = sum(int(torch.Size(l.shape).numel()) for l in spec
                if l.init == "uniform")
    u = torch.rand(total, generator=generator, device=device)
    out, off = {}, 0
    for leaf in spec:
        if leaf.init == "ones":
            out[leaf.name] = torch.ones(leaf.shape, device=device)
        elif leaf.init == "zeros":
            out[leaf.name] = torch.zeros(leaf.shape, device=device)
        else:
            n = int(torch.Size(leaf.shape).numel())
            bound = 1.0 / (leaf.fan_in ** 0.5)
            out[leaf.name] = (u[off:off + n] * (2 * bound) - bound).reshape(
                leaf.shape)
            off += n
    return out
