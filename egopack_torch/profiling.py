"""The card's peak rates, and reading its work out of a ``torch.profiler``
trace.

Peaks are looked up by the name ``nvidia-smi --query-gpu=name`` prints
(``torch.cuda.get_device_name`` gives the same), from NVIDIA's data sheets
and the Hopper architecture white paper: dense rates, without sparsity, at
the card's full power limit. An unknown card raises.

Kernels can overlap on the card (several streams, or a launch that starts
before the previous kernel ends), so the time the card is busy is the length
of the union of their intervals, not the sum of their durations.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from torch.autograd import DeviceType

# (SXM, NVL, PCIe) per H100 variant; the H200 has the SXM part's rates but
# faster memory
_HBM = {"SXM": 3.35e12, "NVL": 3.9e12, "PCIe": 2.0e12}
_FP32 = {"SXM": 67e12, "NVL": 60e12, "PCIe": 51e12}
_TF32 = {"SXM": 495e12, "NVL": 418e12, "PCIe": 378e12}
_BF16 = {"SXM": 989.4e12, "NVL": 835.5e12, "PCIe": 756e12}


def _variant(name: str, what: str) -> str:
    if "H200" in name:
        return "SXM"
    if "H100" in name:
        return "PCIe" if "PCIe" in name else "NVL" if "NVL" in name else "SXM"
    raise RuntimeError(f"no {what} on record for {name!r}")


def hbm_bytes_per_s(name: str) -> float:
    """Peak device-memory rate."""
    if "H200" in name:
        return 4.8e12
    return _HBM[_variant(name, "memory rate")]


def fp32_peak(name: str) -> float:
    """float32 FLOP/s outside the tensor cores."""
    return _FP32[_variant(name, "float32 peak")]


def tf32_peak(name: str) -> float:
    """TF32 FLOP/s of the tensor cores."""
    return _TF32[_variant(name, "TF32 peak")]


def bf16_peak(name: str) -> float:
    """bf16 FLOP/s of the tensor cores with float32 sums: 989.4 TFLOP/s on
    the H100 SXM (white paper), 835.5 on the H100 NVL (half its data
    sheet's 1,671 with sparsity), 756 on the H100 PCIe (white paper)."""
    return _BF16[_variant(name, "bf16 peak")]


def device_events(prof) -> List:
    """The kernels, copies and fills that ``prof`` recorded on the card."""
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def union_us(spans) -> float:
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


def busy_us(events: Sequence) -> float:
    """Microseconds covered by the union of the events' time ranges."""
    return union_us((ev.time_range.start, ev.time_range.end)
                    for ev in events)


def mean_us(windows: Sequence[Sequence], names: Sequence[str]
            ) -> Dict[str, float]:
    """Mean duration in microseconds of each kernel in ``names`` (matched by
    substring) over the events of all ``windows``. Every event must match
    exactly one name, else this raises ``ValueError``. Events the profiler
    dropped from a window leave the means as they are, where a window's
    busy time would read short."""
    durations = {n: [] for n in names}
    for e in (e for events in windows for e in events):
        hit = [n for n in names if n in e.name]
        if len(hit) != 1:
            raise ValueError(f"{e.name!r} is none or several of {names}")
        durations[hit[0]].append(e.time_range.end - e.time_range.start)
    missing = [n for n, us in durations.items() if not us]
    if missing:
        raise ValueError(f"no events of {missing}")
    return {n: sum(us) / len(us) for n, us in durations.items()}
