"""EgoPack in PyTorch for one NVIDIA H100.

The PyTorch counterpart of ``egopack_tpu``: the same modules under the same
layout (``config``, ``data``, ``eval``, ``io``, ``models``, ``ops``,
``train``, ``utils``; the phase-1 CLI ``python -m
egopack_torch.main_temporal``), held against the JAX package by the
``tests/test_torch_port_*.py`` tests. It imports neither JAX nor
``egopack_tpu``.

Every entry point takes a ``device`` argument. It defaults to ``"cuda"`` and
raises when no card is present; the CPU is used only when asked for.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
