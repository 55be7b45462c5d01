"""Device policy: the card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device without a card raises: the
    port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "egopack_torch: CUDA is not available; pass device='cpu' to run "
            "on the CPU")
    return dev


def make_generator(seed: int, device: DeviceLike = None) -> torch.Generator:
    """A seeded generator on ``device``: dropout masks and init are drawn on
    the device that holds the tensors."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(seed)
    return g
