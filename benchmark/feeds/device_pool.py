"""Feed ``device_pool``: ``groups`` distinct batch groups drawn on the card
from the seed at set-up (``harness/inputs.py``); calls take them in turn,
round and round, with no loader and no host copy. The first three calls,
which the correctness check follows, take three distinct groups.

A feed kind is a module of its own under ``benchmark/feeds/``, named by
the ``feed`` key of a traffic mix, with ``make`` and ``reference_groups``
as here; the feed ``make`` returns has ``next() -> (batches, clips)`` and
``close()``. The window times each ``next()`` on the host clock as the
wait for data.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.harness import inputs


class DevicePool:
    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device):
        self.groups: List[Dict] = inputs.batch_pool(cfg, traffic["groups"],
                                                    seed, device)
        if len(self.groups) < 3:
            raise ValueError("a device pool needs at least 3 groups")
        # clips a group trains: the valid samples of each task's batch
        self.clips = [sum(int(b["valid"].sum()) for b in g.values())
                      for g in self.groups]
        self.next_index = 0

    def next(self):
        """The next group and the clips it trains."""
        i = self.next_index
        self.next_index = (i + 1) % len(self.groups)
        return self.groups[i], self.clips[i]

    def close(self) -> None:
        self.groups = []


def make(cfg: dict, traffic: dict, seed: int,
         device: torch.device) -> DevicePool:
    return DevicePool(cfg, traffic, seed, device)


def reference_groups(cfg: dict, traffic: dict, seed: int,
                     device: torch.device, n: int) -> List[Dict]:
    """The first ``n`` groups the feed hands out, made again from the
    seed for the reference."""
    return DevicePool(cfg, traffic, seed, device).groups[:n]
