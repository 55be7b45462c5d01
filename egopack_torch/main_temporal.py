"""Phase-1 multi-task training, the port's CLI (counterpart of the
repository's ``main_temporal.py``).

Hydra-style ``key=value`` overrides against the repository's ``configs/``
tree, e.g.::

    python -m egopack_torch.main_temporal k=1 num_epochs=40 batch_size=16 \\
        model.hidden_size=1024 model.temporal_pooling.hidden_size=1024 \\
        model.temporal_pooling.dropout=0.5 save_model=True \\
        enabled_tasks=[ar,lta,pnr] optimizer.impl=fused

It trains on the card; ``device=cpu`` runs it on the CPU.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from .config import compose, default_config_dir
from .train.driver import train_mtl


def main(argv: Optional[List[str]] = None):
    cfg = compose(default_config_dir(), "defaults",
                  overrides=argv if argv is not None else sys.argv[1:])
    return train_mtl(cfg)


if __name__ == "__main__":
    main()
