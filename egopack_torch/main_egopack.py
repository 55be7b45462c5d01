"""Phase-2 EgoPack novel-task training, the port's CLI (counterpart of the
repository's ``main_egopack.py``).

Hydra-style ``key=value`` overrides against the repository's ``configs/``
tree, from a phase-1 artifact, e.g.::

    python -m egopack_torch.main_egopack enable_graphone=True \\
        enabled_tasks=[oscc] resume_from=MTL_ar-lta-pnr graphone.k=4 \\
        graphone.residual=True num_epochs=10 optimizer.lr=1e-6 \\
        task_head_dropout=0.5 backprop_temporal_graph=True \\
        temporal_graph_train_mode=True optimizer.impl=fused

It trains on the card; ``device=cpu`` runs it on the CPU.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from .config import compose, default_config_dir
from .train.driver import train_egopack


def main(argv: Optional[List[str]] = None):
    cfg = compose(default_config_dir(), "defaults",
                  overrides=argv if argv is not None else sys.argv[1:])
    return train_egopack(cfg)


if __name__ == "__main__":
    main()
