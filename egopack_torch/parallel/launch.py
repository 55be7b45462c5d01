"""Start N ranks of one command on this machine, as ``torchrun`` would,
each with its own time limit.

``run_ranks`` gives each process the variables of ``torch.distributed``'s
``env://`` rendezvous (``MASTER_ADDR=localhost``, a free ``MASTER_PORT``,
``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``) and waits for all of them. A rank
that fails or outlives its limit ends the others: a rank left waiting at a
collective for a peer that is gone would wait forever.
"""

from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence


@dataclass
class RankResult:
    rank: int
    returncode: int
    stdout: str
    stderr: str
    ended: bool = False  # killed by the launcher, after another failed
    timed_out: bool = False


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int,
             base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    env = dict(os.environ if base is None else base)
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
               RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    return env


def run_ranks(argv: Sequence[str], nproc: int, timeout: float,
              env: Optional[Dict[str, str]] = None,
              cwd: Optional[str] = None) -> List[RankResult]:
    """Run ``argv`` as ranks ``0..nproc-1`` of one world and return each
    rank's exit code and output. Every rank is ended once one fails or
    ``timeout`` seconds have passed."""
    port = free_port()
    procs, files = [], []
    try:
        for r in range(nproc):
            out = tempfile.TemporaryFile("w+")
            err = tempfile.TemporaryFile("w+")
            files.append((out, err))
            procs.append(subprocess.Popen(
                list(argv), stdout=out, stderr=err, cwd=cwd,
                env=rank_env(r, nproc, port, env)))
        deadline = time.monotonic() + timeout
        late = False
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                late = True
                break
            time.sleep(0.1)
        ended = {r for r, p in enumerate(procs) if p.poll() is None}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    results = []
    for r, (p, (out, err)) in enumerate(zip(procs, files)):
        out.seek(0)
        err.seek(0)
        results.append(RankResult(r, p.returncode, out.read(), err.read(),
                                  r in ended, late and r in ended))
        out.close()
        err.close()
    return results


def check_ranks(results: List[RankResult], what: str) -> None:
    """Raise with the first failed rank's error output unless every rank
    exited 0."""
    for res in sorted(results, key=lambda res: (res.ended, res.rank)):
        if res.returncode != 0:
            why = ("timed out" if res.timed_out else "was ended"
                   if res.ended else f"exited {res.returncode}")
            raise RuntimeError(f"{what}: rank {res.rank} {why}:\n"
                               f"{res.stderr[-4000:]}")
