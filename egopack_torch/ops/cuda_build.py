"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each kernel source ``ops/csrc/<name>.cu`` exposes a plain C interface and is
compiled at first use into ``egopack_torch/_build/lib<name>-<hash>.so``,
where the hash covers the source and the flags, so an edited source builds
anew. No PyTorch headers are included, which keeps a build to seconds. A
build or load that fails raises; nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, then
    ``PATH``."""
    homes = [os.environ.get("CUDA_HOME"), "/usr/local/cuda"]
    for home in homes:
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the port's CUDA kernels")
    return found


def library_path(name: str, flags: Sequence[str] = ()) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS + BASE_FLAGS + tuple(flags)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, flags: Sequence[str] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(
        f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc(), *ARCH_FLAGS, *BASE_FLAGS, *flags, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit "
                           f"{proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def load(name: str, flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Build if needed, then load once per process. Builds run outside the
    lock, so two kernels can build at once (each into its own temporary
    file, renamed into place)."""
    with _LOCK:
        lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = build(name, flags)
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(path))
        return _LIBS[name]
