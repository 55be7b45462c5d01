"""ctypes bindings for the native host gather (the port's copy of
``egopack_tpu/io/native.py``), built with ``g++`` at first use.

``native/gather.cpp`` is compiled into
``egopack_torch/_build/libgather-<hash>.so`` (the hash covers the source
and the flags). The numpy path is its plain twin: same indices, same
clamping, same zero fill and, as the library is built without FMA
contraction, the same interpolation bit for bit. ``EGOPACK_NATIVE_IO=0``
selects the numpy path; a failed build falls back to it and says so in the
log. :data:`PATH_CALLS` counts the calls that took each path.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parent / "native" / "gather.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC",
         "-pthread")

# calls per path, for the log and for checks that the native one ran
PATH_CALLS: Dict[str, int] = {"native": 0, "numpy": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libgather-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        tmp.unlink(missing_ok=True)
        logger.warning("native gather build failed (%s); the numpy path "
                       "gathers features", e)
        return False
    os.replace(tmp, out)  # atomic: another process never sees half a file
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("EGOPACK_NATIVE_IO", "1") == "0":
            logger.info("EGOPACK_NATIVE_IO=0: the numpy path gathers "
                        "features")
            return None
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        lib = ctypes.CDLL(str(path))
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.gather_rows_mt.argtypes = [f32p, ctypes.c_int64, ctypes.c_int64,
                                       i64p, ctypes.c_int64, f32p, ctypes.c_int]
        lib.gather_rows_mt.restype = None
        lib.gather_interp.argtypes = [f32p, ctypes.c_int64, ctypes.c_int64,
                                      i64p, i64p, f32p, ctypes.c_int64, f32p]
        lib.gather_interp.restype = None
        logger.info("native gather: %s", path)
        _lib = lib
        return _lib


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def default_io_threads() -> int:
    """``EGOPACK_IO_THREADS``, else the host's core count."""
    env = os.environ.get("EGOPACK_IO_THREADS")
    if env:
        return max(1, int(env))
    return max(1, os.cpu_count() or 1)


def gather_rows(src: np.ndarray, idx: np.ndarray,
                out: Optional[np.ndarray] = None,
                n_threads: Optional[int] = None) -> np.ndarray:
    """out[i] = src[clamp(idx[i])]; a negative index gives a zero row.

    Gathers under 1 MiB (the per-sample ones) stay on one thread; larger
    ones use :func:`default_io_threads` unless ``n_threads`` is given."""
    if n_threads is None:
        n_threads = (default_io_threads()
                     if idx.size * src.shape[1] * 4 >= (1 << 20) else 1)
    lib = get_lib()
    idx = np.ascontiguousarray(idx, np.int64)
    n, dim = len(idx), src.shape[1]
    if out is None:
        out = np.empty((n, dim), np.float32)
    if lib is None or src.dtype != np.float32:
        PATH_CALLS["numpy"] += 1
        clamped = np.clip(idx, 0, src.shape[0] - 1)
        np.take(src, clamped, axis=0, out=out)
        out[idx < 0] = 0.0
        return out
    if out.dtype != np.float32 or out.shape != (n, dim) \
            or not out.flags["C_CONTIGUOUS"]:
        raise ValueError("out must be a C-contiguous float32 (n, dim) array")
    PATH_CALLS["native"] += 1
    src = src if src.flags["C_CONTIGUOUS"] else np.ascontiguousarray(src)
    lib.gather_rows_mt(_f32p(src), src.shape[0], dim, _i64p(idx), n,
                       _f32p(out), n_threads)
    return out


def gather_interp(src: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                  frac: np.ndarray) -> np.ndarray:
    """PNR fractional-stride interpolation:
    ``(1 - frac) * src[lo] + frac * src[hi]``, a plain copy where the two
    rows are the same (see gather.cpp)."""
    lib = get_lib()
    n, dim = len(lo), src.shape[1]
    if lib is None or src.dtype != np.float32:
        PATH_CALLS["numpy"] += 1
        lo_c = np.clip(lo, 0, src.shape[0] - 1)
        hi_c = np.clip(hi, 0, src.shape[0] - 1)
        low = np.take(src, lo_c, axis=0).astype(np.float32)
        high = np.take(src, hi_c, axis=0).astype(np.float32)
        out = (1 - frac)[:, None] * low + frac[:, None] * high
        out[lo_c == hi_c] = low[lo_c == hi_c]
        return out.astype(np.float32)
    if not (len(hi) == len(frac) == n):
        raise ValueError("lo, hi and frac must have the same length")
    PATH_CALLS["native"] += 1
    src = src if src.flags["C_CONTIGUOUS"] else np.ascontiguousarray(src)
    out = np.empty((n, dim), np.float32)
    lib.gather_interp(_f32p(src), src.shape[0], dim,
                      _i64p(np.ascontiguousarray(lo, np.int64)),
                      _i64p(np.ascontiguousarray(hi, np.int64)),
                      _f32p(np.ascontiguousarray(frac, np.float32)),
                      n, _f32p(out))
    return out
