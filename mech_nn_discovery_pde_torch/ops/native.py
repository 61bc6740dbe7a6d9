"""ctypes bridge to the C++ assembly core (csrc/assembly.cpp): the AtA pair
tables, on the host.

The library compiles at first use with `g++ -O3 -shared -fPIC -std=c++17`
into `mech_nn_discovery_pde_torch/_build/` (git-ignored), beside the CUDA
kernels, and is rebuilt when the source is newer; nothing is built at
import.  Where it does not build or load, `build_pairs_sorted` returns None
and `PDESystem` takes its NumPy twin, `pairs_sorted_numpy`, which yields
the same tables in the same order; `available()` says which, and `error()`
why the library did not load.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG / "csrc" / "assembly.cpp"
LIB = _PKG / "_build" / "libassembly.so"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LOCK = threading.Lock()
_STATE = {"lib": None, "tried": False, "error": None}


def _build() -> None:
    """Compile the library into a temporary file and move it into place (so
    concurrent builders never load a half-written one)."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise FileNotFoundError("g++ not found on PATH")
    LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB.with_suffix(f".so.tmp{os.getpid()}")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ {SRC.name} failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIB)


def _load() -> Optional[ctypes.CDLL]:
    with _LOCK:
        if _STATE["tried"]:
            return _STATE["lib"]
        _STATE["tried"] = True
        try:
            if not LIB.exists() or LIB.stat().st_mtime < SRC.stat().st_mtime:
                _build()
            L = ctypes.CDLL(str(LIB))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _STATE["error"] = f"{type(e).__name__}: {e}"
            return None
        L.count_pairs.restype = ctypes.c_int64
        L.count_pairs.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        L.build_pairs_sorted.restype = None
        L.build_pairs_sorted.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [
            ctypes.c_void_p] * 3
        _STATE["lib"] = L
        return L


def available() -> bool:
    """Whether the native library built and loaded."""
    return _load() is not None


def error() -> Optional[str]:
    """Why the library did not load (None if it did, or was not tried)."""
    _load()
    return _STATE["error"]


def build_pairs_sorted(
    rows: np.ndarray, cols: np.ndarray, num_vars: int
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """All ordered entry pairs (pa, pb) sharing a row, with their AtA
    targets lin = cols[pa] * num_vars + cols[pb], sorted by lin (ties in
    (pa, pb) order), as int64 arrays; None if the library is unavailable.
    rows must be non-decreasing."""
    L = _load()
    if L is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    n = rows.shape[0]
    total = L.count_pairs(rows.ctypes.data, n)
    pa = np.empty(total, dtype=np.int32)
    pb = np.empty(total, dtype=np.int32)
    lin = np.empty(total, dtype=np.int64)
    L.build_pairs_sorted(rows.ctypes.data, cols.ctypes.data, n, int(num_vars),
                         pa.ctypes.data, pb.ctypes.data, lin.ctypes.data)
    return pa.astype(np.int64), pb.astype(np.int64), lin


def pairs_sorted_numpy(rows: np.ndarray, cols: np.ndarray, num_vars: int):
    """`build_pairs_sorted` in NumPy: the same tables in the same order."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if np.any(np.diff(rows) < 0):
        raise ValueError("pairs_sorted_numpy: rows must be non-decreasing")
    counts = np.bincount(rows)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    pa_parts, pb_parts = [], []
    for k in np.unique(counts):
        if k == 0:
            continue
        ent = offsets[np.nonzero(counts == k)[0]][:, None] + np.arange(k)[None, :]
        pa_parts.append(np.repeat(ent, k, axis=1).ravel())
        pb_parts.append(np.tile(ent, (1, k)).ravel())
    pa, pb = np.concatenate(pa_parts), np.concatenate(pb_parts)
    lin = cols[pa] * num_vars + cols[pb]
    perm = np.lexsort((pb, pa, lin))
    return pa[perm], pb[perm], lin[perm]

