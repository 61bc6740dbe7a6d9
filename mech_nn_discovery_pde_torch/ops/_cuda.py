"""Build, load and count the port's hand-written CUDA kernels.

Each source in `mech_nn_discovery_pde_torch/csrc/` compiles with `nvcc` for
`sm_90a` into its own shared library with a plain C interface, under
`mech_nn_discovery_pde_torch/_build/` (git-ignored), at first use; a library
older than its source is rebuilt.  Libraries load with ctypes; wrappers pass
`data_ptr()`s and the current stream.  Nothing is built or loaded at import
time, so the CPU tests import every module freely.

A failed build or launch raises; there is no fallback.  `LAUNCHES` counts
kernel launches by kernel name (one per launch, incremented by the wrapper
that launches); `chip_smoke.py` resets it before the main path and reads it
after.  `WINDOW_LAUNCHES` counts, by the same names, the K1 launches among
them whose output window is not the whole grid (the sp-sharded apply).
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC"]

# library name -> source file; each library exports <kernel>_<dtype> launchers
# (<dtype> names the stored operand; bf16 launchers take f32 vectors)
SOURCES = {"stencil_apply": "stencil_apply.cu", "line_block": "line_block.cu",
           "point_block": "point_block.cu"}

LAUNCHES: collections.Counter = collections.Counter()
WINDOW_LAUNCHES: collections.Counter = collections.Counter()
_LIBS: Dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # coef, x, the layout (n_coord, order, s0, s1; ops/normal_stencil.
    # k1_layout_args), (N, the output window p_begin, n_out, bs), the launch
    # geometry (P, threads, grid_x; ops/normal_stencil.stencil_geometry), rin,
    # out, xin, xout, stream
    "stencil_apply": {
        "k1_stencil_apply_f32": [_P] * 2 + [_I] * 11 + [_P] * 5,
        "k1_stencil_apply_f64": [_P] * 2 + [_I] * 11 + [_P] * 5,
        "k1_stencil_apply_bf16": [_P] * 2 + [_I] * 11 + [_P] * 5,
    },
    # operands, (m, nt, S, bs), the launch geometry (ctas, panel rows,
    # stages, smem_bytes, flags; ops/fused_smoother.line_block_geometry and
    # line_block_launch_args), stream
    "line_block": {
        "k2_line_block_apply_f32": [_P] * 5 + [_I] * 9 + [_P],
        "k2_line_block_apply_bf16": [_P] * 5 + [_I] * 9 + [_P],
        "k3_factored_line_block_apply_bf16": [_P] * 5 + [_I] * 9 + [_P],
    },
    # operands, (bw, S, bs), the launch geometry (ctas, tile, stages,
    # smem_bytes, bulk; ops/fused_smoother.point_block_geometry), stream
    "point_block": {
        "k2_point_block_apply_f32": [_P] * 5 + [_I] * 8 + [_P],
        "k2_point_block_apply_bf16": [_P] * 5 + [_I] * 8 + [_P],
        "k3_point_block_apply_bf16": [_P] * 5 + [_I] * 8 + [_P],
    },
}
_ERROR_FN = {"stencil_apply": "k1_error_string", "line_block": "k2_error_string",
             "point_block": "point_block_error_string"}


def nvcc_path() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib, src = _lib_path(name), CSRC / SOURCES[name]
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def build(names: Iterable[str] = tuple(SOURCES), ptxas: bool = False) -> Dict[str, str]:
    """Compile every stale library in `names`, one nvcc per source, all
    started together.  Returns nvcc's output by library built, with `ptxas`
    also ptxas's report of each kernel (registers, stack frame, spills).
    Raises with nvcc's output on failure."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = _lib_path(n).with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas else []),
               "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    failed, outs = [], {}
    for n, (p, tmp) in procs.items():
        out, _ = p.communicate()
        outs[n] = out
        if p.returncode != 0:
            failed.append(f"nvcc {SOURCES[n]} failed ({p.returncode}):\n{out}")
        else:
            os.replace(tmp, _lib_path(n))
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if missing or stale."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        err = getattr(lib, _ERROR_FN[name])
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(name: str, kernel: str, code: int, windowed: bool = False) -> None:
    """Raise if a launcher returned a CUDA error; count the launch if not
    (also in WINDOW_LAUNCHES when `windowed`)."""
    if code != 0:
        text = getattr(library(name), _ERROR_FN[name])(code).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} ({text})")
    LAUNCHES[kernel] += 1
    if windowed:
        WINDOW_LAUNCHES[kernel] += 1


def ptr(t) -> int | None:
    """data_ptr of a tensor, None for None (a null pointer)."""
    return None if t is None else t.data_ptr()


def stream_ptr(device: torch.device) -> int:
    """The current stream of a CUDA device, as the raw pointer a launcher
    takes (without building a torch.cuda.Stream object on every launch)."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(idx)


_SM_COUNT: Dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (read at first launch)."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    n = _SM_COUNT.get(idx)
    if n is None:
        n = _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return n


def require_cuda(*tensors) -> None:
    """Check that kernel operands are contiguous CUDA tensors on one device."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError("kernel operand is not a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError("kernel operand is not contiguous")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError("kernel operands lie on different devices")
