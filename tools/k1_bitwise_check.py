"""Hold K1's launches over the whole grid to another build of K1, bit for bit.

    python3 tools/k1_bitwise_check.py OTHER_STENCIL_APPLY_CU

builds OTHER_STENCIL_APPLY_CU (a `csrc/stencil_apply.cu` whose launchers take
no output window, as before the window was added) with the port's nvcc
flags into a temporary directory, and compares it with this checkout's K1
(window (0, N)) on the same random operands: every (n_coord, order) layout
in f32, f64 and bf16 fields, with and without the epilogue, at the GL
shapes (bs 32, (8, 32, 32) and (8, 16, 16)) and at shapes that take one
point and 16-byte loads a thread.  Prints the count of differing cases and
exits nonzero if any differs.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mech_nn_discovery_pde_torch.ops import _cuda  # noqa: E402
from mech_nn_discovery_pde_torch.ops import normal_stencil as ns  # noqa: E402
from mech_nn_discovery_pde_torch.ops.system import PDESystem  # noqa: E402

IVS = {1: [lambda n: (0, 0, [0], [0])],
       2: [lambda a, b: (0, 0, [0, 0], [0, b - 1])],
       3: [lambda a, b, c: (0, 0, [0, 0, 0], [0, b - 1, c - 1])]}
CASES = [((8, 32, 32), 32), ((8, 16, 16), 32), ((10,), 3), ((12, 9), 5), ((6, 7, 8), 3),
         ((6, 7, 8), 264), ((8, 512), 5)]
LAUNCHER = {torch.float32: "k1_stencil_apply_f32", torch.float64: "k1_stencil_apply_f64",
            torch.bfloat16: "k1_stencil_apply_bf16"}
TYPES = ((torch.float32, torch.float32), (torch.float64, torch.float64),
         (torch.bfloat16, torch.float32))


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "libother.so")
        subprocess.run([_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o", so, sys.argv[1]], check=True)
        other = ctypes.CDLL(so)
        for fn in LAUNCHER.values():
            getattr(other, fn).argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + \
                [ctypes.c_void_p] * 5
            getattr(other, fn).restype = ctypes.c_int
        n_cases = n_diff = 0
        for dims, bs in CASES:
            for order in (1, 2):
                sys_ = PDESystem.build(dims, order=order, init_index_mi_list=IVS[len(dims)],
                                       n_iv=1, step_size=0.1)
                desc = ns.make_desc(sys_.spec)
                n_coord, order_, s0, s1 = ns.k1_layout_args(desc)
                g = torch.Generator(device=dev).manual_seed(1)
                for cdt, xdt in TYPES:
                    coef = torch.randn((bs, desc.n_channels, desc.grid_size), generator=g,
                                       device=dev).to(cdt)
                    x, b, x0 = (torch.randn((bs, sys_.num_vars), generator=g, device=dev)
                                .to(xdt) for _ in range(3))
                    for epilogue in (False, True):
                        xo, xo_other = torch.empty_like(x), torch.empty_like(x)
                        ep = dict(rin=b, xin=x0, xout=xo) if epilogue else {}
                        y = ns.stencil_apply(desc, coef, x, **ep)
                        geo = ns.stencil_geometry(desc.grid_size, bs, x.element_size(),
                                                  _cuda.sm_count(dev))
                        y_other = torch.empty_like(x)
                        code = getattr(other, LAUNCHER[cdt])(
                            coef.data_ptr(), x.data_ptr(), n_coord, order_, s0, s1,
                            desc.grid_size, bs, geo.P, geo.threads, geo.grid[0],
                            _cuda.ptr(b if epilogue else None), y_other.data_ptr(),
                            _cuda.ptr(x0 if epilogue else None),
                            _cuda.ptr(xo_other if epilogue else None), _cuda.stream_ptr(dev))
                        if code != 0:
                            raise RuntimeError(f"the other K1 failed: CUDA error {code}")
                        same = torch.equal(y, y_other) and (
                            not epilogue or torch.equal(xo, xo_other))
                        n_cases += 1
                        n_diff += not same
                        if not same:
                            print(f"differs: dims {dims} order {order} bs {bs} {cdt} "
                                  f"epilogue {epilogue}", flush=True)
    print(f"K1 against {sys.argv[1]}: {n_diff} of {n_cases} cases differ", flush=True)
    return 1 if n_diff else 0


if __name__ == "__main__":
    sys.exit(main())
