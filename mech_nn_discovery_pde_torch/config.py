"""Global solver configuration (PyTorch port).

Field-for-field copy of the JAX package's `PDEConfig`, so a configuration
written for one package means the same solve in the other.  Forward and
backward solves read separate budget knobs.

Two policies read `"auto"`; on CUDA (and on the CPU, where the tests run)
the port resolves them as follows:

- `mg_solve_dtype="auto"` -> `"solver"`: the outer FGMRES iterates in the
  solver dtype (float64 when `solver_dbl`).  The H100 has native float64,
  so the reason the TPU build picked float32 there (float64 emulated in
  software) does not apply.  Performance configurations set `"f32"`
  explicitly, as the GL trainer and the benchmark step do.
- `precision="auto"` -> `"f64"`.  Only the dense path reads it
  (`layers/dense.py`): the card has native float64, so the solve stays in
  float64 unless a configuration asks for `"f32_ir"` (float32 factor plus
  float64 PCG refinement; Burgers, `entry()`) or `"f32"`.

Kernel routing is not a config option in the port: on CUDA tensors the
assembled stencil apply and the smoothing pass always run the hand-written
kernels (ops/normal_stencil.py, ops/fused_smoother.py), so
`mg_normal_op="stencil_pallas"` and `"stencil"` select the same path, and so
do `mg_smoother="chebyshev_fused"` and `"chebyshev"`.
"""

import os
from dataclasses import dataclass


@dataclass
class PDEConfig:
    # ---- data locations ----
    data_root: str = "data"

    # ---- multigrid options ----
    # Chebyshev smoother steps per V-cycle leg
    mg_smoother_steps_pre: int = 10
    mg_smoother_steps_post: int = 10

    # V-cycles per preconditioner application
    mg_steps_forward: int = 1
    mg_steps_backward: int = 1

    # FGMRES budgets (restart size x outer restarts)
    mg_fgmres_max_iter_forward: int = 40
    mg_fgmres_restarts_forward: int = 10
    mg_fgmres_max_iter_backward: int = 40
    mg_fgmres_restarts_backward: int = 10

    mg_fgmres_tol: float = 1e-5

    # normal-operator application: 'stencil' / 'stencil_pallas' (assembled
    # block stencil, kernel K1 on CUDA) or 'factored' (A^T (A x) through the
    # structured operators; evolution systems always take it)
    mg_normal_op: str = "stencil"

    # smoother: 'chebyshev' / 'chebyshev_fused' (the same kernel-driven
    # Chebyshev pass in the port) or 'jacobi' (weighted block Jacobi:
    # jacobi_w on the backward solve, jacobi_w_forward on the forward)
    mg_smoother: str = "chebyshev"
    # reuse the Chebyshev recurrence's residual invariant r = b - A x as the
    # V-cycle's restriction input (one fewer apply per level per V-cycle)
    mg_smoother_residual: bool = False
    # FGMRES takes (z, A z) from the preconditioner, A z = r - res_final
    mg_fused_matvec: bool = False
    # Chebyshev smoothing interval is [lmax/ratio, lmax]
    mg_chebyshev_ratio: float = 16.0
    # safety factor on the power-iteration lmax estimate.  LOAD-BEARING:
    # Chebyshev amplifies modes above the assumed lmax explosively
    mg_lmax_margin: float = 1.3
    # smoother block structure: 'line' (time-line blocks) or 'point' (the
    # n_mi x n_mi block of each grid point)
    mg_block_smoother: str = "line"
    # dtype of the STORED preconditioner operators: 'f32', 'bf16' or
    # 'bf16_factored'.  Assembly, factorization, V-cycle vectors and the
    # lmax power iteration stay f32 in every mode.
    # 'bf16' rounds the line-block inverses, the stencil fields and the
    # coarse inverse to bf16.  It is quality-fatal at GL scale: entrywise
    # rounding of the ill-conditioned block inverses makes many of them
    # indefinite, and bf16 stencil fields alone cost much of the quality.
    # 'bf16_factored' stores the PSD square-root factor W = L^-T of each
    # block inverse (B^-1 = W W^T) in bf16 and applies W (W^T r) (kernel
    # K3): round(W) round(W)^T stays PSD by construction, so quality stays
    # at the f32 level; the stencil fields and the coarse inverse stay f32.
    mg_precond_dtype: str = "f32"
    # outer FGMRES dtype: 'solver', 'f32' or 'auto' (-> 'solver', see above)
    mg_solve_dtype: str = "auto"
    jacobi_w: float = 0.4
    jacobi_w_forward: float = 0.45

    # ---- precision policy of the dense path ('auto' -> 'f64') ----
    precision: str = "auto"
    ir_steps: int = 6

    # ---- solve diagnostics ----
    log_solves: bool = False
    check_finite: bool = False
    # return forward-solve stats as the layer's third output (u0, u, stats)
    return_solve_stats: bool = False

    @property
    def ginzburg_dir(self) -> str:
        return os.path.join(self.data_root, "ginzburg")

    @property
    def rheology_dir(self) -> str:
        return os.path.join(self.data_root, "kamani")

    @property
    def burgers_dir(self) -> str:
        return os.path.join(self.data_root, "burgers")


# Module-level default used by layers when no config is passed explicitly.
default_config = PDEConfig()
