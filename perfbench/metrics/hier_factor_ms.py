"""hier_factor_ms: device milliseconds a step in the library kernels of the
multigrid hierarchy's batched factorizations (Cholesky, triangular solves
and the products inside them), launched inside the hierarchy build (profiler
range `bench.hierarchy`), per traced step.  Names: PATTERNS."""

PATTERNS = (r"potrf", r"trsm", r"trsv", r"syrk", r"herk", r"gemm", r"gemv", r"cholesky",
            r"magma", r"getrf", r"trtri", r"potri", r"sm\d+_xmma", r"cutlass")


def read(obs):
    tr = obs.trace
    if tr is None or "hierarchy" not in tr.ranges:
        return None
    return 1e3 * tr.device_s(patterns=PATTERNS, launched_in="hierarchy") / tr.n_steps
