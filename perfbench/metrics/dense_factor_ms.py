"""dense_factor_ms: device milliseconds a step in the dense layer's library
kernels (Cholesky, triangular solves, the products inside them) launched
inside its factor and its solves (profiler ranges `bench.dense_factor` and
`bench.dense_solve`), per traced step.  Names: PATTERNS."""

PATTERNS = (r"potrf", r"trsm", r"trsv", r"syrk", r"herk", r"gemm", r"gemv", r"cholesky",
            r"magma", r"getrf", r"trtri", r"potri", r"sm\d+_xmma", r"cutlass")


def read(obs):
    tr = obs.trace
    if tr is None or "dense_factor" not in tr.ranges:
        return None
    s = sum(tr.device_s(patterns=PATTERNS, launched_in=r) for r in ("dense_factor", "dense_solve"))
    return 1e3 * s / tr.n_steps
