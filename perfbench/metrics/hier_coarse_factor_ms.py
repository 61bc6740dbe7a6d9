"""hier_coarse_factor_ms: device milliseconds a traced step of the kernels
launched inside the program's span `hierarchy.coarse_factor`: the coarsest
level's assembly, equilibration, Cholesky and chunked explicit inverse, 32
systems of 3,584 unknowns at GL (solvers/multigrid.py `_coarse_inverse`).
From the port's own spans (lib/program_spans.py)."""

from perfbench.lib import program_spans


def read(obs):
    red = program_spans.reduce(obs)
    return None if red is None else red.device_ms({"hierarchy.coarse_factor"})
