"""hier_block_factor_ms: device milliseconds a traced step of the kernels
launched inside the program's span `hierarchy.block_factor`: the smoothed
levels' time-line (or point) block factorizations and inverses, 32 x 1,024
blocks of 56 x 56 at GL's fine level (solvers/multigrid.py
`_block_inverse`).  From the port's own spans (lib/program_spans.py)."""

from perfbench.lib import program_spans


def read(obs):
    red = program_spans.reduce(obs)
    return None if red is None else red.device_ms({"hierarchy.block_factor"})
