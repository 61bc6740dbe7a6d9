"""dense_precond_ms: device milliseconds a traced step of the kernels
launched inside the program's span `dense.precond`: the f32_ir PCG's
preconditioner applications, two triangular solves each on the f32 factor,
forward and backward (solvers/cholesky.py).  From the port's own spans
(lib/program_spans.py)."""

from perfbench.lib import program_spans


def read(obs):
    red = program_spans.reduce(obs)
    return None if red is None else red.device_ms({"dense.precond"})
