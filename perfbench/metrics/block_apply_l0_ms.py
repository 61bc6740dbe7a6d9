"""block_apply_l0_ms: device milliseconds a traced step of the kernels
launched inside the program's spans `vcycle.block_apply` at level 0: the
smoother's block applies there (K2 or K3 on the route the span's `route`
names; solvers/multigrid.py `_smooth`), not the lmax power iteration's.
From the port's own spans (lib/program_spans.py); None where the program
records no such span."""

from perfbench.lib import program_spans

LEVEL = 0


def read(obs):
    red = program_spans.reduce(obs)
    if red is None:
        return None
    mine = {i for i, s in enumerate(red.spans)
            if s.name == "vcycle.block_apply" and s.attrs.get("level") == LEVEL}
    if not mine:
        return None
    return 1e3 * sum(d for d, _, i in red.kernels if i in mine) / red.n_steps
