"""fgmres_rel_resid_bwd: the IFT backward solve's relative residual, FGMRES's
final true residual over the norm of its right-hand side: the largest over
a solve's samples, then the mean over the traced steps' backward solves.
The program's counter `fgmres.rel_resid.bwd` (solvers/multigrid.py
`MultigridNormalSolver.resolve`; lib/program_spans.py)."""

from perfbench.lib import program_spans


def read(obs):
    red = program_spans.reduce(obs)
    got = [] if red is None else red.counters.get("fgmres.rel_resid.bwd", [])
    return sum(float(t.max()) for _, t in got) / len(got) if got else None
