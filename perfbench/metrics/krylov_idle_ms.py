"""krylov_idle_ms: device-idle milliseconds a traced step while the host's
innermost program span is FGMRES's own bookkeeping: `fgmres.ortho` (CGS2),
`fgmres.givens`, `fgmres.backsub` or `fgmres.check` (a window's residual and
flag read; solvers/krylov.py).  From the port's own spans
(lib/program_spans.py)."""

from perfbench.lib import program_spans

SPANS = ("fgmres.ortho", "fgmres.givens", "fgmres.backsub", "fgmres.check")


def read(obs):
    red = program_spans.reduce(obs)
    return None if red is None else red.idle_ms(lambda name: name in SPANS)
