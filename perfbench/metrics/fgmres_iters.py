"""fgmres_iters: forward FGMRES iterations a step, the mean over samples
and over every step of the traced run's window, from the solver's own
iteration counts (the multigrid layer's solves; nothing to read on a dense
layer)."""


def read(obs):
    it = obs.iters.get("fwd_mean", [])
    return sum(it) / len(it) if it else None
