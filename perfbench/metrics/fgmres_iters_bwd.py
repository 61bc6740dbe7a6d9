"""fgmres_iters_bwd: backward (IFT) FGMRES iterations a step, the mean over
samples and over every step of the traced run's window, from the solver's
own iteration counts (the multigrid layer's solves; nothing to read on a
dense layer).  The backward solve stops at its tolerance, so this count
moves as training goes on, where the forward's stays at its budget."""


def read(obs):
    it = obs.iters.get("bwd_mean", [])
    return sum(it) / len(it) if it else None
