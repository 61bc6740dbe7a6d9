"""vcycle_idle_ms: device-idle milliseconds a traced step while the host's
innermost program span is one of the V-cycle's (`vcycle.smooth_pre`,
`.restrict`, `.coarse`, `.prolong`, `.smooth_post`, every level;
solvers/multigrid.py `v_cycle`): the host loop of K1 and K2 launches.  From
the port's own spans (lib/program_spans.py)."""

from perfbench.lib import program_spans


def read(obs):
    red = program_spans.reduce(obs)
    return None if red is None else red.idle_ms(lambda name: name.startswith("vcycle."))
