"""step_mfu: the whole step's share of the chip's peak: the least time of
every operation of the traced steps that the configuration's work files
count (`work` in configs/<config>.json: the layer's solves, factorizations
and orthogonalisation, the networks' matmuls and convolutions, Adam), over
the traced window's length."""

from perfbench.lib.common import load_module


def read(obs):
    tr = obs.trace
    if tr is None or tr.window_s <= 0:
        return None
    total = 0.0
    for kind in obs.config.get("work", []):
        ops = load_module("work", kind, obs.bench).ops(obs.config, obs.traced, tr.n_steps)
        total += sum(o.least_s for o in ops)
    return 100.0 * total / tr.window_s if total > 0 else None
