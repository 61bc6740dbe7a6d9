"""k1_roofline_pct: the block-stencil AtA apply's share of its roofline in
the traced steps: the least time of every application the solver's
configuration and its solves' iterations call for (work/multigrid.py, all
levels), over the device time of the kernels named KERNELS."""

from perfbench.lib.common import load_module

KERNELS = ("k1_stencil_apply",)


def read(obs):
    tr = obs.trace
    if tr is None or "multigrid" not in obs.config.get("work", []):
        return None
    dev = tr.device_s(names=KERNELS)
    if dev <= 0:
        return None
    ops = load_module("work", "multigrid", obs.bench).ops(obs.config, obs.traced, tr.n_steps)
    return 100.0 * sum(o.least_s for o in ops if o.name.startswith("k1.")) / dev
