"""k3_roofline_pct: the smoother's factored block apply's share of its
roofline in the traced steps: the least time of every K3 application the
solver's configuration and its solves' iterations call for
(work/multigrid_factored.py, all levels), over the device time of the
kernels named KERNELS (K3 on every route: streamed, cluster, two-sweep,
point)."""

from perfbench.lib.common import load_module

KERNELS = ("k3_factored_line_block_apply", "k3_factored_line_block_apply_cluster",
           "k3_factored_line_block_apply_tiled", "k3_point_block_apply")


def read(obs):
    tr = obs.trace
    if tr is None or "multigrid_factored" not in obs.config.get("work", []):
        return None
    dev = tr.device_s(names=KERNELS)
    if dev <= 0:
        return None
    ops = load_module("work", "multigrid_factored", obs.bench).ops(obs.config, obs.traced,
                                                                    tr.n_steps)
    return 100.0 * sum(o.least_s for o in ops if o.name.startswith("k3.")) / dev
