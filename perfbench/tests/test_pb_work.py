"""The yardstick's operation and byte counts against hand counts."""

import pytest

from perfbench.lib import roofline
from perfbench.lib.harness import Observed
from perfbench.lib.common import BENCH, config, load_module
from perfbench.work import dense, multigrid, paramnet, resnet

GL = config("gl")


def small_mg(**pde):
    cfg = {"solver_dim": [6, 12, 12], "n_grid": 2, "downsample_first": False, "batch_size": 2,
           "pde": dict(GL["pde"], mg_smoother_steps_pre=2, mg_smoother_steps_post=3,
                       mg_fgmres_restarts_forward=2, mg_fgmres_restarts_backward=2)}
    cfg["pde"].update(pde)
    return cfg


def test_multigrid_counts_by_hand():
    # 1 step: forward 4 iterations (2 windows of 2), backward 2 (1 window)
    ops = {o.name: o for o in multigrid.ops(small_mg(), {"fwd_max": [4], "bwd_max": [2]}, 1)}
    vcycles = 2 * 2 + 1 * 2
    # level 0: lmax 21; a V-cycle 2 + 3 + 2 (residual and the post pass's
    # first apply); FGMRES: per solve 1, per window 1 + R + 1
    assert ops["k1.level0"].count == 21 + vcycles * 7 + (1 + 2 * 4) + (1 + 1 * 4)
    assert ops["k2.level0"].count == 21 + vcycles * 5
    assert "k1.level1" not in ops  # n_grid 2: level 1 is the coarsest
    assert ops["coarse_apply"].count == vcycles
    # the fused matvec and the residual reuse each save an apply
    fused = {o.name: o for o in multigrid.ops(
        small_mg(mg_fused_matvec=True, mg_smoother_residual=True),
        {"fwd_max": [4], "bwd_max": [2]}, 1)}
    assert fused["k1.level0"].count == 21 + vcycles * 6 + (1 + 2 * 2) + (1 + 1 * 2)


def test_gl_counts_match_the_launches_of_three_trainer_steps():
    # the port's launch counts of 3 GL trainer steps at 40 + 40 iterations
    # (K1 10980, K2 9726), from the configuration alone
    ops = multigrid.ops(GL, {"fwd_max": [40] * 3, "bwd_max": [40] * 3}, 3)
    assert sum(o.count for o in ops if o.name.startswith("k1.")) == 10980
    assert sum(o.count for o in ops if o.name.startswith("k2.")) == 9726


def test_stencil_bands_and_bytes():
    assert multigrid.bands((8, 32, 32)) == 60  # 109 fields - 7 * 7
    assert multigrid.bands((32, 32)) == 40
    k1 = next(o for o in multigrid.ops(GL, {"fwd_max": [10], "bwd_max": [10]}, 1)
              if o.name == "k1.level0")
    N, bs, m = 8 * 32 * 32, 32, 7
    assert k1.bytes == 4 * (109 + 2 * m) * N * bs
    assert k1.flops == 2 * (m * m + 2 * 60) * N * bs


def test_stencil_bands_match_the_port():
    from mech_nn_discovery_pde_torch.ops.normal_stencil import make_desc
    from mech_nn_discovery_pde_torch.ops.system import PDESystem

    for dims in [(8, 32, 32), (8, 16, 16), (6, 12, 12), (32, 32)]:
        s = PDESystem.build(dims, order=2, init_index_mi_list=[], n_iv=1, step_size=0.01)
        assert len(make_desc(s.spec).bands) == multigrid.bands(dims)


def test_block_apply_bound():
    op = roofline.block_apply(10, 56, 1000)
    assert op.flops == 2 * 10 * 56 * 56
    assert op.bytes == 4 * 10 * 56 * 56 + 8 * 1000
    k3 = roofline.block_apply(10, 56, 1000, entry_bytes=2, factored=True)
    assert k3.flops == 4 * 10 * 56 * 57 // 2
    assert roofline.least_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.least_s(0, 67e12) == pytest.approx(1.0)


def test_dense_and_network_counts():
    cfg = config("burgers")
    ops = {o.name: o for o in dense.ops(cfg, None, 1)}
    n = 32 * 32 * 5
    assert ops["dense.cholesky"].count == 10 and ops["dense.cholesky"].flops == n**3 / 3
    assert ops["dense.trsv"].count == 10 * 2 * 2 * (6 + 1)
    conv = {o.name: o for o in resnet.ops(cfg, None, 1)}
    assert conv["resnet.conv1"].flops == 2 * 128 * 128 * 25 * 128 * 256
    assert conv["resnet.conv0"].count == 2 and conv["resnet.conv1"].count == 3
    pn = paramnet.ops(cfg, None, 2)[0]
    assert pn.count == 3 * 2 and pn.flops == 6 * (512 * 1024 + 2 * 1024 * 1024 + 1024 * 5)


class _Trace:
    window_s = 2.0
    n_steps = 1
    busy_s = 1.5
    ranges = {}

    def device_s(self, names=(), patterns=(), launched_in=None):
        return 0.5


def test_step_mfu_and_idle_share_read_their_sums():
    tr = _Trace()
    obs = Observed(GL, {}, {}, {"fwd_max": [40], "bwd_max": [40]}, tr, BENCH)
    total = sum(o.least_s for k in GL["work"]
                for o in load_module("work", k).ops(GL, obs.traced, 1))
    assert load_module("metrics", "step_mfu").read(obs) == pytest.approx(100 * total / 2.0)
    assert load_module("metrics", "idle_share").read(obs) == pytest.approx(25.0)
    k1 = sum(o.least_s for o in multigrid.ops(GL, obs.traced, 1) if o.name.startswith("k1."))
    assert load_module("metrics", "k1_roofline_pct").read(obs) == pytest.approx(100 * k1 / 0.5)
    # nothing to read: no value, never 0
    none = Observed(GL, {}, {}, {}, None, BENCH)
    for m in ("step_mfu", "k1_roofline_pct", "k2_roofline_pct", "idle_share",
              "batch_host_ms", "fgmres_iters", "fgmres_iters_bwd", "hier_factor_ms"):
        assert load_module("metrics", m).read(none) is None
