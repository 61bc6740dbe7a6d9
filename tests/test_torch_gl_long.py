"""GL discovery on a long time window through the port's trainer, on the
CPU at a tiny size: `GLConfig.downsample_first` reaches the multigrid layer
(False by default, as the published setting and `gl-train` have it), and
with it True a trainer on (12, 12, 12) patches, n_grid 2, bs 2, in
'bf16_factored' storage builds time-halved levels and takes a finite Adam
step, its block applies traced with their level, route, storage and W's
layout (dense at bw 84); the factor W of blocks K3 takes on a cluster is
stored packed, with the dense factor's values.
Imports nothing of JAX; a few seconds."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mech_nn_discovery_pde_torch.config import PDEConfig
from mech_nn_discovery_pde_torch.discovery.common import make_update
from mech_nn_discovery_pde_torch.discovery.ginzburg_landau import GLConfig, GLDiscovery
from mech_nn_discovery_pde_torch.utils import profiling

torch.set_num_threads(1)


class _DS:
    t_step_size = 0.2
    x_step_size = y_step_size = 0.3906


def _model(**kw):
    pde = PDEConfig(precision="f32_ir", mg_solve_dtype="f32", mg_precond_dtype="bf16_factored",
                    mg_smoother_steps_pre=2, mg_smoother_steps_post=2,
                    mg_fgmres_max_iter_forward=4, mg_fgmres_restarts_forward=2,
                    mg_fgmres_max_iter_backward=4, mg_fgmres_restarts_backward=2,
                    return_solve_stats=True)
    cfg = GLConfig(**{"n_grid": 2, "batch_size": 2, "pde": pde, **kw})
    return GLDiscovery(cfg, _DS(), device="cpu", generator=torch.Generator().manual_seed(0))


def test_downsample_first_defaults_to_false_and_reaches_the_layer():
    assert GLConfig().downsample_first is False
    assert {f.name: f.default for f in dataclasses.fields(GLConfig)}["downsample_first"] is False
    mg = _model(solver_dim=(8, 12, 12)).layer.mg_solver
    assert mg.downsample_first is False and mg.dim_list == [(8, 12, 12), (8, 6, 6)]
    mg = _model(solver_dim=(12, 12, 12), downsample_first=True).layer.mg_solver
    assert mg.downsample_first is True and mg.dim_list == [(12, 12, 12), (6, 6, 6)]


@pytest.mark.parametrize("traced", [False, True])
def test_time_coarsened_trainer_takes_a_finite_step(traced):
    model = _model(solver_dim=(12, 12, 12), downsample_first=True)
    update = make_update(model.loss_fn, torch.optim.Adam(model.parameters(), lr=1e-5))
    rng = np.random.default_rng(0)
    u, v = (torch.tensor(0.3 * rng.standard_normal((2, 12, 12, 12))) for _ in range(2))
    before = [p.detach().clone() for p in model.parameters()]
    if traced:
        with profile(activities=[ProfilerActivity.CPU]):
            loss, aux = update(u, v)
    else:
        loss, aux = update(u, v)
    spans, _ = profiling.spans()
    counters = profiling.counters()
    assert torch.isfinite(loss) and torch.isfinite(aux["fwd_rel_rnorm"])
    assert all(torch.isfinite(p).all() for p in model.parameters())
    assert any(not torch.equal(a, p) for a, p in zip(before, model.parameters()))
    if not traced:
        assert spans == [] and counters == {}
        return
    attrs = {"level": 0, "route": "plain", "storage": "bf16_factored", "layout": "dense"}
    blocks = [s for s in spans if s.name == "vcycle.block_apply"]
    assert blocks and all(s.attrs == attrs for s in blocks)
    assert all(spans[s.parent].name in ("vcycle.smooth_pre", "vcycle.smooth_post")
               for s in blocks)
    launches = counters["block_apply.launches"]
    assert all(a == attrs for _, _, a in launches)
    assert len(launches) == len(blocks) + 21  # and the one hierarchy's lmax iteration


@pytest.mark.parametrize("nt,m", [(25, 7), (50, 7), (8, 7)])
def test_factor_is_stored_packed_where_k3_takes_a_cluster(nt, m):
    """`_block_inverse` in 'bf16_factored' storage gives W = L^-T as its
    upper triangle's rows (`pack_upper`) where K3 takes the cluster kernel
    (the long window's bw 175 and 350), with exactly the entries of the
    dense factor it gives at other widths (bw 56), which the plain K3 then
    applies alike."""
    from mech_nn_discovery_pde_torch.ops import fused_smoother as fs
    from mech_nn_discovery_pde_torch.solvers.multigrid import MultigridSolver

    bw = nt * m
    g = torch.Generator().manual_seed(bw)
    M = torch.randn((1, 2, bw, bw), generator=g)
    B = M @ M.transpose(-1, -2) / bw + torch.eye(bw)
    solver = type("S", (), {"_factored_binv": True})()
    w = MultigridSolver._block_inverse(solver, B, nt)
    L = torch.linalg.cholesky(B + 1e-6 * B.diagonal(dim1=-2, dim2=-1).amax(-1)[..., None, None]
                              * torch.eye(bw))
    dense = torch.linalg.solve_triangular(L, torch.eye(bw).expand_as(B), upper=False).mT.triu()
    packed = fs.factored_layout(nt, bw) == "packed"
    assert packed == (bw > 168)
    if packed:
        assert tuple(w.shape) == (1, 2, fs.packed_off(bw, bw))
        assert torch.equal(fs.unpack_upper(w), dense)
    else:
        assert torch.equal(w, dense)
    r = torch.randn((1, bw * 2), generator=g)
    assert torch.equal(fs.factored_block_apply_plain(w.to(torch.bfloat16), r, nt),
                       fs.factored_block_apply_plain(dense.to(torch.bfloat16), r, nt))
