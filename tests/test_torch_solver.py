"""PyTorch port vs the JAX package: FGMRES, the multigrid layer's forward
solve and IFT backward, the Ginzburg-Landau discovery loss, and the GL data
pipeline; plus the port's own preconditioner-quality guard.

Inputs come from numpy with a fixed seed and go through both packages; the
port runs on the CPU (plain kernel versions).  Tolerances: FGMRES solutions
1e-8 with equal iteration counts; layer u0 and the gradients of sum(u0^2)
1e-4 with equal iteration counts; GL loss 1e-5 and its parameter gradients
1e-4; data arrays exact.

The layer cases are chosen so that both solves get far enough (60 FGMRES
iterations, forward rel_rnorm ~4e-6) that the float32 preconditioner's
rounding cannot steer the two Krylov runs apart: on the stiffer transport
cases of tests/test_multigrid.py a 1e-12 relative input perturbation alone
moves the port's own gradients by ~1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mech_nn_discovery_pde_torch.config import PDEConfig as TorchConfig
from mech_nn_discovery_pde_torch.data import datasets as tdata
from mech_nn_discovery_pde_torch.data import generate as tgen
from mech_nn_discovery_pde_torch.discovery import ginzburg_landau as tgl
from mech_nn_discovery_pde_torch.layers.multigrid import MultigridLayer as TorchLayer
from mech_nn_discovery_pde_torch.solvers import krylov as tkrylov
from mech_nn_discovery_pde_tpu.config import PDEConfig as JaxConfig
from mech_nn_discovery_pde_tpu.data import datasets as jdata
from mech_nn_discovery_pde_tpu.data import generate as jgen
from mech_nn_discovery_pde_tpu.discovery import ginzburg_landau as jgl
from mech_nn_discovery_pde_tpu.layers.multigrid import MultigridLayer as JaxLayer
from mech_nn_discovery_pde_tpu.solvers import krylov as jkrylov

torch.set_num_threads(1)

CPU = torch.device("cpu")
GL_IVS = tgl.GLDiscovery.IV_LIST


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("fused", [False, True])
def test_fgmres_matches_jax(fused):
    """Batched FGMRES equals the JAX package's vmapped FGMRES on a shared
    operator: the samples converge in different restart windows, so the
    per-sample masks must reproduce the batched while_loop's freeze."""
    rng = np.random.default_rng(5)
    bs, n = 3, 48
    scales = (0.2, 0.6, 0.9)  # off-diagonal strength: 1, 2 and 3+ windows
    A = np.stack([np.diag(1.0 + rng.random(n)) + s * rng.standard_normal((n, n)) / np.sqrt(n)
                  for s in scales])
    b = rng.standard_normal((bs, n))
    kw = dict(restart=5, maxiter=40, atol=1e-10, tol=1e-10)

    def jax_one(A, b):
        dinv = 1.0 / jnp.diag(A)
        pm = (lambda v: (dinv * v, A @ (dinv * v))) if fused else None
        return jkrylov.fgmres(lambda v: A @ v, b, precond=lambda v: dinv * v,
                              precond_matvec=pm, **kw)

    jr = jax.jit(jax.vmap(jax_one))(jnp.asarray(A), jnp.asarray(b))
    tA, tb = torch.tensor(A), torch.tensor(b)
    dinv = 1.0 / torch.diagonal(tA, dim1=1, dim2=2)
    mv = lambda v: torch.bmm(tA, v[:, :, None])[..., 0]
    pm = (lambda v: (dinv * v, mv(dinv * v))) if fused else None
    tr = tkrylov.fgmres(mv, tb, precond=lambda v: dinv * v, precond_matvec=pm, **kw)
    assert tr.iters.tolist() == np.asarray(jr.iters).tolist()
    assert len(set(tr.iters.tolist())) > 1  # the masks were exercised
    assert rel(tr.x, jr.x) <= 1e-8
    assert rel(tr.rnorm, jr.rnorm) <= 1e-6


def _layer_case(bs=2, dims=(6, 12, 12)):
    """GL-shaped system at the GL trainer's step sizes (t 0.2, x/y 0.3906):
    u_t + p0 u - 0.5 (u_xx + u_yy) = rhs with five Dirichlet faces."""
    rng = np.random.default_rng(0)
    gs = int(np.prod(dims))
    coeffs = np.zeros((bs, gs, 7))
    coeffs[..., 0] = 1.0 + 0.2 * rng.standard_normal((bs, gs))
    coeffs[..., 1] = 1.0
    coeffs[..., 5] = -0.5
    coeffs[..., 6] = -0.5
    rhs = 0.1 * rng.standard_normal((bs, gs))
    steps = [np.full((bs, d - 1), h) for d, h in zip(dims, (0.2, 0.3906, 0.3906))]
    return coeffs, rhs, steps, rng


SOLVE_CFG = dict(
    precision="f64", mg_solve_dtype="solver",
    mg_smoother_steps_pre=4, mg_smoother_steps_post=4,
    mg_fgmres_max_iter_forward=60, mg_fgmres_restarts_forward=20,
    mg_fgmres_max_iter_backward=60, mg_fgmres_restarts_backward=20,
    mg_fgmres_tol=1e-12, mg_smoother_residual=True, mg_fused_matvec=True,
)


def test_multigrid_layer_matches_jax():
    """u0 and the IFT gradients of sum(u0^2) w.r.t. coefficients, rhs and
    boundary data equal the JAX layer's, with the same FGMRES iterations,
    on the (6, 12, 12) n_grid 2 case with residual reuse and the fused
    Krylov matvec (the options of the production configuration)."""
    bs, dims = 2, (6, 12, 12)
    lk = dict(bs=bs, coord_dims=dims, order=2, n_ind_dim=1, n_iv=1,
              init_index_mi_list=GL_IVS, solver_dbl=True, n_grid=2, downsample_first=False)
    jl = JaxLayer(config=JaxConfig(return_solve_stats=True, **SOLVE_CFG), **lk)
    tl = TorchLayer(config=TorchConfig(return_solve_stats=True, **SOLVE_CFG), device=CPU, **lk)
    coeffs, rhs, steps, rng = _layer_case(bs, dims)
    iv = 0.1 * rng.standard_normal((bs, jl.system.n_init_rows))

    def jloss(c, r, i):
        u0, _, st = jl(c, r, i, [jnp.asarray(s) for s in steps])
        return jnp.sum(u0**2), (u0, st["iters"])

    (_, (ju0, jits)), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(coeffs), jnp.asarray(rhs), jnp.asarray(iv))

    tc, tr, ti = (torch.tensor(a, requires_grad=True) for a in (coeffs, rhs, iv))
    u0, _, st = tl(tc, tr, ti, [torch.tensor(s) for s in steps])
    (u0**2).sum().backward()
    assert st["iters"].tolist() == np.asarray(jits).tolist()
    assert rel(u0.detach(), ju0) <= 1e-4
    for name, t, j in zip(("coeffs", "rhs", "iv"), (tc.grad, tr.grad, ti.grad), jg):
        assert rel(t, j) <= 1e-4, name


def test_preconditioner_quality_guard():
    """The port's copy of tests/test_multigrid.py's canary for a silently
    collapsed preconditioner: at a reduced FGMRES budget the healthy
    configuration beats a pinned residual, and a deliberately broken lmax
    margin (Chebyshev interval below the top of the spectrum) fails it."""
    bs, dims = 1, (6, 12, 12)
    rng = np.random.default_rng(0)
    gs = int(np.prod(dims))
    coeffs = np.zeros((bs, gs, 7))
    coeffs[..., 0] = 0.4 + 0.2 * rng.standard_normal((bs, gs))
    coeffs[..., 1] = 1.0
    coeffs[..., 5] = -0.1
    coeffs[..., 6] = -0.1
    budget = dict(precision="f64", mg_fgmres_max_iter_forward=20, mg_fgmres_restarts_forward=2)

    def rel_rnorm(**extra):
        layer = TorchLayer(bs=bs, coord_dims=dims, order=2, n_ind_dim=1, n_iv=1,
                           init_index_mi_list=GL_IVS, solver_dbl=True, n_grid=2,
                           downsample_first=False, config=TorchConfig(**budget, **extra),
                           device=CPU)
        rhs = 0.1 * rng.standard_normal((bs, gs))
        iv = 0.1 * rng.standard_normal((bs, layer.system.n_init_rows))
        steps = [torch.full((bs, d - 1), 0.05, dtype=torch.float64) for d in dims]
        st = layer.solve_stats(torch.tensor(coeffs), torch.tensor(rhs), torch.tensor(iv), steps)
        return float(st["rel_rnorm"].max())

    good = rel_rnorm()
    assert good < 3e-2, f"preconditioner quality regressed: {good}"
    broken = rel_rnorm(mg_lmax_margin=0.8)
    assert broken > 10 * good, (broken, good)


def _gl_fields(bs, dims):
    """(u, v) patches of a small complex Ginzburg-Landau run."""
    A = tgen.ginzburg_landau(nt=dims[0], nx=2 * dims[1], ny=2 * dims[2], domain=25.0,
                             t_step=0.2, skip=2.0, substeps=4)
    tiles = [A[:, :dims[1], :dims[2]], A[:, dims[1]:, dims[2]:]][:bs]
    return np.stack([t.real for t in tiles]), np.stack([t.imag for t in tiles])


def test_gl_loss_matches_jax():
    """One GLDiscovery.loss_fn value (1e-5) and its gradients w.r.t. every
    ParamNet parameter (1e-4), with the JAX package's initial parameters
    carried into the port by `state_dict_from_flax`."""
    bs, dims = 2, (6, 12, 12)

    class TinyDS:
        t_step_size = 0.2
        x_step_size = y_step_size = 0.3906

    jcfg = jgl.GLConfig(solver_dim=dims, n_grid=2, batch_size=bs,
                        pde=JaxConfig(return_solve_stats=True, **SOLVE_CFG))
    tcfg = tgl.GLConfig(solver_dim=dims, n_grid=2, batch_size=bs,
                        pde=TorchConfig(return_solve_stats=True, **SOLVE_CFG))
    jmodel = jgl.GLDiscovery(jcfg, TinyDS())
    params = jax.tree.map(np.array, jmodel.init(jax.random.PRNGKey(0)))
    # Shrink each ParamNet's output head around a well-posed equation
    # (u_t + u - 0.5 lap u = 0.5 v): the raw init's O(1) coefficients include
    # anti-diffusion, where a 1e-12 input perturbation moves the port's own
    # parameter gradients by 1.5e-2.
    for p, head in zip(params["pnets"], ([1.0], [-0.5], [-0.5], [0.5])):
        dense = p["params"]["Dense_2"]
        dense["kernel"] *= 0.2
        dense["bias"][:] = 0.0
        dense["bias"][: len(head)] = head
    u, v = _gl_fields(bs, dims)

    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))(
        params, jnp.asarray(u), jnp.asarray(v))

    tmodel = tgl.GLDiscovery(tcfg, TinyDS(), device=CPU)
    tmodel.load_state_dict(tgl.state_dict_from_flax(params))
    loss, aux = tmodel.loss_fn(torch.tensor(u), torch.tensor(v))
    loss.backward()
    assert float(aux["fwd_iters"]) == float(jaux["fwd_iters"])
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = tgl.state_dict_from_flax(jax.tree.map(np.asarray, jgrads))
    got = dict(tmodel.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        assert rel(got[name].grad, g) <= 1e-4, name


def test_gl_data_matches_jax(tmp_path):
    """The port's copy of the GL generator, dataset and loader produce the
    JAX package's arrays and batches."""
    kw = dict(nt=8, nx=16, ny=16, t_step=0.1, skip=0.5, substeps=4)
    A = tgen.ginzburg_landau(**kw)
    assert np.array_equal(A, jgen.ginzburg_landau(**kw))
    tgen.ensure_dataset("ginzburg", str(tmp_path), **kw)
    dims = (2, 8, 8)
    tds = tdata.ReactDiffDataset(solver_dim=dims, data_root=str(tmp_path), noise_percent=1.0)
    jds = jdata.ReactDiffDataset(solver_dim=dims, data_root=str(tmp_path), noise_percent=1.0)
    assert len(tds) == len(jds) == 8
    assert (tds.t_step_size, tds.x_step_size) == (jds.t_step_size, jds.x_step_size)
    tl = list(tdata.PatchLoader(tds, 3, seed=4))
    jl = list(jdata.PatchLoader(jds, 3, seed=4))
    assert len(tl) == len(jl) == 2
    for tb, jb in zip(tl, jl):
        for ta, ja in zip(tb, jb):
            assert np.array_equal(ta, ja)
