"""PyTorch port vs the JAX package: FGMRES, the multigrid layer's forward
solve and IFT backward, the forward solve in the bf16 storage modes
(mg_precond_dtype), the Ginzburg-Landau discovery loss, and the GL data
pipeline; plus the port's own preconditioner-quality guard and the factored
bf16 layer against the port's f32 layer.

Inputs come from numpy with a fixed seed and go through both packages; the
port runs on the CPU (plain kernel versions).  Tolerances: FGMRES solutions
1e-8 with equal iteration counts; layer u0 and the gradients of sum(u0^2)
1e-4 with equal iteration counts; bf16-mode forward solves with equal
iteration counts and the JAX package's quality pins; GL loss 1e-5 and its
parameter gradients 1e-4; data arrays exact.

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


LAYER_KW = dict(coord_dims=(6, 12, 12), order=2, n_ind_dim=1, n_iv=1,
                init_index_mi_list=GL_IVS, solver_dbl=True, n_grid=2, downsample_first=False)


@pytest.fixture(scope="module")
def jax_layers():
    """jax_layers(mode): the JAX layer of LAYER_KW at SOLVE_CFG and bs 2 in
    storage mode `mode`, one per mode for the module.  Their assembled-
    stencil ops (per level, the AtA field assembly and its apply) run through
    one shared jitted copy, and each solver's hierarchy build and FGMRES
    solve through jax.jit.  jit changes no value; JAX then traces each of
    these once per shape instead of at every call, and those traces are
    most of what this module's JAX references cost."""
    ops, layers = [], {}

    def get(mode):
        if mode not in layers:
            cfg = JaxConfig(return_solve_stats=True, mg_precond_dtype=mode, **SOLVE_CFG)
            lay = JaxLayer(bs=2, config=cfg, **LAYER_KW)
            mgs = lay.mg_solver
            if not ops:
                ops.extend((desc, jax.jit(build), jax.jit(apply_))
                           for desc, build, apply_ in mgs._nstencil)
            mgs._nstencil = list(ops)
            mgs.build_hierarchy = jax.jit(mgs.build_hierarchy)
            mgs.solve_normal = jax.jit(mgs.solve_normal, static_argnames="back")
            layers[mode] = lay
        return layers[mode]

    return get


def torch_layer_step(mode, coeffs, rhs, iv, steps):
    """The port's layer at SOLVE_CFG in storage mode `mode`: u0, the forward
    solve's stats and the gradients of sum(u0^2) w.r.t. coeffs, rhs, iv."""
    tl = TorchLayer(bs=coeffs.shape[0], device=CPU, **LAYER_KW,
                    config=TorchConfig(return_solve_stats=True, mg_precond_dtype=mode,
                                       **SOLVE_CFG))
    tc, tr, ti = (torch.tensor(a, requires_grad=True) for a in (coeffs, rhs, iv))
    u0, _, st = tl(tc, tr, ti, [torch.tensor(s) for s in steps])
    (u0**2).sum().backward()
    return u0.detach(), st, (tc.grad, tr.grad, ti.grad)


@pytest.fixture(scope="module")
def layer_inputs():
    """The (6, 12, 12) n_grid 2 layer case at bs 2."""
    bs = 2
    coeffs, rhs, steps, rng = _layer_case(bs, LAYER_KW["coord_dims"])
    n_init = TorchLayer(bs=bs, device=CPU, **LAYER_KW).system.n_init_rows
    iv = 0.1 * rng.standard_normal((bs, n_init))
    return coeffs, rhs, iv, steps


@pytest.fixture(scope="module")
def f32_step(layer_inputs):
    return torch_layer_step("f32", *layer_inputs)


@pytest.fixture(scope="module")
def factored_step(layer_inputs):
    return torch_layer_step("bf16_factored", *layer_inputs)


@pytest.fixture(scope="module")
def jax_layer_refs(layer_inputs, jax_layers):
    """The JAX layer on the layer case, in one jitted program: f32 u0 and
    the gradients of sum(u0^2) w.r.t. coeffs, rhs and iv with the FGMRES
    iterations; and in each bf16 storage mode the forward u0 and stats."""
    coeffs, rhs, iv, steps = layer_inputs
    jl = jax_layers("f32")
    fwd = {mode: jax_layers(mode) for mode in ("bf16_factored", "bf16")}
    jsteps = [jnp.asarray(s) for s in steps]

    def jloss(c, r, i):
        u0, _, st = jl(c, r, i, jsteps)
        return jnp.sum(u0**2), (u0, st["iters"])

    @jax.jit
    def refs(c, r, i):
        (_, (u0, iters)), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
            c, r, i)
        modes = {}
        for mode, lay in fwd.items():
            mu0, _, mst = lay(c, r, i, jsteps)
            modes[mode] = (mu0, mst)
        return (u0, iters, grads), modes

    out = refs(jnp.asarray(coeffs), jnp.asarray(rhs), jnp.asarray(iv))
    return jax.tree.map(np.asarray, out)


def test_multigrid_layer_matches_jax(f32_step, jax_layer_refs):
    """u0 and the IFT gradients of sum(u0^2) w.r.t. coefficients, rhs and
    boundary data equal the JAX layer's, with the same FGMRES iterations,
    on the (6, 12, 12) n_grid 2 case with residual reuse and the fused
    Krylov matvec (the options of the production configuration)."""
    u0, st, grads = f32_step
    (ju0, jits, jg), _ = jax_layer_refs
    assert st["iters"].tolist() == jits.tolist()
    assert rel(u0, ju0) <= 1e-4
    for name, t, j in zip(("coeffs", "rhs", "iv"), grads, jg):
        assert rel(t, j) <= 1e-4, name


def test_factored_layer_matches_f32_layer(f32_step, factored_step):
    """At the converged SOLVE_CFG budget the 'bf16_factored' layer (W = L^-T
    in bf16, kernel K3's path) gives the f32 layer's u0 and IFT gradients
    (1e-4): the factored storage keeps f32 preconditioner quality."""
    u0, _, grads = f32_step
    fu0, _, fgrads = factored_step
    assert rel(fu0, u0) <= 1e-4
    for name, t, j in zip(("coeffs", "rhs", "iv"), fgrads, grads):
        assert rel(t, j) <= 1e-4, name


@pytest.mark.parametrize("mode", ["bf16_factored", "bf16"])
def test_forward_solve_modes_match_jax(mode, layer_inputs, f32_step, factored_step,
                                       jax_layer_refs):
    """The layer's forward solve in each bf16 storage mode against the JAX
    layer's, on the layer case: the same FGMRES iterations, and rel_rnorm
    held to the JAX package's pin for the mode in both packages.
    'bf16_factored' gives JAX's u0 (1e-4) and stays within 2x the f32
    residual (tests/test_multigrid.py); its rel_rnorm (~3.5e-6) sits at the
    f32 preconditioner's rounding floor, where the JAX package's own value
    moves by ~7 % with XLA's thread count, so the two are not compared
    directly.  'bf16' is quality-fatal at GL scale (the JAX package's config
    records it; both packages end above rel_rnorm 1 here), so it is held to
    JAX's rel_rnorm alone (5e-2: the indefinite preconditioner makes the end
    residual sensitive to rounding order; measured 1.2e-3)."""
    ju0, jst = jax_layer_refs[1][mode]
    if mode == "bf16_factored":
        u0, st, _ = factored_step
    else:
        coeffs, rhs, iv, steps = layer_inputs
        tl = TorchLayer(bs=coeffs.shape[0], device=CPU, **LAYER_KW,
                        config=TorchConfig(return_solve_stats=True, mg_precond_dtype=mode,
                                           **SOLVE_CFG))
        with torch.no_grad():
            u0, _, st = tl(*(torch.tensor(a) for a in (coeffs, rhs, iv)),
                           [torch.tensor(s) for s in steps])
    assert st["iters"].tolist() == jst["iters"].tolist()
    assert bool(torch.isfinite(u0).all())
    if mode == "bf16_factored":
        assert rel(u0, ju0) <= 1e-4
        f32 = float(f32_step[1]["rel_rnorm"].max())
        for got in (float(st["rel_rnorm"].max()), float(jst["rel_rnorm"].max())):
            assert got < 2 * f32 + 1e-6, (got, f32)
    else:
        assert rel(st["rel_rnorm"], jst["rel_rnorm"]) <= 5e-2


def test_unknown_precond_dtype_raises():
    """Any mg_precond_dtype other than 'f32', 'bf16' and 'bf16_factored' is a
    ValueError, as in the JAX package."""
    with pytest.raises(ValueError, match="mg_precond_dtype"):
        TorchLayer(bs=1, device=CPU, config=TorchConfig(mg_precond_dtype="f16"), **LAYER_KW)


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


def test_gl_loss_matches_jax(jax_layers):
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
    jmodel.layer = jax_layers("f32")  # the same layer configuration, traced once
    # jitted: the same parameters as the eager init, from one compiled program
    params = jax.tree.map(np.array, jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
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
