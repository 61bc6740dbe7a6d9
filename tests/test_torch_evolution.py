"""PyTorch port vs the JAX package: evolution systems through both layers,
and one forward + IFT backward of the multigrid layer under each new
solver option (factored operator, point blocks, Jacobi smoother).

Inputs come from numpy with a fixed seed and go through both packages; the
port runs on the CPU (plain kernel versions).  Tolerances:
- the dense evolution layer (the (6, 8) and (8, 10) cases of
  tests/test_misc.py, f64): u0 and the IFT gradients of a weighted sum of
  u0 w.r.t. coefficients, rhs and boundary data within 1e-8 relative (both
  factor the same AtA in float64; the sums run in another order), but the
  gradients of the (8, 10) transport case within 3e-8: its AtA has cond
  3.9e11, and the JAX package's own jitted and eager gradients differ by
  3e-9 there (measured port vs JAX: 1.3e-8);
- the multigrid evolution layer at the setup of
  tests/test_multigrid.py::test_mg_layer_matches_dense_evolution ((16, 16),
  bs 2, n_grid 2, FGMRES 80 in windows of 6, tol 1e-9): it falls back to
  the factored operator, takes the JAX layer's FGMRES iterations (84, the
  budget) and ends at its rel_rnorm within 5 % (rounding decides the last
  digits at this budget: reordering the port's own structured sums moved
  it by 1.5 %), and is within the JAX
  test's 5e-2 of the port's dense solve.  Its u0 is held to the JAX
  layer's within 1e-3: the solve stops at rel_rnorm 8e-6 to 2.5e-5, 8.6e-3
  away from its own 300-iteration solution, where a 1e-7 relative change
  of the coefficients (float32 rounding, the size by which the two
  packages' preconditioners differ) moves the port's u0 by 1.5e-4 and a
  1e-12 change by 1.3e-6 (measured port vs JAX: 1.4e-4; ROADMAP fault 4);
- factored, point and Jacobi layers on the (6, 12, 12) case of
  tests/test_torch_solver.py at its converged budget (60 FGMRES iterations,
  forward rel_rnorm 4e-6 to 1.3e-4; there the float32 preconditioner's
  rounding cannot steer the two Krylov runs apart, ROADMAP fault 2): u0
  and the gradients of sum(u0^2) within 1e-4, with equal iteration counts
  and the forward rel_rnorm within 1 %;
- the evolution system of that (6, 12, 12) case through the multigrid
  layer at the same converged budget: u0 within 1e-6 (measured port vs
  JAX: 4.8e-8), the gradients within 1e-4 (measured: 4.0e-6), equal
  iteration counts and the forward rel_rnorm within 1 %.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mech_nn_discovery_pde_torch.config import PDEConfig as TorchConfig
from mech_nn_discovery_pde_torch.layers.dense import PDEDenseLayer as TorchDense
from mech_nn_discovery_pde_torch.layers.multigrid import MultigridLayer as TorchLayer
from mech_nn_discovery_pde_tpu.config import PDEConfig as JaxConfig
from mech_nn_discovery_pde_tpu.layers.dense import PDEDenseLayer as JaxDense
from mech_nn_discovery_pde_tpu.layers.multigrid import MultigridLayer as JaxLayer
from tests.test_torch_solver import LAYER_KW, SOLVE_CFG, _layer_case

torch.set_num_threads(1)

IVS_2D = [lambda nt, nx: (0, 0, [0, 0], [0, nx - 1])]


def jit_structured_ops(layer):
    """The JAX layer's structured-operator closures, each through one
    jax.jit: no value changes, and the factored operator's A^T (a
    linear_transpose of A, traced anew at every call otherwise) is traced
    once per shape instead of at every apply, which is most of what the
    factored references cost."""
    mg = layer.mg_solver
    for name in ("_sops", "_sops32"):
        setattr(mg, name, [tuple(jax.jit(f) for f in ops) for ops in getattr(mg, name)])
    return layer


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def dense_case(dims):
    """test_misc.py's evolution cases at bs 2: (6, 8) with random
    coefficients (test_evolution_2d_gradients_match_fd), (8, 10) transport
    (test_evolution_layer_solves)."""
    bs = 2
    rng = np.random.default_rng(0)
    gs = int(np.prod(dims))
    if dims == (6, 8):
        coeffs = rng.standard_normal((bs, gs, 5)) * 0.2
        coeffs[..., 1] += 1.0
        rhs = 0.1 * rng.standard_normal((bs, gs))
        iv = 0.3 * rng.standard_normal((bs, dims[1]))
        steps = [np.full((bs, d - 1), 0.1) for d in dims]
    else:
        coeffs = np.zeros((bs, gs, 5))
        coeffs[..., 1] = 1.0
        coeffs[..., 2] = 1.0
        rhs = np.zeros((bs, gs))
        iv = 0.3 * np.stack([np.sin(np.linspace(0, 2 * np.pi, dims[1]) + k) for k in range(bs)])
        steps = [np.full((bs, d - 1), 0.05) for d in dims]
    w = rng.standard_normal((bs, 1, gs))
    return (coeffs, rhs, iv), steps, w


@pytest.mark.parametrize("dims", [(6, 8), (8, 10)])
def test_dense_evolution_layer_matches_jax(dims):
    args, steps, w = dense_case(dims)
    kw = dict(bs=2, coord_dims=dims, order=2, n_ind_dim=1, n_iv=1, init_index_mi_list=IVS_2D,
              solver_dbl=True, evolution=True)
    jl = JaxDense(config=JaxConfig(precision="f64"), **kw)
    tl = TorchDense(config=TorchConfig(precision="f64"), device="cpu", **kw)
    jsteps = [jnp.asarray(s) for s in steps]

    def jloss(c, r, i):
        u0, _, _ = jl(c, r, i, jsteps)
        return jnp.sum(w * u0), u0

    (_, ju0), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(*args)
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    u0, _, _ = tl(*ts, [torch.tensor(s) for s in steps])
    (torch.tensor(w) * u0).sum().backward()
    assert bool(torch.isfinite(u0).all())
    assert rel(u0.detach(), ju0) <= 1e-8
    gtol = 1e-8 if dims == (6, 8) else 3e-8
    for name, t, j in zip(("coeffs", "rhs", "iv"), ts, jg):
        assert rel(t.grad, j) <= gtol, name


def transport_case(bs=2, dims=(16, 16)):
    coeffs = np.zeros((bs, 256, 5))
    coeffs[..., 1] = 1.0
    coeffs[..., 2] = 1.0
    x = np.linspace(0, 2 * np.pi, dims[1], endpoint=False)
    iv = np.stack([np.sin((k + 1) * x) for k in range(bs)])
    steps = [np.full((bs, dims[0] - 1), 0.01), np.full((bs, dims[1] - 1), 2 * np.pi / dims[1])]
    return coeffs, np.zeros((bs, 256)), iv, steps


def test_multigrid_evolution_layer_matches_jax():
    coeffs, rhs, iv, steps = transport_case()
    kw = dict(bs=2, coord_dims=(16, 16), order=2, n_ind_dim=1, n_iv=1,
              init_index_mi_list=IVS_2D, solver_dbl=True, evolution=True)
    big = dict(precision="f64", mg_fgmres_max_iter_forward=80, mg_fgmres_restarts_forward=6,
               mg_fgmres_tol=1e-9, return_solve_stats=True)
    jl = jit_structured_ops(JaxLayer(n_grid=2, config=JaxConfig(**big), **kw))
    tl = TorchLayer(n_grid=2, config=TorchConfig(**big), device="cpu", **kw)
    assert tl.mg_solver.config.mg_normal_op == "factored"
    jsteps = [jnp.asarray(s) for s in steps]
    ju0, _, jst = jax.jit(lambda c, r, i: jl(c, r, i, jsteps))(coeffs, rhs, iv)
    targs = [torch.tensor(a) for a in (coeffs, rhs, iv)], [torch.tensor(s) for s in steps]
    with torch.no_grad():
        u0, _, st = tl(*targs[0], targs[1])
        dense = TorchDense(config=TorchConfig(precision="f64"), device="cpu", **kw)
        ud, _, _ = dense(*targs[0], targs[1])
    assert st["iters"].tolist() == np.asarray(jst["iters"]).tolist()
    assert rel(st["rel_rnorm"], jst["rel_rnorm"]) <= 5e-2
    assert rel(u0, ju0) <= 1e-3
    assert rel(u0, ud) < 5e-2


OPTIONS = {
    "factored": dict(mg_normal_op="factored"),
    "point": dict(mg_block_smoother="point"),
    "jacobi": dict(mg_smoother="jacobi"),
}


@pytest.fixture(scope="module")
def gl_inputs():
    bs = 2
    coeffs, rhs, steps, rng = _layer_case(bs, LAYER_KW["coord_dims"])
    n_init = TorchLayer(bs=bs, device="cpu", **LAYER_KW).system.n_init_rows
    iv = 0.1 * rng.standard_normal((bs, n_init))
    return coeffs, rhs, iv, steps


def _layer_step(gl_inputs, cfg_extra, **layer_extra):
    """Forward + IFT backward of sum(u0^2) through the JAX layer and the
    port's at SOLVE_CFG with cfg_extra and LAYER_KW with layer_extra:
    (port layer, stats, u0, grads) and the JAX layer's (iters, rel_rnorm,
    u0, grads)."""
    coeffs, rhs, iv, steps = gl_inputs
    kw = dict(LAYER_KW, **layer_extra)
    cfg = dict(SOLVE_CFG, return_solve_stats=True, **cfg_extra)
    jl = jit_structured_ops(JaxLayer(bs=2, config=JaxConfig(**cfg), **kw))
    jsteps = [jnp.asarray(s) for s in steps]

    def jloss(c, r, i):
        u0, _, st = jl(c, r, i, jsteps)
        return jnp.sum(u0**2), (u0, st["iters"], st["rel_rnorm"])

    (_, (ju0, jits, jrel)), jg = jax.jit(
        jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(coeffs, rhs, iv)
    tl = TorchLayer(bs=2, device="cpu", config=TorchConfig(**cfg), **kw)
    ts = [torch.tensor(a, requires_grad=True) for a in (coeffs, rhs, iv)]
    u0, _, st = tl(*ts, [torch.tensor(s) for s in steps])
    (u0**2).sum().backward()
    return (tl, st, u0.detach(), [t.grad for t in ts]), (np.asarray(jits), jrel, ju0, jg)


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_layer_option_matches_jax(name, gl_inputs):
    """Forward + IFT backward of sum(u0^2) under one option."""
    (_, st, u0, grads), (jits, jrel, ju0, jg) = _layer_step(gl_inputs, OPTIONS[name])
    assert st["iters"].tolist() == jits.tolist()
    assert rel(st["rel_rnorm"], jrel) <= 1e-2
    assert rel(u0, ju0) <= 1e-4
    for gname, t, j in zip(("coeffs", "rhs", "iv"), grads, jg):
        assert rel(t, j) <= 1e-4, gname


def test_multigrid_evolution_converged_matches_jax(gl_inputs):
    """The evolution system of the (6, 12, 12) case through the multigrid
    layer (factored fallback) at the converged budget: the previous-time-
    step shift of the factored path held tightly, forward and backward."""
    (tl, st, u0, grads), (jits, jrel, ju0, jg) = _layer_step(gl_inputs, {}, evolution=True)
    assert tl.mg_solver.config.mg_normal_op == "factored"
    assert bool(torch.isfinite(u0).all())
    assert st["iters"].tolist() == jits.tolist()
    assert rel(st["rel_rnorm"], jrel) <= 1e-2
    assert rel(u0, ju0) <= 1e-6
    for gname, t, j in zip(("coeffs", "rhs", "iv"), grads, jg):
        assert rel(t, j) <= 1e-4, gname
