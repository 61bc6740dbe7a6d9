"""PyTorch port vs the JAX package on the dense path: `DenseNormalSolver`
(through `PDEDenseLayer`) in each precision, forward and IFT gradients;
n_ind_dim > 1; `solve_stats` and `backward_stats`; a failed factorization
reported as non-finite; and the port's `entry()` against the JAX package's.

Inputs come from numpy with a fixed seed and go through both packages; the
port runs on the CPU.  Tolerances: f64 u0 and gradients 1e-9 (both factor
the same matrix in float64; the sums run in another order); f32_ir 1e-6
(each package's float32 factor rounds differently, and six PCG steps on the
float64 operator refine both to about 1e-8 here); f32 each package held to
its own distance from the float64 solution (the two form AtA differently,
the JAX package by a dense product and the port by the pair scatter, and the
float32 factor of this ill-conditioned AtA amplifies the rounding); entry()
in f32_ir within 1e-6 of the JAX package's float64 solve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from mech_nn_discovery_pde_torch.config import PDEConfig as TorchConfig
from mech_nn_discovery_pde_torch.entry import IV_LIST as ENTRY_IVS
from mech_nn_discovery_pde_torch.entry import entry as torch_entry
from mech_nn_discovery_pde_torch.layers.dense import PDEDenseLayer as TorchLayer
from mech_nn_discovery_pde_torch.solvers import cholesky as tchol
from mech_nn_discovery_pde_tpu.config import PDEConfig as JaxConfig
from mech_nn_discovery_pde_tpu.layers.dense import PDEDenseLayer as JaxLayer
from mech_nn_discovery_pde_tpu.solvers.cholesky import DenseNormalSolver as JaxSolver

torch.set_num_threads(1)

IVS = [lambda nt, nx: (0, 0, [0, 0], [0, nx - 1])]
BS, DIMS = 2, (6, 8)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def layers(precision, n_ind_dim=1, bs=BS, dims=DIMS, ivs=IVS):
    """The JAX and the port layer at one precision ('f32' as solver_dbl=False)."""
    kw = dict(bs=bs, coord_dims=dims, order=2, n_ind_dim=n_ind_dim, n_iv=1,
              init_index_mi_list=ivs, solver_dbl=precision != "f32")
    p = "f64" if precision == "f32" else precision
    return (JaxLayer(config=JaxConfig(precision=p), **kw),
            TorchLayer(config=TorchConfig(precision=p), device="cpu", **kw))


@pytest.fixture(scope="module")
def case():
    """Inputs of a well-posed (6, 8) transport-like system with random
    coefficients, and the weights of the scalar loss."""
    rng = np.random.default_rng(1)
    jl, _ = layers("f64")
    gs, no = jl.grid_size, jl.n_orders
    coeffs = 0.3 * rng.standard_normal((BS, gs, no))
    coeffs[..., 1] += 1.0
    rhs = 0.1 * rng.standard_normal((BS, gs))
    iv = rng.standard_normal((BS, DIMS[1]))
    steps = [0.05 + 0.02 * rng.random((BS, d - 1)) for d in DIMS]
    w = rng.standard_normal((BS, 1, gs))
    return dict(args=(coeffs, rhs, iv, *steps), w=w, jax={})


def jax_value_and_grads(layer, case):
    w = case["w"]

    def loss(c, r, i, s0, s1):
        u0, u, _ = layer(c, r, i, [s0, s1])
        return jnp.sum(w * u0) + 0.1 * jnp.sum(u[..., 2] ** 2), u0

    (v, u0), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
        *case["args"])
    return float(v), np.asarray(u0), [np.asarray(a) for a in g]


def torch_value_and_grads(layer, case):
    ts = [torch.tensor(a, requires_grad=True) for a in case["args"]]
    u0, u, _ = layer(ts[0], ts[1], ts[2], ts[3:])
    v = (torch.tensor(case["w"]) * u0).sum() + 0.1 * (u[..., 2] ** 2).sum()
    v.backward()
    return float(v.detach()), u0.detach().numpy(), [t.grad.numpy() for t in ts]


def jax_result(case, precision):
    if precision not in case["jax"]:
        case["jax"][precision] = jax_value_and_grads(layers(precision)[0], case)
    return case["jax"][precision]


@pytest.mark.parametrize("precision", ["f64", "f32_ir", "f32"])
def test_dense_layer_matches_jax(case, precision):
    """u0, the loss and its IFT gradients w.r.t. coeffs, rhs, iv_rhs and both
    step vectors agree with the JAX package's."""
    _, tl = layers(precision)
    assert tl.inner.precision == precision
    jv, ju0, jg = jax_result(case, precision)
    tv, tu0, tg = torch_value_and_grads(tl, case)
    if precision != "f32":
        tol = {"f64": 1e-9, "f32_ir": 1e-6}[precision]
        assert rel(tu0, ju0) <= tol
        assert abs(tv - jv) <= tol * abs(jv)
        for name, a, b in zip(("coeffs", "rhs", "iv", "steps0", "steps1"), tg, jg):
            assert rel(a, b) <= tol, name
        return
    # f32: each package within 3x the other's distance from the f64 solution
    _, ru0, rg = jax_result(case, "f64")
    for name, a, b, ref in zip(("u0", "coeffs", "rhs", "iv", "steps0", "steps1"),
                               [tu0, *tg], [ju0, *jg], [ru0, *rg]):
        ej, et = rel(b, ref), rel(a, ref)
        assert ej <= 0.2 and et <= 3 * ej + 1e-6, (name, et, ej)


def test_dense_layer_n_ind_dim_matches_jax():
    """n_ind_dim = 2 solves bs * 2 independent systems side by side."""
    nd = 2
    jl, tl = layers("f64", n_ind_dim=nd)
    rng = np.random.default_rng(2)
    gs = jl.grid_size
    coeffs = np.zeros((BS, nd, gs, jl.n_orders))
    coeffs[..., 1] = 1.0
    coeffs[..., 2] = 0.3 + 0.1 * rng.random((BS, nd, 1))
    rhs = 0.1 * rng.standard_normal((BS, nd, gs))
    iv = rng.standard_normal((BS, nd, DIMS[1]))
    steps = [np.full((BS * nd, d - 1), 0.05) for d in DIMS]
    ju0 = np.asarray(jax.jit(lambda c, r, i, s0, s1: jl(c, r, i, [s0, s1])[0])(
        coeffs, rhs, iv, *steps))
    tu0 = tl(*(torch.tensor(a) for a in (coeffs, rhs, iv)), [torch.tensor(s) for s in steps])[0]
    assert tuple(tu0.shape) == (BS, nd, gs) == ju0.shape
    assert rel(tu0.numpy(), ju0) <= 1e-10


def test_dense_solve_and_backward_stats(case):
    """solve_stats and backward_stats: finite solutions with relative normal
    residuals below 1e-8 in both packages, and the same norms of At b and of
    the cotangent."""
    jl, tl = layers("f64")
    args = case["args"]
    g = np.random.default_rng(3).standard_normal((BS, jl.system.num_vars))
    js, jb = jax.jit(lambda c, r, i, s0, s1, g: (
        jl.solve_stats(c, r, i, [s0, s1]), jl.backward_stats(c, r, i, [s0, s1], g)))(*args, g)
    targs = [torch.tensor(a) for a in args]
    ts = tl.solve_stats(*targs[:3], targs[3:])
    tb = tl.backward_stats(*targs[:3], targs[3:], torch.tensor(g))
    for jst, tst in ((js, ts), (jb, tb)):
        assert np.asarray(jst["finite"]).all() and bool(tst["finite"].all())
        assert float(np.max(jst["rel_rnorm"])) < 1e-8
        assert float(tst["rel_rnorm"].max()) < 1e-8
        # rnorm / rel_rnorm is the norm of At b (or of g): the same in both
        np.testing.assert_allclose(tst["rnorm"] / tst["rel_rnorm"],
                                   np.asarray(jst["rnorm"]) / np.asarray(jst["rel_rnorm"]),
                                   rtol=1e-12)


@pytest.mark.parametrize("precision", ["f64", "f32_ir"])
def test_dense_failed_factorization_is_not_finite(case, precision):
    """A factorization that fails (AtA shifted indefinite by a negative
    ridge) gives a non-finite solution, which solve_stats reports as the
    JAX package's does; the port marks only the failed samples."""
    jl, tl = layers(precision)
    ridge = -1e6
    jl.inner = JaxSolver(jl.system, precision=precision, ridge=ridge)
    tl.inner = tchol.DenseNormalSolver(tl.system, precision=precision, ridge=ridge)
    args = case["args"]
    js = jax.jit(lambda c, r, i, s0, s1: jl.solve_stats(c, r, i, [s0, s1]))(*args)
    targs = [torch.tensor(a) for a in args]
    ts = tl.solve_stats(*targs[:3], targs[3:])
    assert not np.asarray(js["finite"]).any()
    assert ts["finite"].tolist() == np.asarray(js["finite"]).tolist()
    spd = torch.eye(3, dtype=torch.float64)
    L = tchol.cholesky_nan(torch.stack([spd, -spd]))
    assert torch.equal(L[0], spd) and bool(torch.isnan(L[1]).all())


def test_entry_matches_jax():
    """The port's entry() makes the JAX package's entry() arrays, and its
    f32_ir forward (Burgers (32, 32), bs 10) agrees with the JAX package's
    float64 solve of the same inputs within 1e-6 (first two samples)."""
    jfn, jargs = jentry.entry()
    fn, args = torch_entry(device="cpu")
    assert len(args) == len(jargs)
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with torch.no_grad():
        u0 = fn(*args).numpy()
    assert u0.shape == (10, 1, 1024) and np.isfinite(u0).all()
    jl, _ = layers("f64", bs=2, dims=(32, 32), ivs=ENTRY_IVS)
    ref = jax.jit(lambda c, r, i, s0, s1: jl(c, r, i, [s0, s1])[0])(*[a[:2] for a in jargs])
    assert float(np.abs(u0[:2] - np.asarray(ref)).max()) <= 1e-6
