"""PyTorch port vs the JAX package: the modules that hold the CUDA kernels,
run here on their plain versions (CPU tensors).

- ops/normal_stencil.py: `build_normal_coef` and K1's plain apply against
  the JAX `normal_stencil_matvec` and the COO AtA (f64, 1e-12), and K1's
  epilogue semantics;
- ops/fused_smoother.py: K2's plain block apply and the Chebyshev smoothing
  pass (both starts, emitted residual) against `MultigridSolver._block_apply`
  and `_smooth` (f32, 1e-4, as tests/test_multigrid.py holds the Pallas
  smoother), on the JAX package's own level-0 smoother data.

The kernels themselves run only on the card; chip_smoke.py holds them
against these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mech_nn_discovery_pde_torch.ops import fused_smoother as tfs
from mech_nn_discovery_pde_torch.ops import normal_stencil as tns
from mech_nn_discovery_pde_torch.ops.system import PDESystem as TorchSystem
from mech_nn_discovery_pde_tpu.config import PDEConfig as JaxConfig
from mech_nn_discovery_pde_tpu.layers.multigrid import MultigridLayer as JaxLayer
from mech_nn_discovery_pde_tpu.ops import normal_stencil as jns
from mech_nn_discovery_pde_tpu.ops.structured import split_values as jsplit
from mech_nn_discovery_pde_tpu.ops.system import PDESystem as JaxSystem

torch.set_num_threads(1)

IVS = {
    1: [lambda nt: (0, 0, [0], [0])],
    2: [
        lambda nt, nx: (0, 0, [0, 0], [0, nx - 1]),
        lambda nt, nx: (1, 1, [1, 0], [nt - 1, 0]),
    ],
    3: [
        lambda nt, nx, ny: (0, 0, [0, 0, 0], [0, nx - 1, ny - 1]),
        lambda nt, nx, ny: (1, 0, [1, 0, 0], [nt - 1, 0, ny - 1]),
    ],
}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("dims,order,n_iv", [
    ((9,), 2, 1), ((12,), 2, 3), ((7, 9), 2, 1), ((6, 8), 1, 1), ((8, 6), 2, 2),
    ((6, 7, 8), 2, 1),
])
def test_normal_coef_and_k1_plain_match_jax(dims, order, n_iv):
    """Assembled stencil fields equal the JAX package's; K1's plain apply
    equals the JAX stencil apply and the COO product A^T (A x)."""
    kw = dict(order=order, init_index_mi_list=IVS[len(dims)], n_iv=n_iv, step_size=0.2)
    jsys, tsys = JaxSystem.build(dims, **kw), TorchSystem.build(dims, **kw)
    rng = np.random.default_rng(sum(dims) + order + n_iv)
    bs = 2
    values = rng.standard_normal((bs, tsys.n_entries))
    x = rng.standard_normal((bs, tsys.num_vars))

    jdesc = jns.make_desc(jsys.spec)

    @jax.jit
    def jax_ref(v, x):
        def one(v, x):
            coef = jns.build_normal_coef(jsys.spec, jdesc, jsplit(jsys.spec, v))
            return (coef, jns.normal_stencil_matvec(jdesc, coef, x),
                    jsys.rmatvec_coo(v, jsys.matvec_coo(v, x)))
        return jax.vmap(one)(v, x)

    jcoef, jy, jcoo = jax_ref(jnp.asarray(values), jnp.asarray(x))
    tdesc = tns.make_desc(tsys.spec)
    assert tdesc.n_channels == jdesc.n_channels
    assert [tuple(b) for b in tdesc.bands] == [tuple(b) for b in jdesc.bands]
    tv, tx = torch.tensor(values), torch.tensor(x)
    coef = tns.build_normal_coef(tsys.spec, tdesc, tsys.split_values(tv))
    assert rel(coef, jcoef) <= 1e-12
    y = tns.stencil_apply(tdesc, coef, tx)
    assert rel(y, jy) <= 1e-12
    assert rel(y, jcoo) <= 1e-12
    assert rel(tns.stencil_apply_plain(tdesc, coef, tx), jcoo) <= 1e-12


def test_k1_epilogue_semantics():
    """out = rin - A x and xout = xin + x, in place or not; xin None reads
    as zero."""
    dims = (7, 9)
    tsys = TorchSystem.build(dims, order=2, init_index_mi_list=IVS[2])
    rng = np.random.default_rng(3)
    bs = 2
    tv = torch.tensor(rng.standard_normal((bs, tsys.n_entries)))
    x, b, x0 = (torch.tensor(rng.standard_normal((bs, tsys.num_vars))) for _ in range(3))
    desc = tns.make_desc(tsys.spec)
    coef = tns.build_normal_coef(tsys.spec, desc, tsys.split_values(tv))
    Ax = tns.stencil_apply(desc, coef, x)
    r = b.clone()
    xo = x0.clone()
    out = tns.stencil_apply(desc, coef, x, rin=r, out=r, xin=xo, xout=xo)
    assert out is r
    assert rel(r, b - Ax) <= 1e-12
    assert rel(xo, x0 + x) <= 1e-15
    xz = torch.empty_like(x)
    tns.stencil_apply(desc, coef, x, xout=xz)
    assert torch.equal(xz, x)


@pytest.fixture(scope="module")
def gl_level():
    """The JAX package's level-0 smoother data on the small GL-shaped case of
    tests/test_multigrid.py::test_fused_smoother_matches_xla_smoother, and
    reference smoothing passes on it."""
    bs, dims = 2, (6, 12, 12)
    ivs = [
        lambda nt, nx, ny: (0, 0, [0, 0, 0], [0, nx - 1, ny - 1]),
        lambda nt, nx, ny: (1, 0, [1, 0, 0], [nt - 1, 0, ny - 1]),
    ]
    lay = JaxLayer(bs=bs, coord_dims=dims, order=2, n_ind_dim=1, n_iv=1,
                   init_index_mi_list=ivs, solver_dbl=True, n_grid=2,
                   downsample_first=False, config=JaxConfig(precision="f64"))
    mgs = lay.mg_solver
    rng = np.random.default_rng(0)
    gs = lay.grid_size
    coeffs = np.zeros((bs, gs, lay.n_orders))
    coeffs[..., 0] = 0.4
    coeffs[..., 1] = 1.0
    coeffs[..., 5] = -0.1
    steps = [np.full((bs, d - 1), 0.05) for d in dims]
    rhs = 0.1 * rng.standard_normal((bs, gs))
    iv = 0.1 * rng.standard_normal((bs, lay.system.n_init_rows))
    n = mgs.systems[0].num_vars
    b = rng.standard_normal((bs, n)).astype(np.float32)
    x0 = rng.standard_normal((bs, n)).astype(np.float32)

    @jax.jit
    def reference(coeffs, rhs, iv, steps, b, x0):
        vals = mgs.systems[0].fill_values(coeffs, steps, dtype=jnp.float64)
        lvl = mgs.build_hierarchy(coeffs, rhs, iv, steps, vals)["levels"][0]
        sysk = mgs.systems[0]

        def one(lvl, b, x0):
            z = jnp.zeros_like(b)
            return {
                "block": mgs._block_apply(sysk, lvl["binv"], b),
                "zero4": mgs._smooth(0, lvl, b, z, 4, False, x0_zero=True,
                                     want_residual=True),
                "x3": mgs._smooth(0, lvl, b, x0, 3, False, want_residual=True),
            }
        return lvl, jax.vmap(one)(lvl, b, x0)

    lvl, ref = reference(*(jnp.asarray(a) for a in (coeffs, rhs, iv)),
                         [jnp.asarray(s) for s in steps], jnp.asarray(b), jnp.asarray(x0))
    t = lambda a: torch.tensor(np.asarray(a))
    return {
        "desc": tns.make_desc(TorchSystem.build(dims, order=2, init_index_mi_list=ivs).spec),
        "nt": dims[0], "coef": t(lvl["coef"]), "binv": t(lvl["binv"]),
        "lmax": t(lvl["lmax"]), "b": t(b), "x0": t(x0),
        "ratio": mgs.config.mg_chebyshev_ratio,
        "ref": jax.tree.map(np.asarray, ref),
    }


def test_k2_plain_block_apply_matches_jax(gl_level):
    g = gl_level
    got = tfs.block_apply(g["binv"], g["b"], g["nt"])
    assert rel(got, g["ref"]["block"]) <= 1e-4
    assert rel(tfs.block_apply_plain(g["binv"], g["b"], g["nt"]), g["ref"]["block"]) <= 1e-4
    # Chebyshev epilogue: d <- c1 d + c2 B^-1 r
    c1, c2 = torch.tensor([0.5, -2.0]), torch.tensor([3.0, 0.25])
    d = g["x0"].clone()
    tfs.block_apply(g["binv"], g["b"], g["nt"], d=d, c1=c1, c2=c2)
    want = c1[:, None] * g["x0"] + c2[:, None] * got
    assert rel(d, want) <= 1e-6


@pytest.mark.parametrize("steps,x0_zero", [(4, True), (3, False)])
def test_smoothing_pass_matches_jax(gl_level, steps, x0_zero):
    """The kernel-driven pass (plain versions here) and the step-by-step
    plain pass reproduce MultigridSolver._smooth, emitted residual
    included."""
    g = gl_level
    want_x, want_r = g["ref"]["zero4" if x0_zero else "x3"]
    sched = tfs.chebyshev_schedule(g["lmax"], g["ratio"], steps)
    x, r = tfs.chebyshev_smooth(g["desc"], g["nt"], g["coef"], g["binv"], g["b"],
                                g["x0"], sched, steps, x0_zero)
    assert rel(x, want_x) <= 1e-4
    assert rel(r, want_r) <= 1e-4
    xp, rp = tfs.chebyshev_smooth_plain(g["desc"], g["nt"], g["coef"], g["binv"], g["b"],
                                        g["x0"], g["lmax"], g["ratio"], steps, x0_zero)
    assert rel(xp, want_x) <= 1e-4
    assert rel(rp, want_r) <= 1e-4
    # the emitted residual is b - A x
    r_true = tns.stencil_apply(g["desc"], g["coef"], x, rin=g["b"])
    assert rel(r, r_true) <= 1e-4
