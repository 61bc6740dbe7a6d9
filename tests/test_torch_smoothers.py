"""PyTorch port vs the JAX package: the multigrid options beyond the
stencil + line-block Chebyshev path: the factored normal operator, the
point-block smoother, the Jacobi smoother, and the solver's option checks.

Two cases: the (16, 16) transport setup of tests/test_multigrid.py at bs 2,
n_grid 2, and the (6, 12, 12) case of `_gl_shaped_case` there at bs 2
(n_grid 2, time axis kept).  Each package builds its own hierarchy from
the same numpy inputs (values in float64, preconditioner in float32); the
port runs on the CPU (plain kernel versions).  Compared, in float32 within
1e-5 relative (max-abs over max-abs: the two assemble and factor the blocks
in another order):
- the point-block B^-1 and lmax of level 0 against the JAX package's
  `_level_precond_data`, and the point-block factor W = L^-T (computed as
  under mg_precond_dtype='bf16_factored', kept in float32 in both);
- one smoothing pass against the JAX package's `_smooth`, vmapped: the
  factored Chebyshev pass (factored + line), the point-block Chebyshev
  pass (stencil + point), a Jacobi pass with the forward and with the
  backward weight (stencil + line + Jacobi);
- one V-cycle per configuration against `v_cycle`.
The passes and V-cycles run the port on the JAX package's level data (block
inverses, stencil fields, lmax, coarse inverse; the level values are the
same), so that they compare the algorithms: the coarse inverse, an f32
Cholesky inverse of the ill-conditioned coarse AtA, differs between the
two packages' own hierarchies by more than the tolerance (2.2e-5 on a
V-cycle here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mech_nn_discovery_pde_torch.config import PDEConfig as TorchConfig
from mech_nn_discovery_pde_torch.layers.multigrid import MultigridLayer as TorchLayer
from mech_nn_discovery_pde_torch.ops.fused_smoother import chebyshev_schedule
from mech_nn_discovery_pde_torch.ops.normal_stencil import make_desc
from mech_nn_discovery_pde_tpu.config import PDEConfig as JaxConfig
from mech_nn_discovery_pde_tpu.layers.multigrid import MultigridLayer as JaxLayer

torch.set_num_threads(1)
TOL = 1e-5

IVS_2D = [lambda nt, nx: (0, 0, [0, 0], [0, nx - 1])]
IVS_GL = [
    lambda nt, nx, ny: (0, 0, [0, 0, 0], [0, nx - 1, ny - 1]),
    lambda nt, nx, ny: (1, 0, [1, 0, 0], [nt - 1, 0, ny - 1]),
    lambda nt, nx, ny: (2, 0, [1, 1, 0], [nt - 1, nx - 1, 0]),
    lambda nt, nx, ny: (1, 0, [1, nx - 1, 1], [nt - 1, nx - 1, ny - 1]),
    lambda nt, nx, ny: (2, 0, [1, 1, ny - 1], [nt - 1, nx - 2, ny - 1]),
]
CONFIGS = {
    "factored_line": dict(mg_normal_op="factored"),
    "stencil_point": dict(mg_block_smoother="point"),
    "stencil_jacobi": dict(mg_smoother="jacobi", mg_smoother_steps_pre=3,
                           mg_smoother_steps_post=3),
}


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def case_inputs(case):
    """(layer kwargs, numpy inputs) of a case, bs 2."""
    bs = 2
    if case == "transport":
        dims = (16, 16)
        kw = dict(coord_dims=dims, init_index_mi_list=IVS_2D)
        gs, m = 256, 5
        coeffs = np.zeros((bs, gs, m))
        coeffs[..., 1] = 1.0
        coeffs[..., 2] = 1.0
        x = np.linspace(0, 2 * np.pi, dims[1], endpoint=False)
        iv = np.stack([np.sin((k + 1) * x) for k in range(bs)])
        steps = [np.full((bs, dims[0] - 1), 0.01), np.full((bs, dims[1] - 1), 2 * np.pi / 16)]
        rhs = np.zeros((bs, gs))
    else:
        dims = (6, 12, 12)
        kw = dict(coord_dims=dims, init_index_mi_list=IVS_GL, downsample_first=False)
        rng = np.random.default_rng(0)
        gs, m = 864, 7
        coeffs = np.zeros((bs, gs, m))
        coeffs[..., 0] = 0.4 + 0.2 * rng.standard_normal((bs, gs))
        coeffs[..., 1] = 1.0
        coeffs[..., 5] = -0.1
        coeffs[..., 6] = -0.1
        rhs = 0.1 * rng.standard_normal((bs, gs))
        n_init = TorchLayer(bs=bs, device="cpu", order=2, **kw).system.n_init_rows
        iv = 0.1 * rng.standard_normal((bs, n_init))
        steps = [np.full((bs, d - 1), 0.05) for d in dims]
    kw.update(bs=bs, order=2, n_ind_dim=1, n_iv=1, solver_dbl=True, n_grid=2)
    return kw, (coeffs, rhs, iv, steps)


def build(case, opts, **extra):
    """Both packages' solvers and level-0 hierarchies for one configuration,
    plus float32 test vectors b and x."""
    kw, (coeffs, rhs, iv, steps) = case_inputs(case)
    cfg = dict(dict(precision="f64", mg_smoother_steps_pre=4, mg_smoother_steps_post=4), **opts)
    jl = JaxLayer(config=JaxConfig(**cfg), **kw)
    # one jax.jit per structured-operator closure: no value changes, and the
    # factored operator's A^T (a linear_transpose, traced anew at every call
    # otherwise) is traced once per shape
    jmg = jl.mg_solver
    for ops in ("_sops", "_sops32"):
        setattr(jmg, ops, [tuple(jax.jit(f) for f in o) for o in getattr(jmg, ops)])
    tl = TorchLayer(config=TorchConfig(**cfg), device="cpu", **kw)
    for lay in (jl, tl):
        for k, v in extra.items():
            setattr(lay.mg_solver, k, v(lay))
    jsteps = [jnp.asarray(s) for s in steps]
    jvals, _, jhier = jax.jit(lambda c, r, i: jl._prepare(c, r, i, jsteps))(coeffs, rhs, iv)
    tvals, _, thier = tl._prepare(torch.tensor(coeffs), torch.tensor(rhs), torch.tensor(iv),
                                  [torch.tensor(s) for s in steps])
    rng = np.random.default_rng(5)
    n = tl.system.num_vars
    b = rng.standard_normal((2, n)).astype(np.float32)
    x = (0.1 * rng.standard_normal((2, n))).astype(np.float32)
    # the port's hierarchy on the JAX package's level data
    tmg = tl.mg_solver
    jl0 = {k: torch.tensor(np.asarray(v)) for k, v in jhier["levels"][0].items()
           if k in ("binv", "coef", "lmax")}
    steps_max = max(tmg.config.mg_smoother_steps_pre, tmg.config.mg_smoother_steps_post)
    jl0["sched"] = chebyshev_schedule(jl0["lmax"], tmg.config.mg_chebyshev_ratio, steps_max)
    on_jax = {"levels": [dict(thier["levels"][0], **jl0), thier["levels"][1]],
              "coarse_inv": torch.tensor(np.asarray(jhier["coarse_inv"]))}
    return dict(jmg=jl.mg_solver, jhier=jhier, tmg=tmg, thier=thier, on_jax=on_jax, b=b, x=x)


@pytest.fixture(scope="module")
def built():
    """build(case, config) once per module."""
    cache = {}

    def get(case, name):
        if (case, name) not in cache:
            cache[case, name] = build(case, CONFIGS[name])
        return cache[case, name]

    return get


CASES = ["transport", "gl"]


@pytest.mark.parametrize("case", CASES)
def test_point_blocks_match_jax(case, built):
    """Point-block B^-1 and lmax; and the factor W = L^-T (kept float32)."""
    g = built(case, "stencil_point")
    jl0, tl0 = g["jhier"]["levels"][0], g["thier"]["levels"][0]
    m = g["tmg"].systems[0].var_set.n_mi
    assert tuple(tl0["binv"].shape) == (2, g["tmg"].systems[0].var_set.grid_size, m, m)
    assert rel(tl0["binv"], jl0["binv"]) <= TOL
    assert rel(tl0["lmax"], jl0["lmax"]) <= TOL
    f32 = {"binv_dtype": lambda lay: lay.mg_solver.pdtype}
    w = build(case, dict(mg_block_smoother="point", mg_precond_dtype="bf16_factored"), **f32)
    jw, tw = w["jhier"]["levels"][0]["binv"], w["thier"]["levels"][0]["binv"]
    assert tw.dtype == torch.float32
    assert rel(tw, jw) <= TOL
    assert bool((tw.tril(-1) == 0).all())


def jax_smooth(g, steps, back):
    mg = g["jmg"]
    return jax.jit(jax.vmap(lambda lvl, b, x: mg._smooth(0, lvl, b, x, steps, back)))(
        g["jhier"]["levels"][0], g["b"], g["x"])


def torch_smooth(g, steps, back):
    return g["tmg"]._smooth(0, g["on_jax"]["levels"][0], torch.tensor(g["b"]),
                            torch.tensor(g["x"]), steps, back)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name,back", [("factored_line", False), ("stencil_point", False),
                                       ("stencil_jacobi", False), ("stencil_jacobi", True)])
def test_smoothing_pass_matches_jax(case, name, back, built):
    """One pass of 4 steps from a nonzero x (Jacobi: forward weight
    jacobi_w_forward, backward jacobi_w)."""
    g = built(case, name)
    got, want = torch_smooth(g, 4, back), jax_smooth(g, 4, back)
    assert got.dtype == torch.float32
    assert rel(got, want) <= TOL
    if name == "stencil_jacobi" and not back:
        # the two weights give two passes
        assert rel(got, torch_smooth(g, 4, True)) > 1e-3


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_v_cycle_matches_jax(case, name, built):
    g = built(case, name)
    mg = g["jmg"]
    want = jax.jit(jax.vmap(lambda h, b: mg.v_cycle(h, b, 0, False)))(g["jhier"], g["b"])
    got = g["tmg"].v_cycle(g["on_jax"], torch.tensor(g["b"]), 0, False)
    assert rel(got, want) <= TOL


def solver_kw(**cfg):
    return dict(bs=1, coord_dims=(16, 16), order=2, n_ind_dim=1, n_iv=1,
                init_index_mi_list=IVS_2D, solver_dbl=True, n_grid=2,
                config=cfg.pop("config"), **cfg)


@pytest.mark.parametrize("opts", [
    dict(mg_smoother="chebyshev_fused", mg_normal_op="factored"),
    dict(mg_smoother="chebyshev_fused", mg_block_smoother="point"),
    dict(mg_smoother="gauss_seidel"),
    dict(mg_normal_op="dense"),
])
def test_option_errors_match_jax(opts):
    """The JAX package's ValueErrors (chebyshev_fused with the factored
    operator or with point blocks; unknown operator or smoother)."""
    with pytest.raises(ValueError) as je:
        JaxLayer(**solver_kw(config=JaxConfig(**opts)))
    with pytest.raises(ValueError) as te:
        TorchLayer(device="cpu", **solver_kw(config=TorchConfig(**opts)))
    key = "chebyshev_fused" if "chebyshev_fused" in str(je.value) else "unknown"
    assert key in str(te.value)


def test_evolution_falls_back_and_mesh_raises():
    """Evolution takes the factored operator (a config copy; the caller's is
    untouched) and builds no stencil descriptor; chebyshev_fused refuses it;
    `mesh` refuses the line blocks (the JAX package's ValueError) before it
    reads the mesh."""
    cfg = TorchConfig()
    tl = TorchLayer(device="cpu", evolution=True, **solver_kw(config=cfg))
    assert tl.mg_solver.config.mg_normal_op == "factored" and cfg.mg_normal_op == "stencil"
    assert tl.mg_solver.descs is None
    with pytest.raises(NotImplementedError):
        make_desc(tl.system.spec)
    with pytest.raises(ValueError, match="chebyshev_fused"):
        TorchLayer(device="cpu", evolution=True,
                   **solver_kw(config=TorchConfig(mg_smoother="chebyshev_fused")))
    with pytest.raises(ValueError, match="mg_block_smoother='point'"):
        TorchLayer(device="cpu", mesh=object(), **solver_kw(config=TorchConfig()))
    with pytest.raises(ValueError, match="mg_block_smoother"):
        TorchLayer(device="cpu", **solver_kw(config=TorchConfig(mg_block_smoother="plane")))
