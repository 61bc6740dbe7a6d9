"""PyTorch port vs the JAX package: static structure, fills, structured
operators, configuration, and the port's import isolation.

Inputs come from numpy with a fixed seed and go through both packages; the
port runs on the CPU (plain versions).  Tolerances: index/static arrays
exact; f64 fills 1e-12 (values) and 1e-10 (VJPs); structured A and its
hand-written adjoint 1e-12.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mech_nn_discovery_pde_torch.config import PDEConfig as TorchConfig
from mech_nn_discovery_pde_torch.ops import constraints as tcons
from mech_nn_discovery_pde_torch.ops.system import PDESystem as TorchSystem
from mech_nn_discovery_pde_tpu.config import PDEConfig as JaxConfig
from mech_nn_discovery_pde_tpu.ops import constraints as jcons
from mech_nn_discovery_pde_tpu.ops.system import PDESystem as JaxSystem

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

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

SPEC_ARRAYS = [
    "eq_rows", "eq_cols", "init_rows", "init_cols", "deriv_rows", "deriv_cols",
    "eq_values_static", "init_values_static", "deriv_values_static",
]
SPEC_SCALARS = ["n_eq_rows", "n_init_rows", "n_deriv_rows", "n_central_mi",
                "n_central_rows", "n_central_entries", "num_vars", "n_rows"]


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("dims,order,n_iv", [
    ((8,), 2, 1), ((8, 8), 2, 1), ((6, 7), 2, 2), ((8, 8, 8), 2, 1),
    ((6, 8, 10), 2, 1), ((9, 8), 1, 1),
])
def test_constraint_spec_matches_jax(dims, order, n_iv):
    """Every index and static-value array of ConstraintSpec is identical."""
    kw = dict(order=order, init_index_mi_list=IVS[len(dims)], n_iv=n_iv, step_size=0.25)
    js = jcons.build_constraint_spec(dims, **kw)
    ts = tcons.build_constraint_spec(dims, **kw)
    for name in SPEC_ARRAYS:
        assert np.array_equal(getattr(ts, name), getattr(js, name)), name
    for name in SPEC_SCALARS:
        assert getattr(ts, name) == getattr(js, name), name
    assert np.array_equal(ts.rows_all, js.rows_all)
    assert np.array_equal(ts.cols_all, js.cols_all)
    assert len(ts.iv_boxes) == len(js.iv_boxes)
    for tb, jb in zip(ts.iv_boxes, js.iv_boxes):
        assert np.array_equal(tb.flat_points, jb.flat_points)
        assert (tb.coord, tb.mi_index, tb.shape) == (jb.coord, jb.mi_index, jb.shape)


def _fill_inputs(sys_, bs, seed):
    rng = np.random.default_rng(seed)
    dims = sys_.coord_dims
    coeffs = rng.standard_normal((bs, sys_.var_set.grid_size, sys_.var_set.n_mi))
    rhs = rng.standard_normal((bs, sys_.var_set.grid_size))
    iv = rng.standard_normal((bs, sys_.n_init_rows))
    steps = [0.05 + 0.02 * rng.random((bs, d - 1)) for d in dims]
    return coeffs, rhs, iv, steps


@pytest.mark.parametrize("dims", [(9,), (7, 9), (6, 7, 8)])
def test_fills_and_vjps_match_jax(dims):
    """fill_values / fill_rhs values (f64, 1e-12) and their VJPs w.r.t.
    coefficients, steps, rhs and iv (1e-10), non-uniform steps."""
    kw = dict(order=2, init_index_mi_list=IVS[len(dims)], n_iv=1)
    jsys, tsys = JaxSystem.build(dims, **kw), TorchSystem.build(dims, **kw)
    bs = 2
    coeffs, rhs, iv, steps = _fill_inputs(tsys, bs, seed=len(dims))
    rng = np.random.default_rng(7)
    gv = rng.standard_normal((bs, tsys.n_entries))
    gr = rng.standard_normal((bs, tsys.n_rows))

    @jax.jit
    def jax_fills(c, s, r, i, gv, gr):
        jv, vjp = jax.vjp(lambda c, s: jsys.fill_values(c, s, dtype=jnp.float64), c, s)
        jr, rvjp = jax.vjp(lambda r, i: jsys.fill_rhs(r, i, dtype=jnp.float64), r, i)
        return jv, vjp(gv), jr, rvjp(gr)

    jv, (jgc, jgs), jr, (jgr, jgi) = jax_fills(
        jnp.asarray(coeffs), [jnp.asarray(s) for s in steps], jnp.asarray(rhs),
        jnp.asarray(iv), jnp.asarray(gv), jnp.asarray(gr))

    tc = torch.tensor(coeffs, requires_grad=True)
    ts = [torch.tensor(s, requires_grad=True) for s in steps]
    tv = tsys.fill_values(tc, ts, dtype=torch.float64)
    tr_ = torch.tensor(rhs, requires_grad=True)
    ti = torch.tensor(iv, requires_grad=True)
    trv = tsys.fill_rhs(tr_, ti, dtype=torch.float64)
    ((tv * torch.tensor(gv)).sum() + (trv * torch.tensor(gr)).sum()).backward()

    assert rel(tv.detach(), jv) <= 1e-12
    assert rel(trv.detach(), jr) <= 1e-12
    assert rel(tc.grad, jgc) <= 1e-10
    for t, j in zip(ts, jgs):
        assert rel(t.grad, j) <= 1e-10
    assert rel(tr_.grad, jgr) <= 1e-10
    assert rel(ti.grad, jgi) <= 1e-10


@pytest.mark.parametrize("dims", [(9,), (7, 9), (6, 7, 8)])
def test_structured_operator_and_adjoint_match_jax(dims):
    """A x and the hand-written A^T y match the JAX package (whose
    transpose is jax.linear_transpose) to 1e-12, and are adjoint."""
    kw = dict(order=2, init_index_mi_list=IVS[len(dims)], n_iv=1, step_size=0.15)
    jsys, tsys = JaxSystem.build(dims, **kw), TorchSystem.build(dims, **kw)
    rng = np.random.default_rng(11)
    bs = 2
    values = rng.standard_normal((bs, tsys.n_entries))
    x = rng.standard_normal((bs, tsys.num_vars))
    y = rng.standard_normal((bs, tsys.n_rows))
    tv, tx, ty = (torch.tensor(a) for a in (values, x, y))
    Ax = tsys.matvec_s(tv, tx)
    ATy = tsys.rmatvec_s(tv, ty)
    jax_ops = jax.jit(lambda v, x, y: (jax.vmap(jsys.matvec_s)(v, x),
                                       jax.vmap(jsys.rmatvec_s)(v, y)))
    jAx, jATy = jax_ops(jnp.asarray(values), jnp.asarray(x), jnp.asarray(y))
    assert rel(Ax, jAx) <= 1e-12
    assert rel(ATy, jATy) <= 1e-12
    lhs = (Ax * ty).sum(dim=1)
    rhs_ = (tx * ATy).sum(dim=1)
    assert float(((lhs - rhs_).abs() / rhs_.abs()).max()) <= 1e-12
    # the COO path computes the same operator
    assert rel(tsys.matvec_coo(tv, tx), Ax) <= 1e-12
    assert rel(tsys.rmatvec_coo(tv, ty), ATy) <= 1e-12


def test_config_fields_match_jax():
    """The port's PDEConfig has every field of the JAX package's, with the
    same defaults."""
    jf = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(TorchConfig)}
    assert tf == jf


def _case_var_index():
    from mech_nn_discovery_pde_torch.ops.multi_index import VariableSet as TV
    from mech_nn_discovery_pde_tpu.ops.multi_index import VariableSet as JV

    for dims, order in (((8,), 1), ((6, 7), 2), ((6, 7, 8), 2)):
        tv, jv = TV(dims, order), JV(dims, order)
        g = np.random.default_rng(0).integers(0, tv.grid_size, 17)
        for mi in range(tv.n_mi):
            np.testing.assert_array_equal(tv.var_index(g, mi), jv.var_index(g, mi))
        assert tv.solution_shape(3) == jv.solution_shape(3)
        assert tv.mi_repr == jv.mi_repr and tv.mi_to_index == jv.mi_to_index


def _specs(dims=(6, 7)):
    return (tcons.build_constraint_spec(dims, 2, IVS[len(dims)], 1, 0.1),
            jcons.build_constraint_spec(dims, 2, IVS[len(dims)], 1, 0.1))


def _case_values_static_all():
    for dims in ((8,), (6, 7), (6, 7, 8)):
        ts, js = _specs(dims)
        np.testing.assert_array_equal(ts.values_static_all, js.values_static_all)


def _case_render_rows():
    ts, js = _specs()
    vals = np.random.default_rng(1).normal(size=ts.eq_rows.shape[0])
    rhs = np.random.default_rng(2).normal(size=ts.n_eq_rows)
    for block in ("equation", "initial", "derivative"):
        assert tcons.render_rows(ts, block, max_rows=9) == jcons.render_rows(js, block,
                                                                              max_rows=9)
    assert (tcons.render_rows(ts, "equation", vals, rhs)
            == jcons.render_rows(js, "equation", vals, rhs))


def _case_resize_grid():
    from mech_nn_discovery_pde_torch.ops.interp import resize_grid as tr
    from mech_nn_discovery_pde_tpu.ops.interp import resize_grid as jr

    g = np.random.default_rng(3)
    for shape, old, new in (((2, 8, 16), (8, 16), (5, 9)), ((2, 3, 6, 8, 10), (6, 8, 10),
                                                            (3, 4, 5))):
        x = g.normal(size=shape)
        got = tr(torch.tensor(x), old, new).numpy()
        assert rel(got, np.asarray(jr(jnp.asarray(x), old, new))) <= 1e-12


def _case_sine_dataset():
    from mech_nn_discovery_pde_torch.data.datasets import SineDataset as TS
    from mech_nn_discovery_pde_tpu.data.datasets import SineDataset as JS

    for dims, end in (((32, 32), 1.0), ((16, 24), 2.0)):
        t, j = TS(dims, end), JS(dims, end)
        assert len(t) == len(j) == 1
        assert rel(t[0], j[0]) <= 1e-12


def _case_stable_argsort():
    from mech_nn_discovery_pde_torch.ops import native as tn
    from mech_nn_discovery_pde_tpu.ops import native as jn

    keys = np.random.default_rng(4).integers(0, 50, 1000)
    want = np.argsort(keys, kind="stable")
    for dt in (np.int64, np.int32):
        got = tn.stable_argsort(keys.astype(dt))
        assert got is not None, tn.error()
        np.testing.assert_array_equal(got, want)
        ref = jn.stable_argsort(keys.astype(dt))
        if ref is not None:
            np.testing.assert_array_equal(got, ref)
    assert tn.stable_argsort(keys.astype(np.float64)) is None


def _case_data_dirs():
    for root in ("data", "/x/y"):
        t, j = TorchConfig(data_root=root), JaxConfig(data_root=root)
        for name in ("ginzburg_dir", "rheology_dir", "burgers_dir"):
            assert getattr(t, name) == getattr(j, name)


PUBLIC_CASES = {
    "var_index_solution_shape": _case_var_index,
    "values_static_all": _case_values_static_all,
    "render_rows": _case_render_rows,
    "resize_grid": _case_resize_grid,
    "sine_dataset": _case_sine_dataset,
    "stable_argsort": _case_stable_argsort,
    "data_dirs": _case_data_dirs,
}


@pytest.mark.parametrize("case", list(PUBLIC_CASES))
def test_public_functions_match_jax(case):
    """The JAX package's public helpers and their copies in the port give the
    same results on the same inputs (index maps and strings exactly, floats
    to 1e-12)."""
    PUBLIC_CASES[case]()


PORT_MODULES = ["mech_nn_discovery_pde_torch"] + [
    "mech_nn_discovery_pde_torch." + m for m in (
        "config", "ops.multi_index", "ops.constraints", "ops.interp", "ops.stencil",
        "ops.structured", "ops.system", "ops.normal_stencil", "ops.fused_smoother",
        "ops.normal_solve", "ops._cuda", "solvers.krylov", "solvers.multigrid",
        "layers.multigrid", "models.paramnet", "data.generate", "data.datasets",
        "discovery.common", "discovery.ginzburg_landau", "solvers.cholesky", "layers.dense",
        "entry", "models.resnet", "discovery.burgers", "fit.sine_fit",
        "examples.transport_dense", "examples.transport_multigrid", "discovery.kamani",
        "utils", "utils.logger", "utils.rundir", "utils.profiling", "utils.checkpoint",
    )
]
FORBIDDEN = ("jax", "flax", "optax", "orbax", "mech_nn_discovery_pde_tpu")


def test_port_imports_no_jax():
    """Importing every module of the port (and chip_smoke) pulls in neither
    JAX nor the JAX package, and no port file names them in an import."""
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    files = list((ROOT / "mech_nn_discovery_pde_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        for line in f.read_text().splitlines():
            words = line.strip().replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                roots = {w.split(".")[0] for w in words[1:] if w not in ("import", "as")}
                assert not roots & set(FORBIDDEN), f"{f}: {line.strip()}"
