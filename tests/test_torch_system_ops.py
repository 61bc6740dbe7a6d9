"""PyTorch port vs the JAX package: `PDESystem`'s operators and the native
pair-table builder.

The same numpy values (fixed seed) go through the JAX package's per-sample
operators (vmapped) and the port's batched ones, in float64 on the CPU:
the evolution rows of the structured A x and A^T y on 2D (6, 7) and 3D
(6, 8, 8), with <A x, y> = <x, A^T y>; the ELL and packed operators; the
point-diagonal and dense-A assemblies; diag(AtA) and (|A|^T |A|) 1; the
equation-row padding and the fill helpers.  Tolerance 1e-12 relative
(max-abs over max-abs): the sums run in another order.  The native pair
tables (built with g++ at first use) must equal their NumPy twin exactly, and sum
AtA as the JAX package does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mech_nn_discovery_pde_torch.ops import native
from mech_nn_discovery_pde_torch.ops.system import PDESystem as TorchSystem
from mech_nn_discovery_pde_tpu.ops import native as jnative
from mech_nn_discovery_pde_tpu.ops.structured import make_structured_ops, split_values
from mech_nn_discovery_pde_tpu.ops.system import PDESystem as JaxSystem

torch.set_num_threads(1)
TOL = 1e-12
BS = 3

CASES = {
    "2d": ((6, 7), [lambda nx, ny: (0, 0, [0, 0], [0, ny - 1])]),
    "3d": ((6, 8, 8), [lambda nt, nx, ny: (0, 0, [0, 0, 0], [0, nx - 1, ny - 1]),
                       lambda nt, nx, ny: (1, 0, [1, 0, 0], [nt - 1, 0, ny - 1])]),
}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def systems(case, evolution=False):
    dims, ivs = CASES[case]
    kw = dict(init_index_mi_list=ivs, evolution=evolution)
    return JaxSystem.build(dims, **kw), TorchSystem.build(dims, **kw)


def random_inputs(sys, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BS, sys.n_entries)), rng.standard_normal((BS, sys.num_vars)),
            rng.standard_normal((BS, sys.n_rows)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_evolution_structured_ops_match_jax(case):
    """Evolution rows read the time-derivative mi one time step back: the
    port's structured A x and its hand-written adjoint equal the JAX
    package's (and its linear transpose), and are adjoint to each other."""
    js, ts = systems(case, evolution=True)
    vals, x, y = random_inputs(js, 1)
    mv, rmv = make_structured_ops(js.spec, jnp.float64)
    jmv = jax.vmap(lambda v, u: mv(split_values(js.spec, v), u))
    jrmv = jax.vmap(lambda v, w: rmv(split_values(js.spec, v), w))
    tv, tx, ty = (torch.tensor(a) for a in (vals, x, y))
    ax = ts.matvec_s(tv, tx)
    aty = ts.rmatvec_s(tv, ty)
    assert rel(ax, jmv(vals, x)) <= TOL
    assert rel(aty, jrmv(vals, y)) <= TOL
    # the structured path agrees with the COO one and is its own adjoint
    assert rel(ax, ts.matvec_coo(tv, tx)) <= TOL
    assert rel(aty, ts.rmatvec_coo(tv, ty)) <= TOL
    lhs, rhs = (ax * ty).sum(1), (tx * aty).sum(1)
    assert float((lhs - rhs).abs().max() / lhs.abs().max()) <= TOL
    smv, srmv = ts.structured_ops()
    sv = ts.split_values(tv)
    assert torch.equal(smv(sv, tx), ax) and torch.equal(srmv(sv, ty), aty)


@pytest.mark.parametrize("evolution", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_system_operators_match_jax(case, evolution):
    """ELL and packed A x / A^T y, normal_matvec, normal_diag,
    normal_bound_vec, the point blocks, dense A and dense AtA."""
    js, ts = systems(case, evolution)
    vals, x, y = random_inputs(js, 2)
    tv, tx, ty = (torch.tensor(a) for a in (vals, x, y))
    jv = jnp.asarray(vals)
    pairs = [
        (ts.matvec(tv, tx), jax.vmap(js.matvec)(jv, x)),
        (ts.rmatvec(tv, ty), jax.vmap(js.rmatvec)(jv, y)),
        (ts.normal_matvec(tv, tx), jax.vmap(js.normal_matvec)(jv, x)),
        (ts.normal_diag(tv), jax.vmap(js.normal_diag)(jv)),
        (ts.normal_bound_vec(tv), jax.vmap(js.normal_bound_vec)(jv)),
        (ts.assemble_point_blocks(tv), jax.vmap(js.assemble_point_blocks)(jv)),
        (ts.assemble_dense_A(tv), jax.vmap(js.assemble_dense_A)(jv)),
        (ts.assemble_normal(tv), jax.vmap(js.assemble_normal)(jv)),
    ]
    packed = ts.pack_values(tv)
    jpacked = jax.vmap(js.pack_values)(jv)
    pairs += [
        (packed["r"], jpacked["r"]),
        (packed["c"], jpacked["c"]),
        (ts.matvec_packed(packed, tx), jax.vmap(js.matvec_packed)(jpacked, x)),
        (ts.rmatvec_packed(packed, ty), jax.vmap(js.rmatvec_packed)(jpacked, y)),
        (ts.normal_matvec_packed(packed, tx), jax.vmap(js.normal_matvec_packed)(jpacked, x)),
    ]
    for k, (got, want) in enumerate(pairs):
        assert tuple(got.shape) == tuple(np.shape(want)), k
        assert rel(got, want) <= TOL, k
    # the point blocks are the n_mi x n_mi diagonal blocks of the dense AtA
    m, g = ts.var_set.n_mi, ts.var_set.grid_size
    ata = ts.assemble_normal(tv).reshape(BS, g, m, g, m)
    diag = torch.diagonal(ata, dim1=1, dim2=3).permute(0, 3, 1, 2)
    assert rel(ts.assemble_point_blocks(tv), diag) <= TOL


def test_fill_helpers_match_jax():
    """equation_values, derivative_values and pad_eq_rows (the inverse of
    the rhs crop)."""
    js, ts = systems("3d")
    rng = np.random.default_rng(3)
    gs, m = ts.var_set.grid_size, ts.var_set.n_mi
    coeffs = rng.standard_normal((BS, gs, m))
    steps = [0.05 + 0.1 * rng.random((BS, d - 1)) for d in ts.coord_dims]
    eqv = rng.standard_normal((BS, ts.n_eq_rows))
    assert rel(ts.equation_values(torch.tensor(coeffs)), js.equation_values(coeffs)) <= TOL
    assert rel(ts.derivative_values([torch.tensor(s) for s in steps]),
               js.derivative_values([jnp.asarray(s) for s in steps])) <= TOL
    padded = ts.pad_eq_rows(torch.tensor(eqv))
    assert np.array_equal(padded.numpy(), np.asarray(js.pad_eq_rows(jnp.asarray(eqv))))
    rhs = ts.fill_rhs(padded, torch.zeros((BS, ts.n_init_rows), dtype=torch.float64))
    assert np.array_equal(rhs[:, : ts.n_eq_rows].numpy(), eqv)


@pytest.mark.parametrize("dims", [(6, 8), (6, 12, 12)])
def test_native_pair_tables(dims):
    """The native builder compiles (g++) and its tables equal the NumPy
    twin's exactly and the JAX package's (native or NumPy-sorted); AtA from
    them is the JAX package's bit for bit."""
    assert native.available(), native.error()
    ts = TorchSystem.build(dims)
    got = native.build_pairs_sorted(ts.rows_all, ts.cols_all, ts.num_vars)
    want = native.pairs_sorted_numpy(ts.rows_all, ts.cols_all, ts.num_vars)
    for a, b in zip(got, want):
        assert a.dtype == np.int64 and np.array_equal(a, b)
    assert all(np.array_equal(a, b) for a, b in zip(ts._pairs, got))
    js = JaxSystem.build(dims)
    jp = jnative.build_pairs_sorted(js.rows_all, js.cols_all, js.num_vars)
    if jp is None:  # the JAX package's NumPy fallback sorts lin alone
        ppa, ppb = js._raw_pairs
        lin = js.cols_all[ppa].astype(np.int64) * js.num_vars + js.cols_all[ppb]
        assert np.array_equal(np.sort(lin, kind="stable"), got[2])
    else:
        assert all(np.array_equal(np.asarray(a, np.int64), b) for a, b in zip(jp, got))
        vals = np.random.default_rng(4).standard_normal((2, ts.n_entries))
        assert np.array_equal(ts.assemble_normal(torch.tensor(vals)).numpy(),
                              np.asarray(jax.vmap(js.assemble_normal)(jnp.asarray(vals))))
    with pytest.raises(ValueError):
        native.pairs_sorted_numpy(ts.rows_all[::-1], ts.cols_all, ts.num_vars)
