"""PyTorch port vs the JAX package: parallel/ (the mesh, the halo exchange,
the sp-sharded normal matvec), the sp-sharded MultigridLayer, the dp-split
training step and the multi-process dry run.

The port's cases run once, in a module-scoped fixture, on 4 gloo ranks on
the CPU (spawned processes, one torch thread each; tests/
torch_parallel_cases.py, which imports no JAX, and each rank reports
whether it was imported); the JAX references (and the one-process port
references) run here on the 8 virtual CPU devices of conftest.py while the
ranks compute.  Inputs are numpy arrays from seeded generators.

Tolerances: the halo derivative 1e-12 and the sharded matvec 1e-10
(float64, as the JAX package's own tests).  The sharded layer: at the JAX
package's residual-parity setup (FGMRES 15 in windows of 2, which stops at
rel_rnorm ~1e-2 on a system with one boundary box), the JAX package's own
bars, rel_rnorm <= 1.5x the JAX unsharded solve's and u0 within 5e-2 of the
unsharded layer's (the port's: see the test); at the same sizes with the dry run's three boundary
boxes and 150 FGMRES iterations (rel_rnorm ~1e-10), u0 within 1e-8 of the
JAX unsharded layer and the gradients within 1e-6.  The dp case, at a
budget that converges (torch_parallel_cases.DP_CONVERGED: at the dry run's
own 8 iterations the loss follows the rounding), holds the loss to the JAX
package's and the parameters after one Adam step to the one-process port
step within 1e-10.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
from mech_nn_discovery_pde_torch.models.paramnet import state_dict_from_flax
from mech_nn_discovery_pde_torch.parallel.dryrun import dryrun_multichip, spawn_ranks
from mech_nn_discovery_pde_tpu.config import PDEConfig as JaxConfig
from mech_nn_discovery_pde_tpu.layers.multigrid import MultigridLayer as JaxLayer
from mech_nn_discovery_pde_tpu.models.paramnet import ParamNet as JaxParamNet
from mech_nn_discovery_pde_tpu.ops.normal_stencil import (
    build_normal_coef,
    make_desc,
    normal_stencil_matvec,
)
from mech_nn_discovery_pde_tpu.ops.structured import split_values
from mech_nn_discovery_pde_tpu.ops.system import PDESystem
from mech_nn_discovery_pde_tpu.parallel import halo, mesh as pmesh
from mech_nn_discovery_pde_tpu.parallel.sharded_normal import (
    coef_to_grid,
    from_channel_major_grid,
    make_sharded_normal_ops,
    to_channel_major_grid,
)
from jax.sharding import NamedSharding, PartitionSpec as P

torch.set_num_threads(1)

# the JAX package's sharded-matvec cases (test_sharded_normal.py): key ->
# (dims, n_sp, values seed, repeated applies)
MATVEC = {"16x12_sp4": ((16, 12), 4, 0, 1), "16x12_sp2": ((16, 12), 2, 0, 1),
          "8x7x6_sp2": ((8, 7, 6), 2, 0, 1), "repeated_16x8_sp4": ((16, 8), 4, 1, 3)}
WEIGHTS_5PT = [1 / 12, -2 / 3, 0.0, 2 / 3, -1 / 12]


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def matvec_inputs(dims, seed):
    sys_ = PDESystem.build(dims, order=2, init_index_mi_list=cases.IVS[len(dims)], n_iv=1,
                           step_size=0.1)
    rng = np.random.default_rng(seed)
    return rng.standard_normal(sys_.n_entries), rng.standard_normal(sys_.num_vars)


def layer_inputs(ivs, hs_iv):
    rng = np.random.default_rng(0)
    lay = cases.layer(2, cases.LAYER_DIMS, ivs, dict(precision="f64"))
    coeffs = np.zeros((2, lay.grid_size, lay.n_orders))
    coeffs[..., 1] = 1.0
    coeffs[..., 2] = 1.0
    rhs = 0.1 * rng.standard_normal((2, lay.grid_size))
    iv = 0.3 * rng.standard_normal((2, hs_iv(lay)))
    g = rng.standard_normal((2, lay.system.num_vars))
    return {"coeffs": coeffs, "rhs": rhs, "iv": iv, "g": g}


@pytest.fixture(scope="module")
def inputs():
    pnet_params = JaxParamNet(n_out=3, depth=2, width=32, in_dim=8,
                              param_dtype=jnp.float64).init(jax.random.PRNGKey(7))
    return {
        "halo_x": np.random.default_rng(1).standard_normal((64, 16)),
        "matvec": {k: (dims, n_sp, *matvec_inputs(dims, seed), reps)
                   for k, (dims, n_sp, seed, reps) in MATVEC.items()},
        "layer": {"parity": layer_inputs(cases.IVS[2], lambda lay: cases.LAYER_DIMS[1]),
                  "converged": layer_inputs(cases.dryrun.IVS,
                                            lambda lay: lay.system.n_init_rows)},
        "dp": {"pnet": {k: v.numpy() for k, v in state_dict_from_flax(
                   jax.tree.map(np.asarray, pnet_params)).items()},
               "patches": np.random.default_rng(3).standard_normal((2,) + cases.dryrun.MG_DIMS),
               "flax": pnet_params},
    }


def jax_mesh(shape):
    n = int(np.prod(shape))
    return pmesh.make_mesh(shape, ("dp", "sp"), devices=jax.devices()[:n])


def jax_layer(ivs, cfg, mesh=None, dims=cases.LAYER_DIMS):
    return JaxLayer(bs=2, coord_dims=dims, order=2, n_ind_dim=1, n_iv=1,
                    init_index_mi_list=ivs, solver_dbl=True, n_grid=2,
                    config=JaxConfig(**cfg), mesh=mesh)


def jax_steps(hs, dims=cases.LAYER_DIMS):
    return [jnp.full((2, d - 1), h) for d, h in zip(dims, hs)]


def jax_matvec(key, dims, n_sp, values, x, reps):
    """(the JAX package's sharded matvec, its unsharded one) of a case."""
    sys_ = PDESystem.build(dims, order=2, init_index_mi_list=cases.IVS[len(dims)], n_iv=1,
                           step_size=0.1)
    desc = make_desc(sys_.spec)

    @jax.jit
    def unsharded(values, want):
        coef = build_normal_coef(sys_.spec, desc, split_values(sys_.spec, values))
        for _ in range(reps):
            want = normal_stencil_matvec(desc, coef, want)
            if reps > 1:
                want = want / jnp.linalg.norm(want)
        return coef, want

    coef, want = unsharded(jnp.asarray(values), jnp.asarray(x))
    mesh = jax_mesh((8 // n_sp, n_sp))
    extend_coef, apply_ = make_sharded_normal_ops(mesh, desc)
    spec = NamedSharding(mesh, P(None, "sp", None))
    c3 = jax.device_put(coef_to_grid(desc, coef), spec)
    x3 = jax.device_put(to_channel_major_grid(desc, jnp.asarray(x)), spec)

    @jax.jit
    def run(c3, x3):
        coef_h = extend_coef(c3)
        for _ in range(reps):
            x3 = apply_(coef_h, x3)
            if reps > 1:
                x3 = x3 / jnp.linalg.norm(x3)
        return x3

    return np.asarray(from_channel_major_grid(desc, run(c3, x3))), np.asarray(want)


def jax_mg_loss(flax_params, patches):
    """The JAX dry run's mg_loss_fn on bs 2 at the dp case's budget."""
    pnet = JaxParamNet(n_out=3, depth=2, width=32, in_dim=8, param_dtype=jnp.float64)
    dims = cases.dryrun.MG_DIMS
    jl = jax_layer(cases.dryrun.IVS, {**cases.dryrun.MG_CFG, **cases.DP_CONVERGED}, dims=dims)

    @jax.jit
    def mg_loss_fn(params, patches):
        cvec = pnet.apply(params).reshape(-1)[:3]
        coeffs = jnp.zeros((2, jl.grid_size, jl.n_orders))
        coeffs = coeffs.at[..., 1].set(1.0 + 0.1 * cvec[0])
        coeffs = coeffs.at[..., 2].set(cvec[1]).at[..., 4].set(cvec[2])
        d0, d1 = dims
        iv_rhs = jnp.concatenate([patches[:, 0, : d1 - 1], patches[:, 1:d0, 0],
                                  patches[:, :, d1 - 1]], axis=-1)
        u0, _, _ = jl(coeffs, jnp.zeros((2, jl.grid_size)), iv_rhs, jax_steps((0.05, 0.05), dims))
        return jnp.abs(u0.reshape(2, -1) - patches.reshape(2, -1)).mean()

    return float(mg_loss_fn(flax_params, jnp.asarray(patches)))


@pytest.fixture(scope="module")
def ranks_future(inputs):
    """Every port-side case, once, on 4 gloo ranks, started in the
    background."""
    inp = {k: v for k, v in inputs.items() if k != "dp"}
    inp["dp"] = {k: v for k, v in inputs["dp"].items() if k != "flax"}
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(spawn_ranks, cases.run_all, 4, (inp,), "gloo", "cpu", 600.0)


@pytest.fixture(scope="module")
def refs(inputs, ranks_future):
    """The references, computed while the ranks run: the JAX package's, and
    the one-process port's."""
    st = jax_steps((0.05, 0.1))
    out = {"halo": np.asarray(jax.jit(halo.sharded_axis_derivative(
        jax_mesh((1, 4)), jnp.asarray(WEIGHTS_5PT)))(jnp.asarray(inputs["halo_x"]))),
        "matvec": {k: jax_matvec(k, *case) for k, case in inputs["matvec"].items()}}
    p = inputs["layer"]["parity"]
    args = (jnp.asarray(p["coeffs"]), jnp.asarray(p["rhs"]), jnp.asarray(p["iv"]))
    base = jax_layer(cases.IVS[2], cases.PARITY_CFG)
    out["parity_rel_u"] = np.asarray(
        jax.jit(lambda c, r, i: base.solve_stats(c, r, i, st))(*args)["rel_rnorm"])
    unsharded = cases.layer(2, cases.LAYER_DIMS, cases.IVS[2], cases.PARITY_CFG)
    u_port, _, _ = unsharded(torch.tensor(p["coeffs"]), torch.tensor(p["rhs"]),
                             torch.tensor(p["iv"]), cases.steps(2, cases.LAYER_DIMS, (0.05, 0.1)))
    out["parity_u_port"] = u_port.detach().numpy()
    out["parity_back_port"] = unsharded.backward_stats(
        torch.tensor(p["coeffs"]), torch.tensor(p["rhs"]), torch.tensor(p["iv"]),
        cases.steps(2, cases.LAYER_DIMS, (0.05, 0.1)), torch.tensor(p["g"]))["rel_rnorm"].numpy()
    c = inputs["layer"]["converged"]
    jl = jax_layer(cases.dryrun.IVS, cases.CONVERGED_CFG)

    def loss(cf, r, i):
        u0 = jl(cf, r, i, st)[0]
        return jnp.sum(u0**2), u0

    (_, u0), (gc, gr) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(c["coeffs"]), jnp.asarray(c["rhs"]), jnp.asarray(c["iv"]))
    out["converged"] = {"u0": np.asarray(u0), "gc": np.asarray(gc), "gr": np.asarray(gr)}
    dp = inputs["dp"]
    out["dp_jax_loss"] = jax_mg_loss(dp["flax"], dp["patches"])
    out["dp_port"] = cases.dp_step(dp["pnet"], dp["patches"], None, cases.DP_CONVERGED)
    return out


@pytest.fixture(scope="module")
def ranks(ranks_future, refs):
    return ranks_future.result()


def test_ranks_import_no_jax(ranks):
    assert not any(r["jax_imported"] for r in ranks)


@pytest.mark.parametrize("name,shape", [("default", (4, 1)), ("m41", (4, 1)), ("m22", (2, 2)),
                                        ("m14", (1, 4))])
def test_make_mesh_shapes(ranks, name, shape):
    """Axis sizes, and each rank's place along each axis (ranks in C order
    over the shape), as the JAX package's make_mesh lays devices out."""
    for r, res in enumerate(ranks):
        got = res["mesh"][name]
        coords = np.unravel_index(r, shape)
        assert got == {"dp": (shape[0], int(coords[0])), "sp": (shape[1], int(coords[1]))}


def test_replicate_broadcasts_rank0(ranks):
    """`replicate` over the (2, 2) mesh gives every rank mesh coordinate
    (0, 0)'s tensors (rank 0 holds zeros; every other rank its own rank)."""
    assert [r["mesh"]["replicated"] for r in ranks] == [[0.0, 0.0]] * 4


ERROR_CASES = {
    "d0_not_divisible": ((18, 12), dict(mg_block_smoother="point"), AssertionError,
                         "does not split"),
    "n_loc_below_halo": ((12, 12), dict(mg_block_smoother="point"), AssertionError,
                         ">= 4 planes"),
    "line_smoother": (cases.LAYER_DIMS, dict(mg_block_smoother="line"), ValueError,
                      "mg_block_smoother='point'"),
    "chebyshev_fused": (cases.LAYER_DIMS, dict(mg_smoother="chebyshev_fused"), ValueError,
                        "chebyshev_fused"),
    "factored": (cases.LAYER_DIMS, dict(mg_normal_op="factored", mg_block_smoother="point"),
                 ValueError, "mg_normal_op='stencil'"),
}


@pytest.mark.parametrize("name", list(ERROR_CASES))
def test_sharded_options_raise_where_jax_does(ranks, name):
    """The port raises ValueError where the JAX package refuses a sharded
    layer (with a ValueError, or its assert on the grid's split; the rank
    side is torch_parallel_cases.error_case)."""
    dims, cfg, jax_error, match = ERROR_CASES[name]
    with pytest.raises(jax_error):
        JaxLayer(bs=1, coord_dims=dims, order=2, n_ind_dim=1, n_iv=1,
                 init_index_mi_list=cases.IVS[2], solver_dbl=True, n_grid=2,
                 config=JaxConfig(**cfg), mesh=jax_mesh((1, 4)))
    for res in ranks:
        kind, msg = res["errors"][name]
        assert kind == "ValueError" and match in msg, (kind, msg)


def test_halo_derivative_matches_jax(ranks, refs):
    got = np.concatenate([r["halo"] for r in ranks], axis=0)
    np.testing.assert_allclose(got, refs["halo"], rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("key", list(MATVEC))
def test_sharded_normal_matvec_matches_jax(ranks, refs, key):
    """The port's sharded channel-major matvec (K1's plain version with the
    output window on each rank's slab) against the JAX package's sharded
    matvec and its unsharded one, within 1e-10; the repeated case applies
    three times from one coefficient halo, normalising each time."""
    n_sp = MATVEC[key][1]
    jsharded, want = refs["matvec"][key]
    # the first sp group (dp coordinate 0: world ranks 0 .. n_sp-1), by sp rank
    parts = sorted((r["matvec"][key] for r in ranks[:n_sp]), key=lambda d: d["sp_rank"])
    got = np.concatenate([p["y"] for p in parts], axis=1).transpose(1, 2, 0).reshape(-1)
    np.testing.assert_allclose(got, jsharded, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_sharded_layer_residual_parity(ranks, refs):
    """The JAX package's residual-parity setup, port sp = 4: rel_rnorm within
    1.5x the JAX unsharded solve's, and u0 within 5e-2 of the port's
    unsharded layer's (the JAX package's bar, which it holds between its own
    sharded and unsharded layers); every rank returns the same global u0.

    u0 is not held to the JAX package's here: at rel_rnorm ~0.1 the solution
    follows the float32 preconditioner's rounding, which differs between the
    packages (the JAX layer's own u0 moves by 4.1e-2 when the coefficients
    change by 1e-7; the port's is 9.9e-2 from it).  The converged case below
    holds u0 to the JAX package."""
    got = ranks[0]["layer"]["parity"]
    assert np.isfinite(got["rel_rnorm"]).all()
    np.testing.assert_array_less(got["rel_rnorm"], np.maximum(refs["parity_rel_u"] * 1.5, 1e-12))
    assert rel(got["u0"], refs["parity_u_port"]) < 5e-2
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["layer"]["parity"]["u0"], got["u0"])


def test_sharded_backward_stats(ranks, refs):
    """`backward_stats` under the mesh (the backward solve on a cotangent,
    on a fresh hierarchy): finite on every rank, rel_rnorm within 1.5x of
    the port's unsharded layer's, the same on every rank."""
    got = ranks[0]["layer"]["parity"]
    assert got["back_finite"].all()
    np.testing.assert_array_less(got["back_rel_rnorm"], refs["parity_back_port"] * 1.5)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["layer"]["parity"]["back_rel_rnorm"],
                                      got["back_rel_rnorm"])


def test_sharded_layer_converged_matches_jax(ranks, refs):
    """A converged sharded solve (sp = 4, forward and IFT backward) against
    the JAX unsharded layer: u0 within 1e-8, the gradients of sum(u0^2)
    w.r.t. coefficients and rhs within 1e-6."""
    got, want = ranks[0]["layer"]["converged"], refs["converged"]
    assert rel(got["u0"], want["u0"]) < 1e-8
    assert rel(got["gc"], want["gc"]) < 1e-6
    assert rel(got["gr"], want["gr"]) < 1e-6


def test_dp_training_step_matches(ranks, refs):
    """The dry run's multigrid training step split over dp = 2 (mesh (2, 2);
    the sp ranks repeat their dp slice), at a converged budget: its loss
    against the JAX package's mg_loss_fn and against the one-process port
    step, and the parameters after one Adam step against the one-process
    port step's, within 1e-10 on every rank."""
    loss1, params1 = refs["dp_port"]
    want = refs["dp_jax_loss"]
    for r in ranks:
        loss, params = r["dp"]
        assert abs(loss - want) <= 1e-10 * abs(want), (loss, want)
        assert abs(loss - loss1) <= 1e-10 * abs(loss1), (loss, loss1)
        for k in params1:
            assert rel(params[k], params1[k]) <= 1e-10, k


def test_dryrun_multichip_runs_on_cpu():
    res = dryrun_multichip(4, device="cpu")
    assert (res["dp"], res["sp"]) == (2, 2)
    for k in ("dense_loss", "mg_loss", "sharded_loss"):
        assert np.isfinite(res[k]), k
    assert res["matvec_err"] < 1e-10
