"""The rank side of tests/test_torch_parallel.py: the port's cases that run
on a 4-rank gloo group on the CPU, one process per rank.

The ranks import this module, so it imports no JAX, and neither may the
port: `run_all` reports whether `jax` was imported, and the test asserts
it was not.  The test module prepares the inputs as numpy arrays, runs the
JAX references in its own process and compares.  Each case's result is
numpy arrays and numbers, per rank.
"""

from __future__ import annotations

import sys

import torch

from mech_nn_discovery_pde_torch.config import PDEConfig
from mech_nn_discovery_pde_torch.layers.multigrid import MultigridLayer
from mech_nn_discovery_pde_torch.models.paramnet import ParamNet
from mech_nn_discovery_pde_torch.ops.normal_stencil import build_normal_coef, make_desc
from mech_nn_discovery_pde_torch.ops.system import PDESystem
from mech_nn_discovery_pde_torch.parallel import dryrun
from mech_nn_discovery_pde_torch.parallel.halo import sharded_axis_derivative
from mech_nn_discovery_pde_torch.parallel.mesh import (
    all_reduce_sum_,
    make_mesh,
    replicate,
    shard_batch,
)
from mech_nn_discovery_pde_torch.parallel.sharded_normal import (
    coef_to_grid,
    make_sharded_normal_ops,
    shard_layout,
    to_channel_major_grid,
)

CPU = torch.device("cpu")
IVS = {
    2: [lambda nt, nx: (0, 0, [0, 0], [0, nx - 1])],
    3: [lambda nt, nx, ny: (0, 0, [0, 0, 0], [0, nx - 1, ny - 1])],
}
# the sharded layer's cases: the JAX package's residual-parity setup
# (test_sharded_normal.py: bs 2, (16, 12), point blocks, n_grid 2, FGMRES 15
# in windows of 2), and the same sizes with the dry run's three boundary
# boxes and a budget that converges
LAYER_DIMS = (16, 12)
PARITY_CFG = dict(precision="f64", mg_block_smoother="point", mg_fgmres_max_iter_forward=15,
                  mg_fgmres_restarts_forward=2)
CONVERGED_CFG = dict(precision="f64", mg_block_smoother="point", mg_fgmres_tol=1e-14,
                     mg_fgmres_max_iter_forward=150, mg_fgmres_restarts_forward=30,
                     mg_fgmres_max_iter_backward=150, mg_fgmres_restarts_backward=30)
# the dp case's budget: one that converges (rel_rnorm ~3e-14), at which the
# loss is fixed to 4e-12 by the inputs alone.  At the dry run's own budget (8
# in windows of 2, rel_rnorm ~3e-2) the loss follows rounding: it moves by
# 1.2e-4 between one batch of 2 and two of 1 in the port itself, and by
# 2.5e-7 between the packages; at 300 in windows of 30 (rel_rnorm 1e-11)
# still by 1e-9.
DP_CONVERGED = dict(mg_fgmres_max_iter_forward=300, mg_fgmres_restarts_forward=60,
                    mg_fgmres_max_iter_backward=300, mg_fgmres_restarts_backward=60,
                    mg_fgmres_tol=1e-14)


def layer(bs, dims, ivs, cfg, mesh=None):
    return MultigridLayer(bs=bs, coord_dims=dims, order=2, n_ind_dim=1, n_iv=1,
                          init_index_mi_list=ivs, solver_dbl=True, n_grid=2,
                          config=PDEConfig(**cfg), device=CPU, mesh=mesh)


def steps(bs, dims, hs):
    return [torch.full((bs, d - 1), h, dtype=torch.float64) for d, h in zip(dims, hs)]


def mesh_case(meshes):
    """Each mesh's axis sizes and this rank's place on them, and what
    `replicate` over the (2, 2) mesh leaves of a tensor holding the rank."""
    out = {name: {ax: (m.size(i), m.get_local_rank(ax))
                  for i, ax in enumerate(m.mesh_dim_names)}
           for name, m in meshes.items()}
    rank = float(torch.distributed.get_rank())
    tree = replicate(meshes["m22"], {"a": torch.full((3,), rank), "b": [torch.tensor(rank)]})
    out["replicated"] = [float(tree["a"].sum()), float(tree["b"][0])]
    return out


def error_case(meshes):
    """The ValueError (type name and message) each refused option raises."""
    m14 = meshes["m14"]
    cases = {
        "d0_not_divisible": ((18, 12), dict(mg_block_smoother="point")),
        "n_loc_below_halo": ((12, 12), dict(mg_block_smoother="point")),
        "line_smoother": (LAYER_DIMS, dict(mg_block_smoother="line")),
        "chebyshev_fused": (LAYER_DIMS, dict(mg_smoother="chebyshev_fused")),
        "factored": (LAYER_DIMS, dict(mg_normal_op="factored", mg_block_smoother="point")),
    }
    out = {}
    for name, (dims, cfg) in cases.items():
        try:
            layer(1, dims, IVS[2], cfg, mesh=m14)
            out[name] = ("none", "")
        except Exception as e:  # the test checks the type
            out[name] = (type(e).__name__, str(e))
    return out


def halo_case(meshes, x):
    """The 5-point derivative on a (1, 4) mesh: this rank's rows."""
    m14 = meshes["m14"]
    lay_n = x.shape[0] // 4
    r = m14.get_local_rank("sp")
    fn = sharded_axis_derivative(m14.get_group("sp"), [1 / 12, -2 / 3, 0.0, 2 / 3, -1 / 12])
    return fn(torch.tensor(x[r * lay_n : (r + 1) * lay_n])).numpy()


def matvec_case(meshes, dims, n_sp, values, x, repeats):
    """The sharded channel-major matvec (`repeats` applies, each normalised
    by the global norm when repeats > 1): this rank's (m, n_loc, R)."""
    mesh = meshes["m14" if n_sp == 4 else "m22"]
    sys_ = PDESystem.build(dims, order=2, init_index_mi_list=IVS[len(dims)], n_iv=1,
                           step_size=0.1)
    desc = make_desc(sys_.spec)
    vals = torch.tensor(values)[None]
    coef = build_normal_coef(sys_.spec, desc, sys_.split_values(vals))[0]
    group = mesh.get_group("sp")
    lay = shard_layout(desc, group)
    extend_coef, apply_ = make_sharded_normal_ops(mesh, desc)
    coef_h = extend_coef(coef_to_grid(desc, coef)[:, lay.planes].contiguous())
    x3 = to_channel_major_grid(desc, torch.tensor(x))[:, lay.planes].contiguous()
    for _ in range(repeats):
        x3 = apply_(coef_h, x3)
        if repeats > 1:
            x3 = x3 / torch.sqrt(all_reduce_sum_((x3 * x3).sum().reshape(1), group))
    return {"y": x3.numpy(), "sp_rank": lay.rank}


def layer_case(meshes, inp):
    """The sharded MultigridLayer on a (1, 4) mesh: the residual-parity
    setup's solve and backward-solve stats and u0, and at the converged
    budget u0 and the
    gradients of sum(u0^2) w.r.t. coefficients and rhs."""
    m14 = meshes["m14"]
    out = {}
    p = inp["parity"]
    lay = layer(2, LAYER_DIMS, IVS[2], PARITY_CFG, mesh=m14)
    args = (torch.tensor(p["coeffs"]), torch.tensor(p["rhs"]), torch.tensor(p["iv"]),
            steps(2, LAYER_DIMS, (0.05, 0.1)))
    st = lay.solve_stats(*args)
    u0, _, _ = lay(*args)
    bst = lay.backward_stats(*args, torch.tensor(p["g"]))
    out["parity"] = {"rel_rnorm": st["rel_rnorm"].numpy(), "u0": u0.detach().numpy(),
                     "back_rel_rnorm": bst["rel_rnorm"].numpy(),
                     "back_finite": bst["finite"].numpy()}
    c = inp["converged"]
    lay = layer(2, LAYER_DIMS, dryrun.IVS, CONVERGED_CFG, mesh=m14)
    tc = torch.tensor(c["coeffs"], requires_grad=True)
    tr = torch.tensor(c["rhs"], requires_grad=True)
    u0, _, _ = lay(tc, tr, torch.tensor(c["iv"]), steps(2, LAYER_DIMS, (0.05, 0.1)))
    (u0**2).sum().backward()
    out["converged"] = {"u0": u0.detach().numpy(), "gc": tc.grad.numpy(),
                        "gr": tr.grad.numpy()}
    return out


def dp_step(pnet_state, patches, mesh, cfg):
    """The dry run's multigrid training step: (global loss, parameters after
    one Adam step), the batch split over the mesh's dp axis (mesh None: one
    process, the whole batch)."""
    pnet = ParamNet(n_out=3, depth=2, width=32, in_dim=8, dtype=torch.float64, device=CPU)
    pnet.load_state_dict({k: torch.tensor(v) for k, v in pnet_state.items()})
    pt = torch.tensor(patches)
    if mesh is not None:
        pt = shard_batch(mesh, pt)
    lay = dryrun.mg_layer(pt.shape[0], CPU, **cfg)
    opt = torch.optim.Adam(pnet.parameters(), lr=1e-4)
    if mesh is None:
        opt.zero_grad()
        loss = dryrun.mg_loss(pnet, lay, pt)
        loss.backward()
        opt.step()
        loss = float(loss.detach())
    else:
        loss = dryrun.train_step(lambda: dryrun.mg_loss(pnet, lay, pt),
                                 list(pnet.parameters()), opt, mesh)
    return loss, {k: v.detach().numpy().copy() for k, v in pnet.state_dict().items()}


def dp_case(meshes, inp):
    return dp_step(inp["pnet"], inp["patches"], meshes["m22"], DP_CONVERGED)


def run_all(rank, n_procs, device, inp):
    """Every port-side case on this rank; the meshes (4, 1), (2, 2) and
    (1, 4) over the 4 ranks."""
    meshes = {"default": make_mesh(device_type="cpu"),
              "m41": make_mesh((4, 1), device_type="cpu"),
              "m22": make_mesh((2, 2), device_type="cpu"),
              "m14": make_mesh((1, 4), device_type="cpu")}
    out = {"mesh": mesh_case(meshes), "errors": error_case(meshes),
           "halo": halo_case(meshes, inp["halo_x"]),
           "matvec": {key: matvec_case(meshes, *case) for key, case in inp["matvec"].items()},
           "layer": layer_case(meshes, inp["layer"]),
           "dp": dp_case(meshes, inp["dp"])}
    out["jax_imported"] = "jax" in sys.modules
    return out
