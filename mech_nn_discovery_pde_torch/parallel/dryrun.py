"""Multi-process runs: spawning the ranks of a process group, and the
multi-device dry run.

`spawn_ranks(fn, n_procs, ...)` starts n_procs processes (the `spawn`
method), joins them into one default process group (rendezvous through a
file in a fresh temporary directory, so concurrent runs never share a
port), calls fn(rank, n_procs, device, *args) in each and returns the
ranks' results in rank order.  A rank that fails makes the call raise; every
process it starts is stopped before it returns.

`dryrun_multichip(n_procs)` is the port of the JAX package's
`__graft_entry__.dryrun_multichip`: on a (dp, sp) mesh of n_procs ranks
(sp = 2 when n_procs is even) it runs, at the JAX package's sizes,

1. the dense discovery training step (ResNet -> ParamNets -> coefficients
   -> PDEDenseLayer -> loss -> Adam), the batch split over dp and the
   gradients averaged over it;
2. the multigrid training step (ParamNet -> coefficients -> MultigridLayer
   -> loss -> Adam), the same way;
3. the sp-sharded normal matvec against the unsharded one (relative error);
4. the sp-sharded MultigridLayer (point blocks, grid axis 0 over sp)
   forward and backward,

and prints the JAX package's summary line.  The JAX package shards the
dense patches' x axis over sp through GSPMD alone; the port has no dense
sp path (the JAX package has no explicit one to port), so the sp ranks of
a dp slice repeat its dense solve.  The weights are drawn from seeded
`torch.Generator`s with flax's default initialisation, not from the JAX
package's PRNG keys, so the losses are not the JAX package's numbers.

Run on the card (one process per card with NCCL when there are enough
cards, else gloo with the processes sharing them):
    python -m mech_nn_discovery_pde_torch.parallel.dryrun --procs 4
and on the CPU with `--device cpu`.
"""

from __future__ import annotations

import argparse
import datetime
import os
import pickle
import queue
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# the dry run's boundary boxes (the JAX package's `ivs`): u at t = 0 (but
# the last x), at x = 0 for t > 0, and at the last x
IVS = [
    lambda nt, nx: (0, 0, [0, 0], [0, nx - 2]),
    lambda nt, nx: (1, 0, [1, 0], [nt - 1, 0]),
    lambda nt, nx: (1, 0, [0, nx - 1], [nt - 1, nx - 1]),
]
DENSE_DIMS = (8, 16)
MG_DIMS = (12, 16)
SHARDED_DIMS = (16, 32)
# the multigrid step's solver settings (the JAX package's mg_cfg)
MG_CFG = dict(precision="f64", mg_fgmres_max_iter_forward=8, mg_fgmres_restarts_forward=2,
              mg_fgmres_max_iter_backward=8, mg_fgmres_restarts_backward=2)


# ---------------------------------------------------------------------------
# spawning
# ---------------------------------------------------------------------------

def _rank_main(rank: int, n_procs: int, init: str, backend: str, device: str,
               timeout_s: float, fn: Callable, args: Sequence, results) -> None:
    # one CPU thread a rank: several ranks share the host's cores
    torch.set_num_threads(1)
    # every rank runs on this host: keep gloo and NCCL on the loopback device
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dev = torch.device(device)
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None else rank % torch.cuda.device_count()
        dev = torch.device("cuda", idx)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, world_size=n_procs, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        # plain pickle: tensors travel by value (the queue's own pickler
        # would share their memory with a process that is about to exit)
        results.put((rank, pickle.dumps(fn(rank, n_procs, dev, *args))))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, n_procs: int, args: Sequence = (), backend: str = "gloo",
                device: str = "cpu", timeout_s: float = 900.0) -> List[Any]:
    """Run fn(rank, n_procs, device, *args) in n_procs new processes joined
    into one default process group of `backend`, and return their results
    (picklable; CPU tensors, numpy arrays, numbers) in rank order.

    `fn` must be importable by the new processes (a module-level function of
    a module they can import).  `device` "cuda" puts rank r on card
    r % device_count; each process runs one torch CPU thread.  Raises if a
    rank exits with an error or the ranks take longer than `timeout_s`,
    which also bounds each collective."""
    ctx = torch.multiprocessing.get_context("spawn")
    out: Dict[int, Any] = {}
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n_procs, init, backend, device, timeout_s, fn,
                                   tuple(args), results), daemon=True)
                 for r in range(n_procs)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while len(out) < n_procs:
                try:
                    r, res = results.get(timeout=1.0)
                    out[r] = pickle.loads(res)
                    continue
                except queue.Empty:
                    pass
                failed = [(r, p.exitcode) for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(f"spawn_ranks: rank {failed[0][0]} of {n_procs} exited "
                                       f"with code {failed[0][1]} (its traceback is above)")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"spawn_ranks: {n_procs} ranks took over {timeout_s} s")
            for p in procs:
                p.join(timeout=120)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"spawn_ranks: ranks exited with codes {bad}")
    return [out[r] for r in range(n_procs)]


# ---------------------------------------------------------------------------
# the dry run's pieces
# ---------------------------------------------------------------------------

def iv_from_field(u: torch.Tensor, ivs, dims: Sequence[int]) -> torch.Tensor:
    """The initial-constraint values of a field u (bs, *dims): u on each
    boundary box of `ivs`, in order, flattened (C order) and concatenated."""
    parts = []
    for f in ivs:
        _, _, b, e = f(*dims)
        sl = (slice(None),) + tuple(slice(int(i), int(j) + 1) for i, j in zip(b, e))
        parts.append(u[sl].reshape(u.shape[0], -1))
    return torch.cat(parts, dim=1)


def steps_for(bs: int, dims: Sequence[int], device, dtype=torch.float64, h: float = 0.05):
    return [torch.full((bs, d - 1), h, dtype=dtype, device=device) for d in dims]


def dense_parts(bs: int, device, seed: int = 0):
    """The dense step's layer, ResNet and three ParamNets (the JAX
    package's sizes; weights from `seed`)."""
    from mech_nn_discovery_pde_torch.layers.dense import PDEDenseLayer
    from mech_nn_discovery_pde_torch.models.paramnet import ParamNet
    from mech_nn_discovery_pde_torch.models.resnet import ResNet

    g = torch.Generator().manual_seed(seed)
    layer = PDEDenseLayer(bs=bs, coord_dims=DENSE_DIMS, order=2, n_ind_dim=1, n_iv=1,
                          init_index_mi_list=IVS, solver_dbl=True, device=device)
    # float64 nets: the JAX package's f32 parameters act on its float64
    # patches in float64
    f64 = dict(dtype=torch.float64, device="cpu", generator=g)
    resnet = ResNet(out_channels=1, in_channels=1, width=16, depth=2, **f64).to(device)
    pnets = torch.nn.ModuleList(ParamNet(n_out=5, depth=2, width=64, in_dim=32, **f64)
                                for _ in range(3)).to(device)
    return layer, resnet, pnets


def dense_loss(layer, resnet, pnets, patches: torch.Tensor) -> torch.Tensor:
    """The JAX dry run's dense loss_fn on this rank's patches (bs, 8, 16)."""
    bs = patches.shape[0]
    up = resnet(patches[..., None])[..., 0]
    upf = up.reshape(bs, -1)
    basis = torch.stack([torch.ones_like(upf), upf, upf**2, upf**3, upf**4], -1)
    bp = torch.cat([p() for p in pnets], dim=0)
    coeffs = upf.new_zeros((bs, layer.grid_size, layer.n_orders))
    coeffs[..., 1] = 1.0
    coeffs[..., 2] = (basis * bp[0]).sum(-1)
    coeffs[..., 4] = (basis * bp[1]).sum(-1)
    rhs = (basis * bp[2]).sum(-1)
    iv_rhs = iv_from_field(up, IVS, DENSE_DIMS)
    u0, _, _ = layer(coeffs, rhs, iv_rhs, steps_for(bs, DENSE_DIMS, patches.device))
    u0 = u0.reshape(bs, -1).to(patches.dtype)
    return ((u0 - patches.reshape(bs, -1)).abs().mean() + (upf - u0).abs().mean()
            + 0.005 * bp.abs().mean())


def mg_layer(bs: int, device, mesh=None, dims: Sequence[int] = MG_DIMS, ivs=IVS, **cfg):
    """The multigrid step's layer: n_grid 2 at the dry run's solver settings
    (MG_CFG), which `cfg` entries override."""
    from mech_nn_discovery_pde_torch.config import PDEConfig
    from mech_nn_discovery_pde_torch.layers.multigrid import MultigridLayer

    return MultigridLayer(bs=bs, coord_dims=dims, order=2, n_ind_dim=1, n_iv=1,
                          init_index_mi_list=ivs, solver_dbl=True, n_grid=2,
                          config=PDEConfig(**{**MG_CFG, **cfg}), device=device, mesh=mesh)


def mg_pnet(device, seed: int = 7, dtype=torch.float32):
    from mech_nn_discovery_pde_torch.models.paramnet import ParamNet

    return ParamNet(n_out=3, depth=2, width=32, in_dim=8, dtype=dtype, device="cpu",
                    generator=torch.Generator().manual_seed(seed)).to(device)


def mg_loss(pnet, layer, patches: torch.Tensor, ivs=IVS) -> torch.Tensor:
    """The JAX dry run's mg_loss_fn on this rank's patches (bs, *dims):
    three ParamNet outputs set the coefficients of orders 1, 2 and 4; the
    boundary values are the patches'."""
    bs, dims = patches.shape[0], tuple(patches.shape[1:])
    cvec = pnet().reshape(-1)[:3]
    coeffs = cvec.new_zeros((bs, layer.grid_size, layer.n_orders))
    coeffs[..., 1] = 1.0 + 0.1 * cvec[0]
    coeffs[..., 2] = cvec[1]
    coeffs[..., 4] = cvec[2]
    rhs = cvec.new_zeros((bs, layer.grid_size))
    u0, _, _ = layer(coeffs, rhs, iv_from_field(patches, ivs, dims),
                     steps_for(bs, dims, patches.device, patches.dtype))
    return (u0.reshape(bs, -1) - patches.reshape(bs, -1)).abs().mean()


def train_step(loss_fn: Callable[[], torch.Tensor], params: Sequence[torch.nn.Parameter],
               opt: torch.optim.Optimizer, mesh, axis: str = "dp") -> float:
    """One optimizer step on the rank's loss (a mean over its slice of the
    batch), the gradients averaged over `axis` first; returns the loss
    averaged over `axis` (the global batch's loss)."""
    from mech_nn_discovery_pde_torch.parallel.mesh import all_reduce_sum_, allreduce_mean_

    opt.zero_grad()
    loss = loss_fn()
    loss.backward()
    allreduce_mean_([p.grad for p in params], mesh, axis)
    opt.step()
    total = loss.detach().reshape(1).clone()
    all_reduce_sum_(total, mesh.get_group(axis))
    return float(total) / dist.get_world_size(mesh.get_group(axis))


def _dryrun_rank(rank: int, n_procs: int, device: torch.device) -> Dict[str, float]:
    from mech_nn_discovery_pde_torch.ops.normal_stencil import (
        build_normal_coef, make_desc, stencil_apply)
    from mech_nn_discovery_pde_torch.parallel.mesh import all_gather_cat, make_mesh, shard_batch
    from mech_nn_discovery_pde_torch.parallel.sharded_normal import (
        coef_to_grid, from_channel_major_grid, make_sharded_normal_ops, shard_layout,
        to_channel_major_grid)

    sp = 2 if n_procs % 2 == 0 else 1
    dp = n_procs // sp
    mesh = make_mesh((dp, sp), ("dp", "sp"), device_type=device.type)
    rng = np.random.default_rng(0)
    f64 = dict(dtype=torch.float64, device=device)

    # 1. dense training step, batch over dp
    bs = 2 * dp
    patches = shard_batch(mesh, torch.tensor(rng.standard_normal((bs,) + DENSE_DIMS), **f64))
    layer, resnet, pnets = dense_parts(patches.shape[0], device)
    params = list(resnet.parameters()) + list(pnets.parameters())
    opt = torch.optim.Adam(params, lr=1e-5)
    loss = train_step(lambda: dense_loss(layer, resnet, pnets, patches), params, opt, mesh)
    if not np.isfinite(loss):
        raise FloatingPointError("dryrun_multichip: non-finite dense loss")
    if rank == 0:
        print(f"dryrun_multichip dense ok on {n_procs} devices; loss={loss:.4f}", flush=True)

    # 2. multigrid training step, batch over dp
    mg_patches_all = torch.tensor(rng.standard_normal((dp,) + MG_DIMS), **f64)
    mg_patches = shard_batch(mesh, mg_patches_all)
    mgl = mg_layer(mg_patches.shape[0], device)
    pnet = mg_pnet(device)
    mg_opt = torch.optim.Adam(pnet.parameters(), lr=1e-4)
    mg_l = train_step(lambda: mg_loss(pnet, mgl, mg_patches), list(pnet.parameters()),
                      mg_opt, mesh)
    if not np.isfinite(mg_l):
        raise FloatingPointError("dryrun_multichip: non-finite multigrid loss")

    # 3. sp-sharded normal matvec against the unsharded apply
    sys0 = mgl.system
    desc = make_desc(sys0.spec)
    vals = sys0.fill_values(torch.ones((1, mgl.grid_size, mgl.n_orders), **f64),
                            steps_for(1, MG_DIMS, device), dtype=torch.float64)
    coef = build_normal_coef(sys0.spec, desc, sys0.split_values(vals))[0]
    xs = torch.tensor(rng.standard_normal(sys0.num_vars), **f64)
    want = stencil_apply(desc, coef[None], xs[None])[0]
    lay = shard_layout(desc, mesh.get_group("sp"))
    extend_coef, apply_ = make_sharded_normal_ops(mesh, desc)
    c3 = coef_to_grid(desc, coef)[:, lay.planes].contiguous()
    x3 = to_channel_major_grid(desc, xs)[:, lay.planes].contiguous()
    y3 = all_gather_cat(apply_(extend_coef(c3), x3), mesh.get_group("sp"), dim=1)
    got = from_channel_major_grid(desc, y3)
    err = float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))
    if not err < 1e-10:
        raise AssertionError(f"dryrun_multichip: sp-sharded normal matvec mismatch {err}")

    # 4. sp-sharded multigrid layer, forward and backward
    sh_bs = 2
    sh_patches = torch.tensor(rng.standard_normal((sh_bs,) + SHARDED_DIMS), **f64)
    shl = mg_layer(sh_bs, device, mesh=mesh, dims=SHARDED_DIMS, mg_block_smoother="point",
                   mg_fgmres_max_iter_forward=10, mg_fgmres_restarts_forward=2,
                   mg_fgmres_max_iter_backward=8, mg_fgmres_restarts_backward=1)
    sh_coeffs = torch.zeros((sh_bs, shl.grid_size, shl.n_orders), **f64)
    sh_coeffs[..., 1] = 1.0
    sh_coeffs[..., 2] = 0.5
    sh_coeffs.requires_grad_(True)
    u0, _, _ = shl(sh_coeffs, torch.zeros((sh_bs, shl.grid_size), **f64),
                   iv_from_field(sh_patches, IVS, SHARDED_DIMS),
                   steps_for(sh_bs, SHARDED_DIMS, device))
    sh_val = (u0.reshape(sh_bs, -1) - sh_patches.reshape(sh_bs, -1)).abs().mean()
    sh_val.backward()
    if not (bool(torch.isfinite(sh_val)) and bool(torch.isfinite(sh_coeffs.grad).all())):
        raise FloatingPointError("dryrun_multichip: sp-sharded multigrid solve non-finite")
    res = {"dense_loss": loss, "mg_loss": mg_l, "matvec_err": err,
           "sharded_loss": float(sh_val.detach()), "dp": dp, "sp": sp}
    if rank == 0:
        print(f"dryrun_multichip ok on {n_procs} devices; dense loss={loss:.4f} "
              f"mg loss={mg_l:.4f} sp-sharded matvec err={err:.1e} "
              f"sp-sharded MG fwd+bwd loss={res['sharded_loss']:.4f}", flush=True)
    return res


def dryrun_multichip(n_procs: int, device: str = "cuda",
                     backend: Optional[str] = None) -> Dict[str, float]:
    """Run the dry run on n_procs ranks; returns rank 0's results (the
    losses, the matvec error, dp and sp).  `backend` None: NCCL when
    `device` is "cuda" and there is a card for every rank, else gloo."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: device 'cuda' without a CUDA device "
                           "(pass device='cpu' to run on the CPU)")
    if backend is None:
        cards = torch.cuda.device_count() if torch.device(device).type == "cuda" else 0
        backend = "nccl" if cards >= n_procs else "gloo"
    return spawn_ranks(_dryrun_rank, n_procs, backend=backend, device=device)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-process dry run of the port")
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    args = ap.parse_args(argv)
    dryrun_multichip(args.procs, args.device, args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
