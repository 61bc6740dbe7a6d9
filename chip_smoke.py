"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

Runs the port's main path, the Ginzburg-Landau multigrid training step, and
holds each hand-written CUDA kernel against its plain PyTorch version:

  1. device: requires CUDA; prints the card's name and power limit;
     builds the kernels (one nvcc per source, in parallel);
  2. kernels vs plain at the GL fine-level and level-1 shapes (bs 32):
     K1 f32/f64 and its epilogue, K2 and its epilogue, 4-step smoothing
     passes (x0 zero / nonzero) with the emitted residual; on the operators
     of the bf16 storage modes (mg_precond_dtype) K3 (factored W) and its
     epilogue, the factored 4-step passes, K1 with bf16 stencil fields and
     K2 with a bf16 inverse; median time per launch over 20 launches (CUDA
     events, each launch bracketed alone; for the five kernels also per
     launch over 10 runs of 10 back-to-back launches, `ms_back_to_back` in
     the kernels line), beside the plain version and a PyTorch yardstick
     computing the same function (K1: a CSR sparse product; K2: one bmm;
     K3: two bmm on an f32 copy of W, as no single call computes W (W^T r));
     the stored W's strict lower triangle must be exactly zero at both
     levels (K3 reads only the upper one); then K2 (f32 and bf16 blocks)
     and K3 with their epilogues at the odd shape bw 42 (the kernels' other
     load path);
  3. layer step at the production config "b30c4rm" (bs 32, (8, 32, 32),
     n_grid 3): forward + IFT backward of sum(u0^2); step time over 5 runs
     on perturbed inputs; FGMRES iterations and rel_rnorm (must be
     <= 3.1e-3); every gradient finite; a torch.profiler capture must show
     K1 and K2;
  4. layer step "b30c4rmw": the same with mg_precond_dtype='bf16_factored';
     the same bar, and the profile must show K1 and K3 and no K2 (no level
     fell back to the f32 inverse);
  5. one forward of b30c4rm with mg_precond_dtype='bf16': finite u0, both
     bf16-operand variants (K1, K2) launched; rel_rnorm is printed with no
     bar (the mode is quality-fatal at GL scale);
  6. trainer: 3 Adam steps of GLDiscovery.loss_fn at the GLConfig defaults
     on GL data generated into data/;
  7. one JSON line {"kernels": [...]} with each kernel's numbers and the
     launch counts of the run that drives it ("launches_in"), then
     {"ok": true, "device": {...}} as the last line.

Any failure exits nonzero.  Imports nothing of JAX.

Run from the repository root:  python3 chip_smoke.py [--seed 0]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, f32 rate outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def abs_err(a, b) -> float:
    return float((a - b).abs().max())


def check(name: str, err: float, tol: float) -> None:
    log(f"  {name}: rel max-abs err {err:.3e} (tol {tol:.0e})")
    if not err <= tol:
        raise AssertionError(f"{name}: error {err:.3e} above {tol:.0e}")


def bound(n_bytes: float, n_flops: float):
    """(least milliseconds the card could take, what bounds it): the larger
    of the bytes over the memory rate and the f32 operations over the peak."""
    t_bytes, t_flops = n_bytes / HBM_BYTES_PER_S, n_flops / PEAK_F32_FLOPS
    return max(t_bytes, t_flops) * 1e3, "bytes" if t_bytes >= t_flops else "operations"


def time_ms(fn, n: int = 20, warmup: int = 3, batch: int = 1) -> float:
    """Median milliseconds per call over n calls, each bracketed by CUDA
    events, after warm-up.  With batch > 1 each of the n samples is a run of
    `batch` back-to-back calls, divided by batch: the device's time per call
    where the device, not the host's launch, is the slower."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(batch):
            fn()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1) / batch)
    return statistics.median(ts)


def time_ms_back_to_back(fn) -> float:
    """Median per call over 10 runs of 10 back-to-back calls."""
    return time_ms(fn, n=10, batch=10)


def bench_inputs(layer, bs, dims, seed, device):
    """The benchmark step's synthetic GL-shaped inputs (coefficients of
    u_t - u - u_xx - u_yy, small random rhs and boundary data)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    coeffs = torch.zeros((bs, layer.grid_size, layer.n_orders), dtype=torch.float64)
    coeffs[..., 0] = -1.0
    coeffs[..., 1] = 1.0
    coeffs[..., 5] = -1.0
    coeffs[..., 6] = -1.0
    rhs = 0.01 * torch.randn((bs, layer.grid_size), generator=g, dtype=torch.float64)
    iv = 0.1 * torch.randn((bs, layer.system.n_init_rows), generator=g, dtype=torch.float64)
    steps = [torch.full((bs, d - 1), 0.1, dtype=torch.float64) for d in dims]
    return [t.to(device) for t in (coeffs, rhs, iv)], [s.to(device) for s in steps]


def stencil_csr(desc, coef):
    """The assembled AtA of every sample as one block-diagonal sparse CSR
    matrix over the flat point-major vector: the library yardstick for K1
    (a cuSPARSE product), built here and used nowhere in the port."""
    from mech_nn_discovery_pde_torch.ops.normal_stencil import _band_channels

    bs, _, N = coef.shape
    m = desc.n_mi
    p = torch.arange(N, device=coef.device)
    rows, cols, vals = [], [], []
    for i in range(m):
        for j in range(m):
            rows.append(p * m + i)
            cols.append(p * m + j)
            vals.append(coef[:, i * m + j])
    for band in desc.bands:
        ci, cj = _band_channels(band)
        q = p[: N - band.stride]
        g = coef[:, band.ch, : N - band.stride]
        rows += [q * m + ci, (q + band.stride) * m + cj]
        cols += [(q + band.stride) * m + cj, q * m + ci]
        vals += [g, g]
    off = (torch.arange(bs, device=coef.device) * N * m)[:, None]
    idx = torch.stack([(torch.cat(rows)[None] + off).reshape(-1),
                       (torch.cat(cols)[None] + off).reshape(-1)])
    A = torch.sparse_coo_tensor(idx, torch.cat(vals, dim=1).reshape(-1), (bs * N * m,) * 2,
                                check_invariants=False)
    return A.coalesce().to_sparse_csr()


def phase_kernels(layer, hier, values, dev, seed):
    """Phase 2: every kernel against its plain version at the GL shapes."""
    from mech_nn_discovery_pde_torch.ops import fused_smoother as fs
    from mech_nn_discovery_pde_torch.ops import normal_stencil as ns
    from mech_nn_discovery_pde_torch.solvers.multigrid import MultigridSolver

    mg = layer.mg_solver
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    # solvers of the bf16 storage modes on the same hierarchy, for their
    # stored operators (W = L^-T in bf16; bf16 stencil fields and inverse)
    stored = {}
    for mode in ("bf16_factored", "bf16"):
        cfg = dataclasses.replace(mg.config, mg_precond_dtype=mode)
        stored[mode] = MultigridSolver(
            bs=mg.bs, order=mg.order, n_ind_dim=mg.n_ind_dim, n_iv=mg.n_iv,
            init_index_mi_list=mg.init_index_mi_list, coord_dims=mg.dim_list[0],
            downsample_first=mg.downsample_first, n_grid=mg.n_grid, config=cfg, device=dev)
    report = {}
    for k in range(mg.n_grid - 1):
        lvl = hier["levels"][k]
        desc, nt = mg.descs[k], mg.dim_list[k][0]
        coef, binv = lvl["coef"], lvl["binv"]
        bs, NC, N = coef.shape
        m = desc.n_mi
        S = N // nt
        bw = nt * m
        log(f"level {k}: dims {mg.dim_list[k]}  NC {NC}  N {N}  m {m}  lines {S} x {bw}^2")
        x = torch.randn((bs, N * m), generator=g, device=dev)
        b = torch.randn((bs, N * m), generator=g, device=dev)

        # ---- K1, f32 and f64, plain apply and the Chebyshev-step epilogue
        y_k = ns.stencil_apply(desc, coef, x)
        y_p = ns.stencil_apply_plain(desc, coef, x)
        e1 = rel_err(y_k, y_p)
        check(f"K1 f32 apply (level {k})", e1, 1e-5)
        xo_k, xo_p = torch.empty_like(x), torch.empty_like(x)
        r_k = ns.stencil_apply(desc, coef, x, rin=b, xin=b, xout=xo_k)
        r_p = ns.stencil_apply_plain(desc, coef, x, rin=b, xin=b, xout=xo_p)
        check(f"K1 f32 residual epilogue (level {k})", rel_err(r_k, r_p), 1e-5)
        check(f"K1 f32 iterate epilogue (level {k})", rel_err(xo_k, xo_p), 1e-6)
        sys_k = mg.systems[k]
        v64 = values.double() if k == 0 else lvl["values"].double()
        coef64 = ns.build_normal_coef(sys_k.spec, desc, sys_k.split_values(v64))
        x64 = x.double()
        e64 = rel_err(ns.stencil_apply(desc, coef64, x64), ns.stencil_apply_plain(desc, coef64, x64))
        check(f"K1 f64 apply (level {k})", e64, 1e-12)

        # ---- K2 plain block apply and the Chebyshev-update epilogue
        t_k = fs.block_apply(binv, x, nt)
        t_p = fs.block_apply_plain(binv, x, nt)
        e2 = rel_err(t_k, t_p)
        check(f"K2 apply (level {k})", e2, 1e-5)
        c1 = torch.rand((bs,), generator=g, device=dev)
        c2 = torch.rand((bs,), generator=g, device=dev)
        d_k, d_p = b.clone(), b.clone()
        fs.block_apply(binv, x, nt, d=d_k, c1=c1, c2=c2)
        fs.block_apply_plain(binv, x, nt, d=d_p, c1=c1, c2=c2)
        check(f"K2 Chebyshev epilogue (level {k})", rel_err(d_k, d_p), 1e-5)

        # ---- smoothing pass (4 steps), both starts, emitted residual
        ratio = mg.config.mg_chebyshev_ratio
        sched = fs.chebyshev_schedule(lvl["lmax"], ratio, 4)
        x0 = 0.1 * torch.randn((bs, N * m), generator=g, device=dev)
        for x0_zero in (True, False):
            xs_k, rs_k = fs.chebyshev_smooth(desc, nt, coef, binv, b, x0, sched, 4, x0_zero)
            xs_p, rs_p = fs.chebyshev_smooth_plain(desc, nt, coef, binv, b, x0, lvl["lmax"],
                                                   ratio, 4, x0_zero)
            check(f"smoothing pass x0_zero={x0_zero} (level {k})", rel_err(xs_k, xs_p), 1e-4)
            check(f"emitted residual x0_zero={x0_zero} (level {k})", rel_err(rs_k, rs_p), 1e-4)
        r_true = ns.stencil_apply_plain(desc, coef, xs_k, rin=b)
        check(f"emitted residual vs b - A x (level {k})", rel_err(rs_k, r_true), 1e-4)
        torch.cuda.synchronize()

        # ---- bf16 storage modes: K3 on W, K1 on bf16 fields, K2 on a bf16 B^-1
        vk = values if k == 0 else lvl["values"]
        lw = stored["bf16_factored"]._level_precond_data(k, vk)
        lb = stored["bf16"]._level_precond_data(k, vk)
        W, coef16, binv16 = lw["binv"], lb["coef"], lb["binv"]
        if not W.dtype == coef16.dtype == binv16.dtype == torch.bfloat16:
            raise AssertionError(f"stored operators not bf16: {W.dtype}, {coef16.dtype}, "
                                 f"{binv16.dtype}")
        # K3 reads only W's upper triangle: the stored lower one must be 0
        n_low = int((W.tril(-1) != 0).sum())
        log(f"  stored W strict lower triangle (level {k}): {n_low} nonzero entries")
        if n_low:
            raise AssertionError(f"stored W at level {k} has {n_low} nonzero entries below "
                                 f"its diagonal")
        t3_k = fs.factored_block_apply(W, x, nt)
        t3_p = fs.factored_block_apply_plain(W, x, nt)
        check(f"K3 factored apply (level {k})", rel_err(t3_k, t3_p), 1e-5)
        d_k, d_p = b.clone(), b.clone()
        fs.factored_block_apply(W, x, nt, d=d_k, c1=c1, c2=c2)
        fs.factored_block_apply_plain(W, x, nt, d=d_p, c1=c1, c2=c2)
        check(f"K3 Chebyshev epilogue (level {k})", rel_err(d_k, d_p), 1e-5)
        sched_w = fs.chebyshev_schedule(lw["lmax"], ratio, 4)
        for x0_zero in (True, False):
            xs_k, rs_k = fs.chebyshev_smooth(desc, nt, lw["coef"], W, b, x0, sched_w, 4,
                                             x0_zero, factored=True)
            xs_p, rs_p = fs.chebyshev_smooth_plain(desc, nt, lw["coef"], W, b, x0, lw["lmax"],
                                                   ratio, 4, x0_zero, factored=True)
            check(f"factored pass x0_zero={x0_zero} (level {k})", rel_err(xs_k, xs_p), 1e-4)
            check(f"factored emitted residual x0_zero={x0_zero} (level {k})",
                  rel_err(rs_k, rs_p), 1e-4)
        r_true = ns.stencil_apply_plain(desc, lw["coef"], xs_k, rin=b)
        check(f"factored emitted residual vs b - A x (level {k})", rel_err(rs_k, r_true), 1e-4)
        y16_k = ns.stencil_apply(desc, coef16, x)
        y16_p = ns.stencil_apply_plain(desc, coef16, x)
        check(f"K1 bf16-field apply (level {k})", rel_err(y16_k, y16_p), 1e-5)
        t16_k = fs.block_apply(binv16, x, nt)
        t16_p = fs.block_apply_plain(binv16, x, nt)
        check(f"K2 bf16-inverse apply (level {k})", rel_err(t16_k, t16_p), 1e-5)
        torch.cuda.synchronize()

        # ---- times per launch (level 0 enters the report)
        t_k1 = time_ms(lambda: ns.stencil_apply(desc, coef, x, out=y_k))
        t_k1p = time_ms(lambda: ns.stencil_apply_plain(desc, coef, x))
        t_k1_64 = time_ms(lambda: ns.stencil_apply(desc, coef64, x64))
        t_k2 = time_ms(lambda: fs.block_apply(binv, x, nt, d=t_k))
        t_k2p = time_ms(lambda: fs.block_apply_plain(binv, x, nt))
        A_csr = stencil_csr(desc, coef)
        xcol = x.reshape(-1, 1)
        check(f"CSR yardstick vs K1 (level {k})",
              rel_err(torch.sparse.mm(A_csr, xcol).reshape(bs, -1), y_k), 1e-5)
        t_k1lib = time_ms(lambda: torch.sparse.mm(A_csr, xcol))
        del A_csr
        rb = fs.line_vec_to_blocks(x, nt, m).reshape(bs * S, bw, 1).contiguous()
        B2 = binv.reshape(bs * S, bw, bw)
        t_k2lib = time_ms(lambda: torch.bmm(B2, rb))
        nb = len(desc.bands)
        k1_bound, k1_by = bound(4 * (NC + 2 * m) * N * bs, 2 * (m * m + 2 * nb) * N * bs)
        k2_bound, k2_by = bound(4 * (bs * S * bw * bw + 2 * bs * N * m), 2 * bs * S * bw * bw)
        log(f"  K1 f32 {t_k1:.4f} ms (plain {t_k1p:.4f}, CSR sparse.mm {t_k1lib:.4f}, "
            f"bound {k1_bound:.4f}); K1 f64 {t_k1_64:.4f} ms; K2 {t_k2:.4f} ms "
            f"(plain {t_k2p:.4f}, bmm {t_k2lib:.4f}, bound {k2_bound:.4f})")

        # bf16 operands: stored values are 2 bytes, vectors 4; the yardsticks
        # take f32 copies of the stored values (same function)
        t_k3 = time_ms(lambda: fs.factored_block_apply(W, x, nt, d=t3_k))
        t_k3p = time_ms(lambda: fs.factored_block_apply_plain(W, x, nt))
        W2 = W.float().reshape(bs * S, bw, bw)
        check(f"two-bmm yardstick vs K3 (level {k})", rel_err(
            fs.line_blocks_to_vec(torch.bmm(W2, torch.bmm(W2.transpose(1, 2), rb)).reshape(
                bs, S, bw), nt, m), t3_k), 1e-5)
        t_k3lib = time_ms(lambda: torch.bmm(W2, torch.bmm(W2.transpose(1, 2), rb)))
        del W2
        t_k1b = time_ms(lambda: ns.stencil_apply(desc, coef16, x, out=y16_k))
        t_k1bp = time_ms(lambda: ns.stencil_apply_plain(desc, coef16, x))
        A_csr = stencil_csr(desc, coef16.float())
        t_k1blib = time_ms(lambda: torch.sparse.mm(A_csr, xcol))
        del A_csr
        t_k2b = time_ms(lambda: fs.block_apply(binv16, x, nt, d=t16_k))
        t_k2bp = time_ms(lambda: fs.block_apply_plain(binv16, x, nt))
        B16 = binv16.float().reshape(bs * S, bw, bw)
        t_k2blib = time_ms(lambda: torch.bmm(B16, rb))
        del B16
        vec_bytes = 4 * 2 * bs * N * m
        k3_bound, k3_by = bound(2 * bs * S * bw * bw + vec_bytes, 4 * bs * S * bw * bw)
        k1b_bound, k1b_by = bound(2 * NC * N * bs + vec_bytes, 2 * (m * m + 2 * nb) * N * bs)
        k2b_bound, k2b_by = bound(2 * bs * S * bw * bw + vec_bytes, 2 * bs * S * bw * bw)
        log(f"  K3 {t_k3:.4f} ms (plain {t_k3p:.4f}, two bmm {t_k3lib:.4f}, bound "
            f"{k3_bound:.4f}); K1 bf16 {t_k1b:.4f} ms (plain {t_k1bp:.4f}, CSR {t_k1blib:.4f}, "
            f"bound {k1b_bound:.4f}); K2 bf16 {t_k2b:.4f} ms (plain {t_k2bp:.4f}, bmm "
            f"{t_k2blib:.4f}, bound {k2b_bound:.4f})")
        # the same launches back to back, without the host's time per launch
        b2b = {
            "k1": time_ms_back_to_back(lambda: ns.stencil_apply(desc, coef, x, out=y_k)),
            "k2": time_ms_back_to_back(lambda: fs.block_apply(binv, x, nt, d=t_k)),
            "k3": time_ms_back_to_back(lambda: fs.factored_block_apply(W, x, nt, d=t3_k)),
            "k1_bf16": time_ms_back_to_back(
                lambda: ns.stencil_apply(desc, coef16, x, out=y16_k)),
            "k2_bf16": time_ms_back_to_back(lambda: fs.block_apply(binv16, x, nt, d=t16_k)),
        }
        log("  back to back, per launch: " + ", ".join(f"{n} {t:.4f} ms"
                                                         for n, t in b2b.items()))
        rows = {
            "k1": (abs_err(y_k, y_p), t_k1, t_k1p, k1_bound, k1_by, t_k1lib),
            "k2": (abs_err(t_k, t_p), t_k2, t_k2p, k2_bound, k2_by, t_k2lib),
            "k3": (abs_err(t3_k, t3_p), t_k3, t_k3p, k3_bound, k3_by, t_k3lib),
            "k1_bf16": (abs_err(y16_k, y16_p), t_k1b, t_k1bp, k1b_bound, k1b_by, t_k1blib),
            "k2_bf16": (abs_err(t16_k, t16_p), t_k2b, t_k2bp, k2b_bound, k2b_by, t_k2blib),
        }
        if k == 0:  # level 0 enters the report
            for key, (err, ms, plain, bnd, by, lib) in rows.items():
                report[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                                   bound_by=by, library_ms=lib, ms_back_to_back=b2b[key])
        del lw, lb, W, coef16, binv16
    return report


def phase_odd_shape(dev, seed, bs=2, nt=6, m=7, S=144):
    """Phase 2b: K2 (f32 and bf16 blocks) and K3 with their epilogues against
    the plain versions on random blocks at bw 42 (the CPU tests' (6, 12, 12)
    systems): the f32 blocks (7,056 B) take the bulk copy, the bf16 ones
    (3,528 B, not a multiple of 16) the kernels' own load path."""
    from mech_nn_discovery_pde_torch.ops import _cuda
    from mech_nn_discovery_pde_torch.ops import fused_smoother as fs

    g = torch.Generator(device=dev).manual_seed(seed + 2)
    bw = nt * m
    n = nt * S * m
    x = torch.randn((bs, n), generator=g, device=dev)
    b = torch.randn((bs, n), generator=g, device=dev)
    c1 = torch.rand((bs,), generator=g, device=dev)
    c2 = torch.rand((bs,), generator=g, device=dev)
    B = torch.randn((bs, S, bw, bw), generator=g, device=dev)
    W = torch.randn((bs, S, bw, bw), generator=g, device=dev).triu().to(torch.bfloat16)
    log(f"odd shape: bs {bs}, nt {nt}, m {m}, S {S} -> {S} lines x {bw}^2")
    cases = (("K2 f32", fs.block_apply, fs.block_apply_plain, B, False),
             ("K2 bf16", fs.block_apply, fs.block_apply_plain, B.to(torch.bfloat16), False),
             ("K3", fs.factored_block_apply, fs.factored_block_apply_plain, W, True))
    for name, kern, plain, blocks, factored in cases:
        geo = fs.line_block_geometry(bs, S, bw, blocks.element_size(), _cuda.sm_count(dev),
                                     factored)
        log(f"  {name}: {geo.ctas} CTAs, {geo.stages} stages, {geo.smem_bytes} B shared, "
            f"{'bulk copy' if geo.bulk else 'in-kernel load path'}")
        check(f"{name} apply (bw {bw})", rel_err(kern(blocks, x, nt), plain(blocks, x, nt)), 1e-5)
        d_k, d_p = b.clone(), b.clone()
        kern(blocks, x, nt, d=d_k, c1=c1, c2=c2)
        plain(blocks, x, nt, d=d_p, c1=c1, c2=c2)
        check(f"{name} Chebyshev epilogue (bw {bw})", rel_err(d_k, d_p), 1e-5)
    torch.cuda.synchronize()


# CUPTI overhead records (host blocked on a full launch queue, trace buffer
# flushes): reported beside the device's activities but no work of the card
PROFILER_OVERHEAD = ("Command Buffer Full", "Buffer Flush")


def device_events(prof):
    """Trace events of work on the card (kernels, copies, memsets)."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not any(o in e.name for o in PROFILER_OVERHEAD)]


def kernel_counts(prof):
    """Launch counts of the port's kernels in a trace, the device's busy time
    (microseconds: the union of the work's intervals, so overlapping
    streams count once) and device time by name."""
    names = {"k1_stencil_apply": 0, "k2_line_block_apply": 0,
             "k3_factored_line_block_apply": 0}
    by_name = {}
    spans = []
    for e in device_events(prof):
        spans.append((e.time_range.start, e.time_range.end))
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.end - e.time_range.start, c + 1)
        for n in names:
            if n in e.name:
                names[n] += 1
    busy_us, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        if t > end:
            busy_us += t - max(s, end)
            end = t
    return names, busy_us, by_name


# the layer step's kernel of the time-line block apply, by storage mode; the
# other block kernel must not launch
BLOCK_KERNEL = {"f32": "k2_line_block_apply", "bf16_factored": "k3_factored_line_block_apply"}


def b30c4rm_layer(dev, precond="f32", bs=32, dims=(8, 32, 32), n_grid=3):
    """The production GL layer "b30c4rm" (bench.py:119-129) with the given
    stored-preconditioner dtype."""
    from mech_nn_discovery_pde_torch.config import PDEConfig
    from mech_nn_discovery_pde_torch.discovery.ginzburg_landau import GLDiscovery
    from mech_nn_discovery_pde_torch.layers.multigrid import MultigridLayer

    cfg = PDEConfig(
        precision="f32_ir", mg_solve_dtype="f32",
        mg_smoother_steps_pre=4, mg_smoother_steps_post=4,
        mg_fgmres_max_iter_forward=30, mg_fgmres_max_iter_backward=30,
        mg_smoother_residual=True, mg_fused_matvec=True, return_solve_stats=True,
        mg_precond_dtype=precond,
    )
    return MultigridLayer(bs=bs, coord_dims=dims, order=2, n_ind_dim=1, n_iv=1,
                          init_index_mi_list=GLDiscovery.IV_LIST, solver_dbl=True,
                          n_grid=n_grid, downsample_first=False, config=cfg, device=dev)


def phase_layer(seed, dev, precond="f32", bs=32, dims=(8, 32, 32)):
    """Phases 3 and 4: the b30c4rm layer step (b30c4rmw with
    precond='bf16_factored'), forward + IFT backward.  Returns the launch
    counts of one step."""
    from mech_nn_discovery_pde_torch.ops import _cuda

    t0 = time.perf_counter()
    layer = b30c4rm_layer(dev, precond, bs, dims)
    (c0, r0, i0), steps = bench_inputs(layer, bs, dims, seed, dev)
    log(f"layer ({precond} preconditioner storage) built in {time.perf_counter() - t0:.2f} s: "
        f"{layer.system.describe()}")

    def step(c):
        c = c.clone().requires_grad_(True)
        r = r0.clone().requires_grad_(True)
        i = i0.clone().requires_grad_(True)
        u0, _, stats = layer(c, r, i, steps)
        (u0**2).sum().backward()
        return stats, (c.grad, r.grad, i.grad)

    t0 = time.perf_counter()
    stats, grads = step(c0)
    torch.cuda.synchronize()
    log(f"warm-up step {time.perf_counter() - t0:.3f} s")
    _cuda.LAUNCHES.clear()
    stats, grads = step(c0)
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    its = stats["iters"].tolist()
    rel = stats["rel_rnorm"]
    log(f"layer step launches {counts}; forward FGMRES iters {sorted(set(its))}, "
        f"rel_rnorm max {float(rel.max()):.4e} mean {float(rel.mean()):.4e}")
    block = BLOCK_KERNEL[precond]
    stray = [n for n in counts if n.startswith(("k2_", "k3_")) and n != block]
    if counts.get(block, 0) == 0 or stray:
        raise AssertionError(f"{precond} layer step: block applies {counts}, want only {block}")
    for name, gr in zip(("coeffs", "rhs", "iv"), grads):
        if not bool(torch.isfinite(gr).all()):
            raise AssertionError(f"non-finite gradient w.r.t. {name}")
    if not float(rel.max()) <= 3.1e-3:
        raise AssertionError(f"forward rel_rnorm {float(rel.max()):.3e} above the 3.1e-3 bar")

    ts = []
    for k in range(5):
        t0 = time.perf_counter()
        step(c0 + 1e-6 * (k + 1))
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    dt = ts[len(ts) // 2]
    log(f"layer step median {dt:.4f} s over 5 runs (min {ts[0]:.4f}, max {ts[-1]:.4f}, "
        f"spread {(ts[-1] - ts[0]) / dt:.3f}); {bs / dt:.3f} KKT solves/s")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(c0)
        torch.cuda.synchronize()
    names, busy_us, by_name = kernel_counts(prof)
    log(f"profiler: kernel launches {names}; device busy {busy_us / 1e6:.4f} s per step, "
        f"idle share {max(0.0, 1 - busy_us / 1e6 / dt):.3f} of the unprofiled median step")
    for name, (us, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"  {us / 1e3:10.3f} ms  x{c:6d}  {name[:90]}")
    for n, c in names.items():
        want = n in ("k1_stencil_apply", block)
        if want and c == 0:
            raise AssertionError(f"profiler shows no launch of {n} in the layer step")
        if not want and c != 0:
            raise AssertionError(f"profiler shows {c} launches of {n} in the {precond} layer step")
    return counts


def phase_bf16_forward(seed, dev, bs=32, dims=(8, 32, 32)):
    """Phase 5: one forward of b30c4rm with all-bf16 preconditioner storage.
    Returns the launch counts of that forward."""
    from mech_nn_discovery_pde_torch.ops import _cuda

    layer = b30c4rm_layer(dev, "bf16", bs, dims)
    (c0, r0, i0), steps = bench_inputs(layer, bs, dims, seed, dev)
    torch.cuda.synchronize()
    _cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    with torch.no_grad():
        u0, _, stats = layer(c0, r0, i0, steps)
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    rel = stats["rel_rnorm"]
    log(f"bf16 forward {time.perf_counter() - t0:.3f} s: launches {counts}; FGMRES iters "
        f"{sorted(set(stats['iters'].tolist()))}, rel_rnorm max {float(rel.max()):.4e} "
        f"mean {float(rel.mean()):.4e} (no bar: quality-fatal at GL scale)")
    if not bool(torch.isfinite(u0).all()):
        raise AssertionError("bf16 forward: non-finite u0")
    for n in ("k1_stencil_apply_bf16", "k2_line_block_apply_bf16"):
        if counts.get(n, 0) == 0:
            raise AssertionError(f"bf16 forward did not launch {n}")
    return counts


def phase_trainer(dev, cfg=None):
    """Phase 6: 3 Adam steps of the GL discovery loss at GLConfig defaults.
    Returns the launch counts of the 3 steps."""
    from mech_nn_discovery_pde_torch.data.datasets import PatchLoader, ReactDiffDataset
    from mech_nn_discovery_pde_torch.discovery.common import make_update
    from mech_nn_discovery_pde_torch.discovery.ginzburg_landau import GLConfig, GLDiscovery
    from mech_nn_discovery_pde_torch.ops import _cuda

    cfg = cfg or GLConfig()
    t0 = time.perf_counter()
    ds = ReactDiffDataset(solver_dim=cfg.solver_dim, data_root=cfg.data_root,
                          downsample=cfg.downsample, first_equation=cfg.first_equation)
    log(f"GL data ready in {time.perf_counter() - t0:.1f} s: u {ds.u.shape}, {len(ds)} patches")
    model = GLDiscovery(cfg, ds, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr)
    update = make_update(model.loss_fn, opt)
    batches = iter(PatchLoader(ds, cfg.batch_size, seed=cfg.seed))
    _cuda.LAUNCHES.clear()
    for i in range(3):
        u, v, _, _, _ = next(batches)
        t0 = time.perf_counter()
        loss, aux = update(u, v)
        lv = float(loss)
        torch.cuda.synchronize()
        log(f"train step {i}: loss {lv:.6e}  fwd iters {float(aux['fwd_iters']):.1f}  "
            f"fwd rel_rnorm {float(aux['fwd_rel_rnorm']):.3e}  {time.perf_counter() - t0:.3f} s")
        if not torch.isfinite(loss):
            raise AssertionError(f"non-finite loss at train step {i}")
    counts = dict(_cuda.LAUNCHES)
    log(f"trainer launches (3 steps): {counts}")
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    from mech_nn_discovery_pde_torch.ops import _cuda  # fails outside the repo

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _cuda.build(verbose=True)
    log(f"kernels built in {time.perf_counter() - t0:.1f} s (nvcc {_cuda.nvcc_path()})")

    # phase 2 needs a real hierarchy: build it with the layer of phase 3
    from mech_nn_discovery_pde_torch.config import PDEConfig
    from mech_nn_discovery_pde_torch.discovery.ginzburg_landau import GLDiscovery
    from mech_nn_discovery_pde_torch.layers.multigrid import MultigridLayer

    bs, dims = 32, (8, 32, 32)
    cfg = PDEConfig(mg_solve_dtype="f32", mg_smoother_steps_pre=4, mg_smoother_steps_post=4)
    layer = MultigridLayer(bs=bs, coord_dims=dims, order=2, n_ind_dim=1, n_iv=1,
                           init_index_mi_list=GLDiscovery.IV_LIST, solver_dbl=True,
                           n_grid=3, downsample_first=False, config=cfg, device=dev)
    (c0, r0, i0), steps = bench_inputs(layer, bs, dims, args.seed, dev)
    t0 = time.perf_counter()
    values, _, hier = layer._prepare(c0, r0, i0, steps)
    torch.cuda.synchronize()
    log(f"hierarchy built in {time.perf_counter() - t0:.2f} s; lmax level 0 "
        f"{float(hier['levels'][0]['lmax'].min()):.4f}..{float(hier['levels'][0]['lmax'].max()):.4f}")
    report = phase_kernels(layer, hier, values.detach(), dev, args.seed)
    phase_odd_shape(dev, args.seed)
    del layer, hier, values
    torch.cuda.empty_cache()

    phase_layer(args.seed, dev)
    counts_w = phase_layer(args.seed, dev, precond="bf16_factored")
    torch.cuda.empty_cache()
    counts_b = phase_bf16_forward(args.seed, dev)
    torch.cuda.empty_cache()
    counts = phase_trainer(dev)

    stencil = "mech_nn_discovery_pde_torch/csrc/stencil_apply.cu"
    line = "mech_nn_discovery_pde_torch/csrc/line_block.cu"
    tpu_fs = "mech_nn_discovery_pde_tpu/ops/fused_smoother.py"
    trainer, step_w, fwd_b = "GL trainer, 3 steps", "b30c4rmw layer step", "b30c4rm bf16 forward"
    kernels = [  # (name, source, TPU kernel, launch counts of its path, key)
        ("k1_stencil_apply", stencil, "mech_nn_discovery_pde_tpu/ops/normal_stencil.py:404",
         trainer, counts, "k1"),
        ("k2_line_block_apply", line, f"{tpu_fs}:128", trainer, counts, "k2"),
        ("k3_factored_line_block_apply", line, f"{tpu_fs}:104", step_w, counts_w, "k3"),
        ("k1_stencil_apply_bf16", stencil, f"{tpu_fs}:51", fwd_b, counts_b, "k1_bf16"),
        ("k2_line_block_apply_bf16", line, f"{tpu_fs}:87", fwd_b, counts_b, "k2_bf16"),
    ]
    kernels = [dict(name=n, route="cuda", source=src, replaces=rep, launches=c.get(n, 0),
                    launches_in=path, **report[key])
               for n, src, rep, path, c, key in kernels]
    for kd in kernels:
        if kd["launches"] == 0:
            raise AssertionError(f"{kd['name']} was not launched in the {kd['launches_in']}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
