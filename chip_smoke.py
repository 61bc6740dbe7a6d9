"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

Runs the port's main paths (the Ginzburg-Landau multigrid training step,
also with its ResNet transform and backward probe; the dense path: entry(),
Burgers discovery, the sine fit, Kamani discovery and a resumed Kamani run;
the transport examples) and holds each hand-written CUDA kernel against its
plain PyTorch version:

  1. device: requires CUDA; prints the card's name and power limit;
     builds the kernels (one nvcc per source, in parallel) and reads
     ptxas's report: every K1 instantiation (3 stored types x 6 layouts x
     2 point widths), the seven line_block.cu kernels (K2 f32 and bf16
     streamed and on panels; K3 streamed, on a cluster and two-sweep) and
     the 15 point_block.cu ones (K2 f32 and bf16, K3; bw 2, 3, 4, 5, 7)
     must use no stack frame and spill nothing;
  2. kernels vs plain at the GL fine-level and level-1 shapes (bs 32):
     K1 f32/f64 and its epilogue (f64 and bf16 fields also in place), K2
     and its epilogue, 4-step smoothing
     passes as the solver composes them (MultigridSolver._smooth; x0 zero /
     nonzero) with the emitted residual; on the operators
     of the bf16 storage modes (mg_precond_dtype) K3 (factored W) and its
     epilogue, the factored 4-step passes, K1 with bf16 stencil fields and
     K2 with a bf16 inverse; median time per launch over 20 launches (CUDA
     events, each launch bracketed alone; for the five kernels also per
     launch over 10 runs of 10 back-to-back launches, `ms_back_to_back` in
     the kernels line), beside the plain version and a PyTorch yardstick
     computing the same function (K1: a CSR sparse product; K2: one bmm;
     K3: two bmm on an f32 copy of W, as no single call computes W (W^T r));
     the stored W's strict lower triangle must be exactly zero at both
     levels (K3 reads only the upper one); then (2b) K2 (f32 and bf16
     blocks) and K3 with and without their epilogues (1e-5) at the mid and
     unaligned widths bw 21, 30, 35, 42, 63, 105, 133, 175, 217 and 238 and at
     bw 56 on blocks off 16-byte alignment, each launch's route and geometry
     logged (every block by a bulk copy: of the whole block where all are
     16-byte aligned, else of its aligned interior); then K1 at the five
     (n_coord, order) layouts GL does not
     run, in f32, f64 and bf16 fields with its epilogues, at bs 3 (one
     point a thread) and at bs 2 x SMs (16-byte loads); K1 f64 also beside
     its plain version and a float64 CSR sparse product at both levels;
     then (2d) K2 (f32 and bf16) and K3 at time-line blocks wider than one
     CTA's shared memory holds, on the row-tiled kernels their width gives
     (K2's panel kernel, K3's cluster kernel, to bw 916, or its two-sweep
     one), against their plain versions with and without the epilogue
     (1e-5): bw 280 and 350 timed alone, back to back and on the device
     beside their bounds (K3: W's upper triangle read once) and one bmm
     (two for K3) on an f32 copy of the blocks, also on 4 x as many lines,
     beyond L2; bw 245 and 345 (blocks aligned to 4 or 2 bytes), 406 (a
     cluster of 6) and 980 (K3 past the cluster); then K1 f64 (1e-12), K1 f32
     and K2 (1e-5) with their epilogues, and a smoothing pass, at the
     transport multigrid example's shapes (its hierarchy: bs 5, (8, 512),
     m 5, bw 40; levels 0 and 1), each timed beside its plain version, a
     library call and its bound;
  3. layer step at the production config "b30c4rm" (bs 32, (8, 32, 32),
     n_grid 3), first its hierarchy build and level-1 coarse rescale timed
     with the rescale's products on ELL (as the solver runs them) and on
     COO (median of 5 each); then forward + IFT backward of sum(u0^2); step time over 5 runs
     on perturbed inputs; FGMRES iterations and rel_rnorm (must be
     <= 3.1e-3); every gradient finite; a torch.profiler capture must show
     K1 and K2, and gives each port kernel's device time per step;
  4. layer step "b30c4rmw": the same with mg_precond_dtype='bf16_factored';
     the same bar, and the profile must show K1 and K3 and no K2 (no level
     fell back to the f32 inverse);
  5. one forward of b30c4rm with mg_precond_dtype='bf16': finite u0, both
     bf16-operand variants (K1, K2) launched; rel_rnorm is printed with no
     bar (the mode is quality-fatal at GL scale);
 5b. the long-window layer step: (50, 32, 32) patches, bs 8, n_grid 3 with
     downsample_first=True (fine-level time lines of bw 350, level 1 bw
     175: the kernels ops/fused_smoother.line_block_geometry routes them
     to; the coarsest a dense solve), the b30c4rm settings, in f32 storage
     (K2 on panels at both levels) and 'bf16_factored' (K3 on a cluster at
     both levels) with phase 3's timing core (launches by kernel and by
     level, each level's kernels those of LONG_BLOCK_KERNEL; the block
     applies' device ms by level, from CUDA events, level 1's beside the
     streamed kernels' 866.0 and 789.0 ms before the mid-width redesign;
     step median, min, max; profile; finite gradients; rel_rnorm at most
     5.0e-3), its peak memory, and the kernel of each level at the step's
     own blocks against its plain version (1e-5), timed alone, back to back
     and in a CUDA graph beside its bound, plain version and bmm (two for
     K3); then one 'bf16' forward (K2 bf16 on panels at level 0, streamed
     at level 1) and its kernels at both levels likewise;
  6. trainer: 3 Adam steps of GLDiscovery.loss_fn at the GLConfig defaults
     on GL data generated into data/;
  7. dense path: entry()'s f32_ir forward (Burgers (32, 32), bs 10) within
     1e-6 of the same inputs solved in f64, its rel_rnorm, forward and
     forward + IFT backward medians of 5, one profile;
  8. Burgers trainer: 3 Adam steps at the BurgersConfig defaults (the full
     128 x 256 field through the width-128, depth-12 ResNet, bs 10 f32_ir
     solves), finite loss, step times and each solve's rel_rnorm;
  9. sine fit: 25 epochs with f64 solves; the last loss below 0.2 x the
     first;
 10. transport: both examples' main(); interior advection error <= 3.0e-2
     (multigrid: (8, 512), n_grid 6, f64 outer FGMRES with K1 f64, K1 f32
     and K2 at bw 40 in the V-cycle) and <= 2.5e-2 (dense); one multigrid
     window profiled to count K1 f64, K1 f32 and K2 launches;
 11. Kamani trainer: 3 Adam steps at the KamaniConfig defaults (bs 2048
     dense (24,) f32_ir solves, the width-100, depth-9 ResNet1D) on data
     from the port's generator (into data/kamani/); finite loss, pinned
     coefficient row, |exponents| <= 2; the last step profiled; the
     closed-loop error of the learned model and of the true one (< 0.01);
 12. GL with the ResNet transform: 3 Adam steps at GLConfig(nn_transform=
     True) defaults (two width-128, depth-12 ResNets on 256 frames of 32 x
     32) and one backward_probe; finite loss, K1 and K2 launched, every
     probe solve finite;
 13. resume: Kamani train() for one 1-step epoch with a checkpoint, then
     again from that run directory for 2 epochs: it starts at epoch 1 from
     the checkpoint's parameters, Adam moments and scheduler step bit for
     bit, and its step moves the parameters;
 14-17. the b30c4rm layer step (phase 3's inputs and FGMRES budget) under
     each solver option beyond it, one warm-up and 3 timed forward + IFT
     backward steps each (median, min, max, FGMRES iterations, forward
     rel_rnorm, K1/K2 launches; every output and gradient finite):
     the factored normal operator A^T (A x) (mg_normal_op='factored'; no
     K1, K2 for the line blocks; forward rel_rnorm within 2x of phase 3's),
     evolution rows (evolution=True, which falls back to it; K2), point
     blocks (mg_block_smoother='point': K1, and K2's point-block kernel at
     nt 1, bw 7; then the point step on that kernel and on line_block.cu's
     streamed K2 at nt 1, the design before it, in turns: rel_rnorm within
     1 %, step medians, K2's device ms per step from a profiled step each;
     then 16b: K2 f32, K2 bf16 and K3's point-block kernels on the blocks of
     point hierarchies stored in 'f32', 'bf16' and 'bf16_factored' (the
     latter two each driven by one forward, whose launches are their
     kernels' path), at the fine level (bs 32 x 8192 blocks of 7 x 7) and
     level 1, against their plain versions with and without the epilogue,
     timed alone and back to back beside their bounds, their plain versions,
     one bmm (two for K3) and line_block.cu's kernel; then at bw 2, 3, 4, 5
     and 7 at item counts no tile divides and below one tile, and on
     operands off 16-byte alignment) and the Jacobi smoother
     (mg_smoother='jacobi': K1 and K2);
 16c. parallel/ (after 16b): K1 with its output window on the slab rank 0
     of sp 2 holds at the GL fine level (12 planes, the window on 4) against
     its plain version, the whole-grid K1's rows and a CSR product over the
     window's rows, timed beside its bound; then two processes on cuda:0
     over gloo (spawned; each prints its step time and peak memory, which
     are no scaling figure: the two share one card): (a) the sharded
     matvec (bs 32, (8, 32, 32), sp 2) in f32 and f64 against one-process
     K1 (1e-6, 1e-12) and the windowed K1 against its plain version on the
     rank's exchanged slab; (b) the point step of phase 16 with a mesh of
     sp 2, forward + IFT backward, against the unsharded step here:
     rel_rnorm within 1.2x, u0 within 1e-3 and the coefficient and rhs
     gradients within 2e-2, or, where the unsharded step itself moves more
     than half that under a 1e-7 change of its coefficients or rhs
     (measured here, both signs), within twice its own movement; the launch counts of the
     sharded step (windowed K1, K2); (c) the dry run's training step at the
     b30c4rm layer with a converged float64 outer FGMRES, the batch of 32
     split over dp 2, against the same step in one process (the parameters
     after one Adam step within 1e-5 of their largest magnitude; the
     one-process step's own movement under a 1e-7 change of the patches is
     printed beside); then one NCCL process at world size 1: (d) the point
     layer's forward with a mesh of sp 1 (rel_rnorm within 1.2x and u0
     within 1e-3 of the unsharded step);
 18. (run after phase 2, on its hierarchy) the other Krylov solvers at the
     fine level (bs 32, 57,344 unknowns, K1 f32 as AtA, b = A^T rhs): cg,
     minres, gmres (restart 30), lgmres and cg_block for 60 iterations at
     tol 0, cg_normal on the structured A and A^T: true residuals (K1)
     finite and below ||b||, within 10 % of the reported one for gmres and
     lgmres, cg_block's x within 1e-3 of cg's; ms per iteration;
 19. the native pair-table builder (g++, ops/native.py) loads, and its
     tables for the GL fine system equal the NumPy twin's; both timed;
 20. one JSON line {"kernels": [...]} with each kernel's numbers and the
     launch counts of the run that drives it ("launches_in"; the row-tiled
     K2 f32, K2 bf16 and K3 kernels are entries of their own, on the
     long-window path, with its steps' numbers under "long_window_steps";
     so are the kernels of its level 1, at bw 175, with their launches
     there);
     K1 and K1
     bf16 also carry their level-1 numbers ("*_level1") and K1 its f64
     ones ("f64_*"); K1 f64 is also an entry of its own, counted on the
     transport multigrid path, with its numbers at that path's shapes and
     its GL-shape ones beside them ("gl_shapes"); K1 and K2 carry their
     transport-shape numbers ("transport") and their launches in phase 12
     ("launches_gl_nn_transform"); each line-block kernel carries the
     phase-2d rows its route ran ("wide_blocks", each with its bmm times,
     "library_ms*"), the
     point-block kernels their phase-16b numbers (with "*_level1", the
     device's time per launch from a CUDA graph of 20 launches,
     "device_ms", and line_block.cu's kernel's times, "parent_*"; K2's the
     point step by route, "point_step") and K1 its windowed row
     ("window", phase 16c), and every kernel its launches on the paths of
     phases 14-18 ("launches_new_paths"; the sharded step's and the NCCL
     forward's summed over their ranks, K1's windowed launches apart); then
     {"ok": true, "device": {...}} as the last line.  The script turns TF32
     off for matmuls and cuDNN, so every product and convolution here runs
     in full float32.

Any failure exits nonzero.  Imports nothing of JAX.

Run from the repository root:  python3 chip_smoke.py [--seed 0]
tools/line_block_parent_check.py runs another checkout's line-block kernels
in turns with this one's.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import logging
import math
import re
import statistics
import subprocess
import sys
import time

import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, f32 and f64 rates
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12


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


def bound(n_bytes: float, n_flops: float, peak: float = PEAK_F32_FLOPS):
    """(least milliseconds the card could take, what bounds it): the larger
    of the bytes over the memory rate and the operations over the peak of
    their type (f32 unless given)."""
    t_bytes, t_flops = n_bytes / HBM_BYTES_PER_S, n_flops / peak
    return max(t_bytes, t_flops) * 1e3, "bytes" if t_bytes >= t_flops else "operations"


def block_bound(blocks, n_vec: int, factored: bool):
    """`bound` of a block apply over the (..., bw, bw) blocks and n_vec f32
    entries of r read and of the result written: K2 reads every entry of
    B^-1 once, 2 operations each; K3 needs W's upper triangle only (its
    strict lower one is zero by contract), bw (bw + 1) / 2 entries a block,
    read once and used twice (W^T r, then W u), 4 operations each."""
    bw = blocks.shape[-1]
    entries = blocks.numel() // (bw * bw) * (bw * (bw + 1) // 2 if factored else bw * bw)
    return bound(entries * blocks.element_size() + 4 * 2 * n_vec,
                 (4 if factored else 2) * entries)


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


# ptxas's name for K1's instantiations: stored type, NCOORD, ORDER, P
K1_MANGLED = re.compile(r"k1_stencil_applyI(\w+?)Li(\d)ELi(\d)ELi(\d)EE")
K1_TYPES = {"ff": "f32", "dd": "f64", "13__nv_bfloat16f": "bf16"}


def ptxas_report(text: str):
    """(kernel, registers, stack frame, spill store, spill load bytes) of
    each entry function in `nvcc -Xptxas -v` output."""
    rows, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = [m.group(1)]
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and cur and len(cur) == 1:
            cur += [int(v) for v in m.groups()]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur and len(cur) == 4:
            rows.append((cur[0], int(m.group(1)), *cur[1:]))
            cur = None
    return rows


def check_k1_ptxas(text: str) -> None:
    """Every K1 instantiation (3 stored types x 6 layouts x 2 point widths)
    keeps its per-thread arrays in registers: no stack frame, no spills."""
    seen = {}
    for name, regs, stack, st, ld in ptxas_report(text):
        m = K1_MANGLED.search(name)
        if m:
            seen[(K1_TYPES[m.group(1)], int(m.group(2)), int(m.group(3)), int(m.group(4)))] = (
                regs, stack, st, ld)
    for (t, nc, o, P), (regs, stack, st, ld) in sorted(seen.items()):
        log(f"  ptxas K1 {t} n_coord {nc} order {o} P {P}: {regs} registers, {stack} B stack "
            f"frame, {st} B spill stores, {ld} B spill loads")
    bad = [k for k, v in seen.items() if any(v[1:])]
    if len(seen) != 36 or bad:
        raise AssertionError(f"K1 ptxas: {len(seen)} instantiations of 36, with stack or "
                             f"spills: {bad}")


def check_line_block_ptxas(text: str) -> None:
    """The seven line_block.cu kernels (K2 f32 and bf16 streamed and on
    panels, K3 streamed, on a cluster and two-sweep) keep everything in
    registers: no stack frame, no spills."""
    rows = [r for r in ptxas_report(text) if re.search(r"k[23]_\w*line_block_apply", r[0])]
    for name, regs, stack, st, ld in rows:
        kern = re.search(r"(k[23]_\w*line_block_apply\w*?)(I|E)", name).group(1)
        log(f"  ptxas {kern}{' bf16' if 'bfloat16' in name else ''}: {regs} registers, "
            f"{stack} B stack frame, {st} B spill stores, {ld} B spill loads")
    if len(rows) != 7 or any(any(r[2:]) for r in rows):
        raise AssertionError(f"line_block ptxas: {len(rows)} kernels of 7, rows {rows}")


POINT_MANGLED = re.compile(r"(k[23])_point_block_applyI(f|13__nv_bfloat16)?Li(\d)E")


def check_point_block_ptxas(text: str) -> None:
    """The 15 point_block.cu kernels (K2 f32 and bf16, K3; bw 2, 3, 4, 5, 7)
    keep everything in registers: no stack frame, no spills."""
    seen = {}
    for name, regs, stack, st, ld in ptxas_report(text):
        m = POINT_MANGLED.search(name)
        if m:
            kern = f"{m.group(1)}_point_block_apply{' bf16' if m.group(2) != 'f' else ''}"
            seen[(kern, int(m.group(3)))] = (regs, stack, st, ld)
    for (kern, bw), (regs, stack, st, ld) in sorted(seen.items()):
        log(f"  ptxas {kern} bw {bw}: {regs} registers, {stack} B stack frame, {st} B spill "
            f"stores, {ld} B spill loads")
    bad = [k for k, v in seen.items() if any(v[1:])]
    if len(seen) != 15 or bad:
        raise AssertionError(f"point_block ptxas: {len(seen)} kernels of 15, with stack or "
                             f"spills: {bad}")


def check_k1_epilogues(label, desc, coef, x, b, tol):
    """K1's residual and iterate epilogues against the plain version, apart
    and in place (out = rin, xout = xin, as the smoothing pass runs it)."""
    from mech_nn_discovery_pde_torch.ops import normal_stencil as ns

    xo_k, xo_p = torch.empty_like(x), torch.empty_like(x)
    r_k = ns.stencil_apply(desc, coef, x, rin=b, xin=b, xout=xo_k)
    r_p = ns.stencil_apply_plain(desc, coef, x, rin=b, xin=b, xout=xo_p)
    check(f"{label} residual epilogue", rel_err(r_k, r_p), tol)
    check(f"{label} iterate epilogue", rel_err(xo_k, xo_p), tol)
    r, xi = b.clone(), b.clone()
    ns.stencil_apply(desc, coef, x, rin=r, out=r, xin=xi, xout=xi)
    check(f"{label} epilogues in place", max(rel_err(r, r_p), rel_err(xi, xo_p)), tol)


def stencil_csr(desc, coef, window=None):
    """The assembled AtA of every sample as one block-diagonal sparse CSR
    matrix over the flat point-major vector: the library yardstick for K1
    (a cuSPARSE product), built here and used nowhere in the port.  With an
    output window (p0, n), only the rows of its points (K1's window)."""
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
    rows, cols, vals = torch.cat(rows), torch.cat(cols), torch.cat(vals, dim=1)
    p0, n = (0, N) if window is None else window
    keep = (rows >= p0 * m) & (rows < (p0 + n) * m)
    rows, cols, vals = rows[keep] - p0 * m, cols[keep], vals[:, keep]
    roff = (torch.arange(bs, device=coef.device) * n * m)[:, None]
    coff = (torch.arange(bs, device=coef.device) * N * m)[:, None]
    idx = torch.stack([(rows[None] + roff).reshape(-1), (cols[None] + coff).reshape(-1)])
    A = torch.sparse_coo_tensor(idx, vals.reshape(-1), (bs * n * m, bs * N * m),
                                check_invariants=False)
    return A.coalesce().to_sparse_csr()


def phase_kernels(layer, hier, values, dev, seed):
    """Phase 2: every kernel against its plain version at the GL shapes."""
    from mech_nn_discovery_pde_torch.ops import _cuda
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
        check_k1_epilogues(f"K1 f64 (level {k})", desc, coef64, x64, b.double(), 1e-12)
        geo = {n: ns.stencil_geometry(N, bs, t.element_size(), _cuda.sm_count(dev))
               for n, t in (("f32", x), ("f64", x64))}
        log(f"  K1 geometry (level {k}): {geo}")

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
        x0 = 0.1 * torch.randn((bs, N * m), generator=g, device=dev)
        for x0_zero in (True, False):
            # the pass as the solver composes it (K1 and K2 through its closures)
            xs_k, rs_k = mg._smooth(k, lvl, b, x0, 4, False, x0_zero, want_residual=True)
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
        for x0_zero in (True, False):
            xs_k, rs_k = stored["bf16_factored"]._smooth(k, lw, b, x0, 4, False, x0_zero,
                                                         want_residual=True)
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
        check_k1_epilogues(f"K1 bf16-field (level {k})", desc, coef16, x, b, 1e-5)
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
        k3_bound, k3_by = block_bound(W, bs * N * m, True)
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
        # K1 f64: per launch, back to back, and its own bound (8-byte values);
        # its plain version and a CSR sparse product in f64 beside it
        y64 = torch.empty_like(x64)
        t_k1_64b = time_ms_back_to_back(lambda: ns.stencil_apply(desc, coef64, x64, out=y64))
        k1d_bound, k1d_by = bound(8 * (NC + 2 * m) * N * bs, 2 * (m * m + 2 * nb) * N * bs,
                                  PEAK_F64_FLOPS)
        y64_p = ns.stencil_apply_plain(desc, coef64, x64)
        err64 = abs_err(ns.stencil_apply(desc, coef64, x64, out=y64), y64_p)
        t_k1_64p = time_ms(lambda: ns.stencil_apply_plain(desc, coef64, x64))
        A_csr = stencil_csr(desc, coef64)
        x64col = x64.reshape(-1, 1)
        check(f"f64 CSR yardstick vs K1 (level {k})",
              rel_err(torch.sparse.mm(A_csr, x64col).reshape(bs, -1), y64), 1e-12)
        t_k1_64lib = time_ms(lambda: torch.sparse.mm(A_csr, x64col))
        del A_csr
        log(f"  K1 f64 {t_k1_64:.4f} ms, back to back {t_k1_64b:.4f} ms (plain {t_k1_64p:.4f}, "
            f"f64 CSR sparse.mm {t_k1_64lib:.4f}, bound {k1d_bound:.4f})")
        if k == 0:  # level 0 enters the report
            for key, (err, ms, plain, bnd, by, lib) in rows.items():
                report[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                                   bound_by=by, library_ms=lib, ms_back_to_back=b2b[key])
        # K1's level-1 numbers and its f64 ones beside them
        sfx = "" if k == 0 else "_level1"
        if k == 1:
            for key in ("k1", "k1_bf16"):
                _, ms, _, bnd, _, _ = rows[key]
                report[key].update({"ms_level1": ms, "ms_back_to_back_level1": b2b[key],
                                    "bound_ms_level1": bnd})
        report["k1"].update({f"f64_ms{sfx}": t_k1_64, f"f64_ms_back_to_back{sfx}": t_k1_64b,
                             f"f64_bound_ms{sfx}": k1d_bound})
        # K1 f64 as a kernel of its own (the transport multigrid path runs it)
        f64_row = {f"ms{sfx}": t_k1_64, f"plain_ms{sfx}": t_k1_64p, f"bound_ms{sfx}": k1d_bound,
                   f"library_ms{sfx}": t_k1_64lib, f"ms_back_to_back{sfx}": t_k1_64b}
        if k == 0:
            f64_row.update(max_abs_err=err64, bound_by=k1d_by)
        report.setdefault("k1_f64", {}).update(f64_row)
        del lw, lb, W, coef16, binv16
    return report


# phase 2b's shapes (nt, m, S): bw 42 (the CPU tests' (6, 12, 12) systems;
# bf16 blocks of 3,528 B, 8 mod 16) and 30 (m 5; bf16 1,800 B, 8 mod 16),
# then the odd widths 21 to 133 (blocks off 16 bytes in f32 and bf16) and
# 175, 217, 238 (the long window's level 1 and wider: the row-tiled kernels
# since the streamed ring no longer holds 2 stages in 2 CTAs an SM)
ODD_SHAPES = ((6, 7, 144), (6, 5, 144), (3, 7, 144), (5, 7, 144), (9, 7, 144), (15, 7, 96),
              (19, 7, 64), (25, 7, 48), (31, 7, 32), (34, 7, 32))


def phase_odd_shape(dev, seed, bs=2):
    """Phase 2b: K2 (f32 and bf16 blocks) and K3 against their plain
    versions, with and without the Chebyshev epilogue (1e-5), on random
    blocks at the mid widths and unaligned blocks of ODD_SHAPES, and at bw 56
    on blocks 4 (f32) or 2 (bf16) bytes off 16-byte alignment: every block
    reaches shared memory by a bulk copy (of the whole block where all are
    16-byte aligned, else of its aligned interior, `panel_copy`).  Each
    launch logs its route and geometry (walk, whole or shifted copy) and
    must launch its route's kernel twice and nothing else."""
    from mech_nn_discovery_pde_torch.ops import _cuda
    from mech_nn_discovery_pde_torch.ops import fused_smoother as fs

    g = torch.Generator(device=dev).manual_seed(seed + 2)
    n_sm = _cuda.sm_count(dev)
    for nt, m, S in ODD_SHAPES + ((8, 7, 64),):
        bw = nt * m
        off = (nt, m, S) == (8, 7, 64)
        n = nt * S * m
        x = torch.randn((bs, n), generator=g, device=dev)
        b = torch.randn((bs, n), generator=g, device=dev)
        c1 = torch.rand((bs,), generator=g, device=dev)
        c2 = torch.rand((bs,), generator=g, device=dev)
        B = torch.randn((bs, S, bw, bw), generator=g, device=dev)
        W = torch.randn((bs, S, bw, bw), generator=g, device=dev).triu().to(torch.bfloat16)
        cases = (("K2 f32", fs.block_apply, fs.block_apply_plain, B, False),
                 ("K2 bf16", fs.block_apply, fs.block_apply_plain, B.to(torch.bfloat16), False),
                 ("K3", fs.factored_block_apply, fs.factored_block_apply_plain, W, True))
        for name, kern, plain, blocks, factored in cases:
            if off:  # the same blocks one entry into a larger buffer
                buf = torch.empty(blocks.numel() + 1, dtype=blocks.dtype, device=dev)
                buf[1:] = blocks.reshape(-1)
                blocks = buf[1:].view(blocks.shape)
            eb = blocks.element_size()
            geo = fs.line_block_geometry(bs, S, bw, eb, n_sm, factored)
            smem, flags = fs.line_block_launch_args(geo, bw, eb, factored, blocks.data_ptr())
            kernels = fs._K3_FN if factored else fs._K2_FN[blocks.dtype]
            label = (f"{name} bw {bw} (nt {nt}, m {m}, {S} lines"
                     f"{', blocks off 16-byte alignment' if off else ''})")
            copy = ("" if geo.route != "streamed" else
                    ", whole-block copies" if flags & 1 else ", shifted copies (panel_copy)")
            log(f"  {label}: {geo.route} ({kernels.line_counted[geo.route]}), {geo.ctas} CTAs, "
                f"{geo.stages} stages, {geo.panel_rows} rows, {smem} B shared, walk {geo.walk}"
                f"{copy}")
            _cuda.LAUNCHES.clear()
            check_line_kernel(label, kern, plain, blocks, x, b, c1, c2, nt)
            torch.cuda.synchronize()
            if dict(_cuda.LAUNCHES) != {kernels.line_counted[geo.route]: 2}:
                raise AssertionError(f"{label}: launches {dict(_cuda.LAUNCHES)}, want 2 of "
                                     f"{kernels.line_counted[geo.route]}")
        del B, W, x, b
    torch.cuda.synchronize()


# the (n_coord, order) layouts GL (3, 2) does not run, as small systems
K1_SMALL = (((40,), 1), ((40,), 2), ((24, 20), 1), ((24, 20), 2), ((6, 8, 10), 1))
K1_SMALL_IVS = {
    1: [lambda nt: (0, 0, [0], [0])],
    2: [lambda nt, nx: (0, 0, [0, 0], [0, nx - 1]),
        lambda nt, nx: (1, 1, [1, 0], [nt - 1, 0])],
    3: [lambda nt, nx, ny: (0, 0, [0, 0, 0], [0, nx - 1, ny - 1]),
        lambda nt, nx, ny: (1, 0, [1, 0, 0], [nt - 1, 0, ny - 1])],
}


def phase_k1_layouts(dev, seed):
    """Phase 2c: K1 at the five (n_coord, order) layouts GL does not run,
    against its plain version in f32 (1e-5), f64 (1e-12) and bf16 fields
    (1e-5), apply and epilogues.  Each system (the port's ops/system.py,
    random values from --seed) runs at bs 3, where the geometry takes one
    point a thread, and at bs 2 x SMs, where it takes 16-byte loads; both
    widths must be seen for every stored type."""
    from mech_nn_discovery_pde_torch.ops import _cuda
    from mech_nn_discovery_pde_torch.ops import normal_stencil as ns
    from mech_nn_discovery_pde_torch.ops.system import PDESystem

    g = torch.Generator(device=dev).manual_seed(seed + 3)
    n_sm = _cuda.sm_count(dev)
    widths = set()
    for dims, order in K1_SMALL:
        sy = PDESystem.build(dims, order=order, init_index_mi_list=K1_SMALL_IVS[len(dims)],
                             step_size=0.1)
        desc = ns.make_desc(sy.spec)
        N, m = desc.grid_size, desc.n_mi
        for bs in (3, 2 * n_sm):
            v = torch.randn((bs, sy.n_entries), generator=g, device=dev, dtype=torch.float64)
            coef64 = ns.build_normal_coef(sy.spec, desc, sy.split_values(v))
            x64 = torch.randn((bs, N * m), generator=g, device=dev, dtype=torch.float64)
            b64 = torch.randn((bs, N * m), generator=g, device=dev, dtype=torch.float64)
            for name, cdt, xdt, tol in (("f32", torch.float32, torch.float32, 1e-5),
                                        ("f64", torch.float64, torch.float64, 1e-12),
                                        ("bf16", torch.bfloat16, torch.float32, 1e-5)):
                coef, x, b = coef64.to(cdt).contiguous(), x64.to(xdt), b64.to(xdt)
                geo = ns.stencil_geometry(N, bs, x.element_size(), n_sm)
                widths.add((name, geo.P > 1))
                label = f"K1 {name} {dims} order {order} bs {bs} P {geo.P}"
                check(f"{label} apply", rel_err(ns.stencil_apply(desc, coef, x),
                                                ns.stencil_apply_plain(desc, coef, x)), tol)
                check_k1_epilogues(label, desc, coef, x, b, tol)
        torch.cuda.synchronize()
    if len(widths) != 6:
        raise AssertionError(f"K1 layouts: point widths seen {sorted(widths)}, want both for "
                             f"every stored type")


def phase_transport_kernels(dev, seed):
    """Phase 2e: K1 (f64 and f32) and K2 at the shapes the transport
    multigrid example gives them: its hierarchy (bs 5, (8, 512), n_grid 6,
    default PDEConfig; 2-D order 2, m 5, time-line blocks of bw 40) at
    levels 0 and 1.  K1 f64 on the outer FGMRES's fine operator (level 0;
    at level 1 the same build from the stored values) against its plain
    version at 1e-12, K1 f32 and K2 on the V-cycle's stored operators at
    1e-5, each with its epilogues, and a 4-step smoothing pass at 1e-4.
    Each is timed per launch and back to back beside its plain version, a
    PyTorch call computing the same function (CSR sparse product; bmm) and
    its bound.  Returns {key: numbers} for the kernels line (level 0, and
    level 1 under "*_level1")."""
    from mech_nn_discovery_pde_torch.examples import transport_multigrid
    from mech_nn_discovery_pde_torch.ops import _cuda
    from mech_nn_discovery_pde_torch.ops import fused_smoother as fs
    from mech_nn_discovery_pde_torch.ops import normal_stencil as ns

    g = torch.Generator(device=dev).manual_seed(seed + 5)
    layer, coeffs, rhs, iv, steps, _ = transport_multigrid.build(device=dev)
    values, _, hier = layer._prepare(coeffs, rhs, iv, steps)
    mg = layer.mg_solver
    out = {"k1_f64": {}, "k1": {}, "k2": {}}
    for k in (0, 1):
        lvl = hier["levels"][k]
        desc, nt, sys_k = mg.descs[k], mg.dim_list[k][0], mg.systems[k]
        coef, binv = lvl["coef"], lvl["binv"]
        coef64 = (mg._fine_coef(hier, values) if k == 0 else
                  ns.build_normal_coef(sys_k.spec, desc, sys_k.split_values(lvl["values"].double())))
        if not (coef.dtype == binv.dtype == torch.float32 and coef64.dtype == torch.float64):
            raise AssertionError(f"transport level {k}: operands {coef.dtype}, {binv.dtype}, "
                                 f"{coef64.dtype}")
        bs, NC, N = coef.shape
        m = desc.n_mi
        S, bw = N // nt, nt * m
        log(f"transport level {k}: dims {mg.dim_list[k]}  NC {NC}  N {N}  m {m}  lines {S} x "
            f"{bw}^2  bs {bs}")
        x = torch.randn((bs, N * m), generator=g, device=dev)
        b = torch.randn((bs, N * m), generator=g, device=dev)
        x64, b64 = x.double(), b.double()
        y64_k, y64_p = ns.stencil_apply(desc, coef64, x64), ns.stencil_apply_plain(desc, coef64, x64)
        check(f"K1 f64 apply (transport level {k})", rel_err(y64_k, y64_p), 1e-12)
        check_k1_epilogues(f"K1 f64 (transport level {k})", desc, coef64, x64, b64, 1e-12)
        y_k, y_p = ns.stencil_apply(desc, coef, x), ns.stencil_apply_plain(desc, coef, x)
        check(f"K1 f32 apply (transport level {k})", rel_err(y_k, y_p), 1e-5)
        check_k1_epilogues(f"K1 f32 (transport level {k})", desc, coef, x, b, 1e-5)
        t_k, t_p = fs.block_apply(binv, x, nt), fs.block_apply_plain(binv, x, nt)
        check(f"K2 apply (transport level {k}, bw {bw})", rel_err(t_k, t_p), 1e-5)
        c1 = torch.rand((bs,), generator=g, device=dev)
        c2 = torch.rand((bs,), generator=g, device=dev)
        d_k, d_p = b.clone(), b.clone()
        fs.block_apply(binv, x, nt, d=d_k, c1=c1, c2=c2)
        fs.block_apply_plain(binv, x, nt, d=d_p, c1=c1, c2=c2)
        check(f"K2 Chebyshev epilogue (transport level {k})", rel_err(d_k, d_p), 1e-5)
        ratio = mg.config.mg_chebyshev_ratio
        x0 = 0.1 * torch.randn((bs, N * m), generator=g, device=dev)
        xs_k, rs_k = mg._smooth(k, lvl, b, x0, 4, False, False, want_residual=True)
        xs_p, rs_p = fs.chebyshev_smooth_plain(desc, nt, coef, binv, b, x0, lvl["lmax"], ratio, 4,
                                               False)
        check(f"smoothing pass (transport level {k})",
              max(rel_err(xs_k, xs_p), rel_err(rs_k, rs_p)), 1e-4)
        torch.cuda.synchronize()

        nb = len(desc.bands)
        k1_flops = 2 * (m * m + 2 * nb) * N * bs
        geo = {n: ns.stencil_geometry(N, bs, t.element_size(), _cuda.sm_count(dev))
               for n, t in (("f32", x), ("f64", x64))}
        log(f"  K1 geometry (transport level {k}): {geo}; K2 "
            f"{fs.line_block_geometry(bs, S, bw, 4, _cuda.sm_count(dev), False)}")
        xcol, x64col = x.reshape(-1, 1), x64.reshape(-1, 1)
        A_csr, A64_csr = stencil_csr(desc, coef), stencil_csr(desc, coef64)
        check(f"f64 CSR yardstick vs K1 (transport level {k})",
              rel_err(torch.sparse.mm(A64_csr, x64col).reshape(bs, -1), y64_k), 1e-12)
        rb = fs.line_vec_to_blocks(x, nt, m).reshape(bs * S, bw, 1).contiguous()
        B2 = binv.reshape(bs * S, bw, bw)
        cases = {  # key: (kernel, plain, library call, error, bytes, flops, peak)
            "k1_f64": (lambda: ns.stencil_apply(desc, coef64, x64, out=y64_k),
                       lambda: ns.stencil_apply_plain(desc, coef64, x64),
                       lambda: torch.sparse.mm(A64_csr, x64col), abs_err(y64_k, y64_p),
                       8 * (NC + 2 * m) * N * bs, k1_flops, PEAK_F64_FLOPS),
            "k1": (lambda: ns.stencil_apply(desc, coef, x, out=y_k),
                   lambda: ns.stencil_apply_plain(desc, coef, x),
                   lambda: torch.sparse.mm(A_csr, xcol), abs_err(y_k, y_p),
                   4 * (NC + 2 * m) * N * bs, k1_flops, PEAK_F32_FLOPS),
            "k2": (lambda: fs.block_apply(binv, x, nt, d=t_k),
                   lambda: fs.block_apply_plain(binv, x, nt), lambda: torch.bmm(B2, rb),
                   abs_err(t_k, t_p), 4 * (bs * S * bw * bw + 2 * bs * N * m),
                   2 * bs * S * bw * bw, PEAK_F32_FLOPS),
        }
        sfx = "" if k == 0 else "_level1"
        for key, (kern, plain, lib, err, n_bytes, n_flops, peak) in cases.items():
            bnd, by = bound(n_bytes, n_flops, peak)
            row = {"ms": time_ms(kern), "ms_back_to_back": time_ms_back_to_back(kern),
                   "plain_ms": time_ms(plain), "library_ms": time_ms(lib), "bound_ms": bnd}
            log(f"  {key} (transport level {k}): {row['ms']:.4f} ms, back to back "
                f"{row['ms_back_to_back']:.4f} (plain {row['plain_ms']:.4f}, library "
                f"{row['library_ms']:.4f}, bound {bnd:.5f}, {by})")
            row.update(max_abs_err=err, bound_by=by)
            out[key].update({f"{n}{sfx}": v for n, v in row.items()})
        del A_csr, A64_csr, B2
    del layer, hier, values
    return out


# CUPTI overhead records (host blocked on a full launch queue, trace buffer
# flushes): reported beside the device's activities but no work of the card
PROFILER_OVERHEAD = ("Command Buffer Full", "Buffer Flush")


def device_events(prof):
    """Trace events of work on the card (kernels, copies, memsets)."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not any(o in e.name for o in PROFILER_OVERHEAD)]


# the port's kernels by the name the profiler shows (each name matches only
# itself: k2_line_block_apply is not k2_line_block_apply_panels)
PORT_KERNELS = ("k1_stencil_apply", "k2_line_block_apply", "k2_line_block_apply_panels",
                "k3_factored_line_block_apply", "k3_factored_line_block_apply_cluster",
                "k3_factored_line_block_apply_tiled", "k2_point_block_apply",
                "k3_point_block_apply")


def is_kernel(name: str, event_name: str) -> bool:
    """Whether a trace event is a launch of the kernel `name`."""
    return re.search(rf"(?<!\w){name}(?!\w)", event_name) is not None


def kernel_counts(prof):
    """Launch counts of the port's kernels in a trace, the device's busy time
    (microseconds: the union of the work's intervals, so overlapping
    streams count once) and device time by name."""
    names = dict.fromkeys(PORT_KERNELS, 0)
    by_name = {}
    spans = []
    for e in device_events(prof):
        spans.append((e.time_range.start, e.time_range.end))
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.end - e.time_range.start, c + 1)
        for n in names:
            if is_kernel(n, e.name):
                names[n] += 1
    busy_us, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        if t > end:
            busy_us += t - max(s, end)
            end = t
    return names, busy_us, by_name


# the layer step's kernels of the time-line block apply, by storage mode; no
# other block kernel may launch.  The GL step's 56-wide blocks take the
# streamed kernels
BLOCK_KERNEL = {"f32": ("k2_line_block_apply",),
                "bf16_factored": ("k3_factored_line_block_apply",)}
# the long window's, by storage mode and level: the fine level's blocks (bw
# 350) take the row-tiled kernels; level 1's (bw 175) the panel kernel in
# f32 (streamed only to bw 137), the streamed kernel in bf16 (one CTA of 3
# stages an SM) and the cluster kernel for K3 (clusters of 2 CTAs of 2
# stages; streamed only to bw 168): ops/fused_smoother.line_block_geometry
LONG_BLOCK_KERNEL = {"f32": {0: ("k2_line_block_apply_panels",),
                             1: ("k2_line_block_apply_panels",)},
                     "bf16_factored": {0: ("k3_factored_line_block_apply_cluster",),
                                       1: ("k3_factored_line_block_apply_cluster",)},
                     "bf16": {0: ("k2_line_block_apply_panels_bf16",),
                              1: ("k2_line_block_apply_bf16",)}}


def b30c4rm_layer(dev, precond="f32", bs=32, dims=(8, 32, 32), n_grid=3, evolution=False,
                  mesh=None, downsample_first=False, **opts):
    """The production GL layer "b30c4rm" (bench.py:119-129) with the given
    stored-preconditioner dtype, evolution rows and further solver options,
    sp-sharded over `mesh` when given; `downsample_first` halves the time
    axis too between levels (MultigridLayer's own default)."""
    from mech_nn_discovery_pde_torch.config import PDEConfig
    from mech_nn_discovery_pde_torch.discovery.ginzburg_landau import GLDiscovery
    from mech_nn_discovery_pde_torch.layers.multigrid import MultigridLayer

    cfg = PDEConfig(**{
        **dict(precision="f32_ir", mg_solve_dtype="f32",
               mg_smoother_steps_pre=4, mg_smoother_steps_post=4,
               mg_fgmres_max_iter_forward=30, mg_fgmres_max_iter_backward=30,
               mg_smoother_residual=True, mg_fused_matvec=True, return_solve_stats=True,
               mg_precond_dtype=precond), **opts})
    return MultigridLayer(bs=bs, coord_dims=dims, order=2, n_ind_dim=1, n_iv=1,
                          init_index_mi_list=GLDiscovery.IV_LIST, solver_dbl=True,
                          n_grid=n_grid, downsample_first=downsample_first, evolution=evolution,
                          config=cfg, device=dev, mesh=mesh)


@contextlib.contextmanager
def launches_by_level(layer, timed=False):
    """The block applies' launches by the level they run on: wraps the
    layer's solver's `_block_apply(k, ...)` for the duration and yields
    {level: Counter of the launches it made}; with `timed`, also
    {"ms": {level: device milliseconds}}, from CUDA events around each
    apply, read once the block exits (an apply queued behind other work is
    timed from that work's end, so the events time the kernel alone where
    the stream is busy)."""
    from mech_nn_discovery_pde_torch.ops import _cuda

    mg = layer.mg_solver
    levels, events = {}, []
    block_apply = mg._block_apply

    def counted(k, lvl, r, **epilogue):
        before = dict(_cuda.LAUNCHES)
        if timed:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        out = block_apply(k, lvl, r, **epilogue)
        if timed:
            e1.record()
            events.append((k, e0, e1))
        c = levels.setdefault(k, collections.Counter())
        for n, v in _cuda.LAUNCHES.items():
            if v != before.get(n, 0):
                c[n] += v - before.get(n, 0)
        return out

    mg._block_apply = counted
    try:
        yield levels
    finally:
        del mg._block_apply
        if timed:
            torch.cuda.synchronize()
            ms = collections.Counter()
            for k, e0, e1 in events:
                ms[k] += e0.elapsed_time(e1)
            levels["ms"] = dict(ms)


def grad_step(layer, c0, r0, i0, steps):
    """Forward + IFT backward of sum(u0^2) on the layer: (stats, gradients
    w.r.t. coefficients, rhs and initial values)."""
    c = c0.clone().requires_grad_(True)
    r = r0.clone().requires_grad_(True)
    i = i0.clone().requires_grad_(True)
    u0, _, stats = layer(c, r, i, steps)
    (u0**2).sum().backward()
    return stats, (c.grad, r.grad, i.grad)


def time_layer_step(layer, c0, r0, i0, steps, label, blocks, rel_bar=3.1e-3,
                    level_blocks=None, runs=5):
    """The timing core of phases 3, 4 and 5b: a warm-up step; one step with
    the launch counts cleared just before and read just after, also by
    level; its checks (each kernel of `blocks` launched and no other block
    kernel, on each level only the kernels `level_blocks` gives it; every
    gradient finite; forward rel_rnorm at most rel_bar, where given); the
    step's median, min and max over `runs` runs on perturbed inputs; one
    profiled step (the card's activities only): launches by kernel (the
    same checks), device busy time, idle share, the top kernels.  Returns
    the numbers."""
    from mech_nn_discovery_pde_torch.ops import _cuda

    bs = c0.shape[0]
    t0 = time.perf_counter()
    grad_step(layer, c0, r0, i0, steps)
    torch.cuda.synchronize()
    log(f"{label}: warm-up step {time.perf_counter() - t0:.3f} s")
    _cuda.LAUNCHES.clear()
    with launches_by_level(layer, timed=True) as by_level:
        stats, grads = grad_step(layer, c0, r0, i0, steps)
        torch.cuda.synchronize()
    level_ms = by_level.pop("ms")
    counts = dict(_cuda.LAUNCHES)
    its = stats["iters"].tolist()
    rel = stats["rel_rnorm"]
    log(f"{label}: step launches {counts}; block applies by level "
        f"{ {k: dict(v) for k, v in sorted(by_level.items())} }, their device ms by level "
        f"{ {k: round(v, 3) for k, v in sorted(level_ms.items())} }; forward FGMRES iters "
        f"{sorted(set(its))}, rel_rnorm max {float(rel.max()):.4e} mean {float(rel.mean()):.4e}")
    stray = [n for n in counts if n.startswith(("k2_", "k3_")) and n not in blocks]
    if any(counts.get(n, 0) == 0 for n in blocks) or stray:
        raise AssertionError(f"{label}: block applies {counts}, want exactly {blocks}")
    for k, want in (level_blocks or {}).items():
        if set(by_level.get(k, {})) != set(want):
            raise AssertionError(f"{label}: level {k} block applies {dict(by_level.get(k, {}))}, "
                                 f"want {want}")
    for name, gr in zip(("coeffs", "rhs", "iv"), grads):
        if not bool(torch.isfinite(gr).all()):
            raise AssertionError(f"{label}: non-finite gradient w.r.t. {name}")
    if rel_bar is not None and not float(rel.max()) <= rel_bar:
        raise AssertionError(f"{label}: forward rel_rnorm {float(rel.max()):.3e} above the "
                             f"{rel_bar:.1e} bar")

    ts = []
    for k in range(runs):
        t0 = time.perf_counter()
        grad_step(layer, c0 + 1e-6 * (k + 1), r0, i0, steps)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    dt = ts[len(ts) // 2]
    log(f"{label}: step median {dt:.4f} s over {runs} runs (min {ts[0]:.4f}, max "
        f"{ts[-1]:.4f}, spread {(ts[-1] - ts[0]) / dt:.3f}); {bs / dt:.3f} KKT solves/s")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        grad_step(layer, c0, r0, i0, steps)
        torch.cuda.synchronize()
    names, busy_us, by_name = kernel_counts(prof)
    idle = max(0.0, 1 - busy_us / 1e6 / dt)
    log(f"profiler: kernel launches {names}; device busy {busy_us / 1e6:.4f} s per step, "
        f"idle share {idle:.3f} of the unprofiled median step")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (us, c) in top:
        log(f"  {us / 1e3:10.3f} ms  x{c:6d}  {name[:90]}")
    # a kernel's instantiations together (K1: one per layout and point width)
    device_ms = {n: sum(us for e, (us, _) in by_name.items() if is_kernel(n, e)) / 1e3
                 for n in names}
    log("profiler: device ms per step by kernel: " + ", ".join(
        f"{n} {ms:.3f}" for n, ms in device_ms.items()))
    for n, c in names.items():
        want = n == "k1_stencil_apply" or any(n == b or n + "_bf16" == b for b in blocks)
        if want and c == 0:
            raise AssertionError(f"profiler shows no launch of {n} in the {label}")
        if not want and c != 0:
            raise AssertionError(f"profiler shows {c} launches of {n} in the {label}")
    return dict(counts=counts, by_level={k: dict(v) for k, v in by_level.items()},
                block_ms_by_level=level_ms, rel_rnorm=float(rel.max()),
                iters=sorted(set(its)), step_s_median=dt,
                step_s_min=ts[0], step_s_max=ts[-1], device_busy_s=busy_us / 1e6,
                idle_share=idle, device_ms=device_ms,
                top_kernels=[(n[:90], us / 1e3, c) for n, (us, c) in top[:6]])


def phase_layer(seed, dev, precond="f32", bs=32, dims=(8, 32, 32)):
    """Phases 3 and 4: the b30c4rm layer step (b30c4rmw with
    precond='bf16_factored'), forward + IFT backward.  Returns the launch
    counts of one step and its forward rel_rnorm max."""
    t0 = time.perf_counter()
    layer = b30c4rm_layer(dev, precond, bs, dims)
    (c0, r0, i0), steps = bench_inputs(layer, bs, dims, seed, dev)
    log(f"layer ({precond} preconditioner storage) built in {time.perf_counter() - t0:.2f} s: "
        f"{layer.system.describe()}")
    out = time_layer_step(layer, c0, r0, i0, steps, f"{precond} layer step",
                          BLOCK_KERNEL[precond])
    return out["counts"], out["rel_rnorm"]


# the solver options of the JAX package beyond b30c4rm, each a layer step at
# its full width: (name, evolution, config options)
OPTION_PHASES = (
    ("factored", False, dict(mg_normal_op="factored")),
    ("evolution", True, {}),
    ("point", False, dict(mg_block_smoother="point")),
    ("jacobi", False, dict(mg_smoother="jacobi")),
)


def phase_option(seed, dev, name, evolution, opts, stencil_rel, bs=32, dims=(8, 32, 32)):
    """Phases 14-17: the b30c4rm layer step (phase 3's inputs and budget)
    under one more solver option: the factored normal operator A^T (A x)
    (no K1 launch; K2 for the line blocks), evolution rows (which fall back
    to it), point blocks (K1, and K2 at nt 1, bw 7) or the Jacobi smoother
    (K1, K2).  One warm-up, then 3 timed forward + IFT backward steps of
    sum(u0^2) with the launch counts cleared just before and read just
    after.  Fails on a non-finite output or gradient, or a block kernel
    other than K2; the factored step's forward rel_rnorm must be within 2x
    of phase 3's (the same AtA), and one factored V-cycle is profiled
    (`profile_v_cycle`).  Returns (launch counts of the 3 steps, the
    layer), the layer for phase 16b."""
    from mech_nn_discovery_pde_torch.ops import _cuda

    t0 = time.perf_counter()
    layer = b30c4rm_layer(dev, "f32", bs, dims, evolution=evolution, **opts)
    (c0, r0, i0), steps = bench_inputs(layer, bs, dims, seed, dev)
    log(f"{name} layer built in {time.perf_counter() - t0:.2f} s (normal operator "
        f"{layer.mg_solver.config.mg_normal_op!r}, smoother {layer.config.mg_smoother!r}, "
        f"blocks {layer.config.mg_block_smoother!r})")

    def step(c):
        c = c.clone().requires_grad_(True)
        r = r0.clone().requires_grad_(True)
        i = i0.clone().requires_grad_(True)
        u0, _, stats = layer(c, r, i, steps)
        (u0**2).sum().backward()
        for what, t in (("u0", u0), ("coeffs grad", c.grad), ("rhs grad", r.grad),
                        ("iv grad", i.grad)):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{name} layer step: non-finite {what}")
        return stats

    t0 = time.perf_counter()
    step(c0)
    torch.cuda.synchronize()
    log(f"{name} warm-up step {time.perf_counter() - t0:.3f} s")
    torch.cuda.synchronize()
    _cuda.LAUNCHES.clear()
    ts, its, rels = [], set(), []
    for k in range(3):
        t0 = time.perf_counter()
        stats = step(c0 + 1e-6 * (k + 1))
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
        its.update(stats["iters"].tolist())
        rels.append(float(stats["rel_rnorm"].max()))
    counts = dict(_cuda.LAUNCHES)
    k1 = sum(c for n, c in counts.items() if n.startswith("k1_"))
    block = "k2_point_block_apply" if name == "point" else "k2_line_block_apply"
    k2 = counts.get(block, 0)
    log(f"{name} layer step: median {statistics.median(ts):.4f} s (min {min(ts):.4f}, max "
        f"{max(ts):.4f}) over 3; forward FGMRES iters {sorted(its)}, rel_rnorm max "
        f"{max(rels):.4e}; launches in the 3 steps {counts} (K1 {k1}, K2 {k2})")
    stray = [n for n in counts if n.startswith(("k2_", "k3_")) and n != block]
    if k2 == 0 or stray:
        raise AssertionError(f"{name} layer step: block applies {counts}, want {block} only")
    if name in ("factored", "evolution") and k1:
        raise AssertionError(f"{name} layer step launched K1 {k1} times (the factored operator "
                             "has no stencil fields)")
    if name in ("point", "jacobi") and not k1:
        raise AssertionError(f"{name} layer step launched no K1")
    if name == "factored" and not max(rels) <= 2 * stencil_rel:
        raise AssertionError(f"factored forward rel_rnorm {max(rels):.3e} above 2x the stencil "
                             f"operator's {stencil_rel:.3e} (the same AtA)")
    if name == "factored":
        profile_v_cycle(layer, c0, r0, i0, steps)
    return counts, layer


# ---------------------------------------------------------------------------
# phase 16c: parallel/ (several processes on the card)
# ---------------------------------------------------------------------------

def point_layer(dev, bs=32, dims=(8, 32, 32), mesh=None):
    """The b30c4rm layer with point blocks (phase 16's option), sp-sharded
    over `mesh` when given."""
    return b30c4rm_layer(dev, "f32", bs, dims, mesh=mesh, mg_block_smoother="point")


def layer_step(layer, c0, r0, i0, steps):
    """Forward + IFT backward of sum(u0^2): (u0, forward stats, gradients
    w.r.t. coefficients and rhs)."""
    c = c0.clone().requires_grad_(True)
    r = r0.clone().requires_grad_(True)
    u0, _, stats = layer(c, r, i0, steps)
    (u0**2).sum().backward()
    return u0.detach(), stats, (c.grad, r.grad)


# the dp step's solver budget: the b30c4rm layer's, with a float64 outer
# FGMRES run to convergence (at b30c4rm's own f32 budget the gradients follow
# rounding: a 1e-7 change of the inputs moves them by up to 1e-1, and one
# Adam step turns that into sign flips of whole parameters)
DP_BUDGET = dict(mg_solve_dtype="solver", mg_fgmres_tol=1e-12,
                 mg_fgmres_max_iter_forward=150, mg_fgmres_restarts_forward=50,
                 mg_fgmres_max_iter_backward=150, mg_fgmres_restarts_backward=50)


def dp_gl_loss(pnet, layer, patches, stats=None):
    """The dry run's multigrid loss at the GL layer: the three ParamNet
    outputs c scale the terms of the benchmark equation u_t - u - u_xx -
    u_yy (by 1 + 0.1 c), the boundary values are the patches', and the loss
    is mean |u0 - patches|.  (The dry run's own map onto orders 1, 2 and 4
    makes the GL grid's system one that 30 f32 FGMRES iterations leave at
    rel_rnorm ~5e-2, where the result follows rounding.)"""
    from mech_nn_discovery_pde_torch.discovery.ginzburg_landau import GLDiscovery
    from mech_nn_discovery_pde_torch.parallel import dryrun

    bs, dims = patches.shape[0], tuple(patches.shape[1:])
    c = 1.0 + 0.1 * pnet().reshape(-1)[:3]
    coeffs = c.new_zeros((bs, layer.grid_size, layer.n_orders))
    coeffs[..., 0] = -c[0]
    coeffs[..., 1] = 1.0
    coeffs[..., 5] = -c[1]
    coeffs[..., 6] = -c[2]
    rhs = c.new_zeros((bs, layer.grid_size))
    u0, _, st = layer(coeffs, rhs, dryrun.iv_from_field(patches, GLDiscovery.IV_LIST, dims),
                      dryrun.steps_for(bs, dims, patches.device, h=0.1))
    if stats is not None:
        stats.append(float(st["rel_rnorm"].max()))
    return (u0.reshape(bs, -1) - patches.reshape(bs, -1)).abs().mean()


def dp_gl_step(dev, seed, mesh=None, bs=32, dims=(8, 32, 32), scale=1.0):
    """The dry run's multigrid training step (ParamNet -> coefficients ->
    MultigridLayer -> loss -> Adam 1e-4; `dp_gl_loss`) at the b30c4rm layer
    with DP_BUDGET, the batch of `bs` patches (times `scale`) split over the
    mesh's dp axis (mesh None: the whole batch in one process).  Returns
    (the global loss, the parameters after the step, the step's seconds, the
    forward rel_rnorm max)."""
    from mech_nn_discovery_pde_torch.parallel import dryrun
    from mech_nn_discovery_pde_torch.parallel.mesh import shard_batch

    g = torch.Generator(device="cpu").manual_seed(seed + 9)
    patches = 0.1 * scale * torch.randn((bs,) + dims, generator=g, dtype=torch.float64).to(dev)
    if mesh is not None:
        patches = shard_batch(mesh, patches)
    layer = b30c4rm_layer(dev, "f32", patches.shape[0], dims, **DP_BUDGET)
    pnet = dryrun.mg_pnet(dev, seed=7)
    opt = torch.optim.Adam(pnet.parameters(), lr=1e-4)
    rel = []
    loss_fn = lambda: dp_gl_loss(pnet, layer, patches, rel)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if mesh is None:
        loss = loss_fn()
        loss.backward()
        opt.step()
        loss = float(loss.detach())
    else:
        loss = dryrun.train_step(loss_fn, list(pnet.parameters()), opt, mesh)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return loss, {k: v.detach().cpu() for k, v in pnet.state_dict().items()}, dt, rel[0]


def params_err(a, b) -> float:
    """Max-abs difference of two parameter sets over the larger magnitude in
    b, all tensors together (a tensor initialised to zero, such as a bias,
    holds +-lr after one Adam step, so its own relative error measures only
    Adam's eps region for its smallest gradients)."""
    return max(abs_err(a[k], b[k]) for k in b) / max(float(b[k].abs().max()) for k in b)


def sharded_matvec_check(mesh, layer, c0, r0, i0, steps, dev):
    """(a) on this rank: the sharded apply at the layer's fine level in f32
    and f64 against single-process K1 on the whole grid (this rank's rows;
    1e-6 and 1e-12 relative), and K1 with the output window against its
    plain version on the rank's slab (1e-6)."""
    from mech_nn_discovery_pde_torch.ops import normal_stencil as ns
    from mech_nn_discovery_pde_torch.parallel.halo import exchange_halo
    from mech_nn_discovery_pde_torch.parallel.sharded_normal import (
        make_sharded_flat_ops, shard_layout, slab_desc)

    with torch.no_grad():
        values, _, _ = layer._prepare(c0, r0, i0, steps)
    sys0, desc = layer.system, layer.mg_solver.descs[0]
    group = mesh.get_group("sp")
    lay = shard_layout(desc, group)
    extend, apply_ = make_sharded_flat_ops(mesh, desc)
    m = desc.n_mi
    vars_ = slice(lay.points.start * m, lay.points.stop * m)
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((layer.bs, sys0.num_vars), generator=g, device=dev, dtype=torch.float64)
    out = {}
    for name, dt, tol in (("f32", torch.float32, 1e-6), ("f64", torch.float64, 1e-12)):
        coef = ns.build_normal_coef(sys0.spec, desc, sys0.split_values(values.to(dt)))
        xd = x.to(dt)
        want = ns.stencil_apply(desc, coef, xd)[:, vars_]
        coef_h = extend(coef[:, :, lay.points].contiguous())
        got = apply_(coef_h, xd[:, vars_].contiguous())
        out[f"matvec_{name}_err"] = rel_err(got, want)
        if not out[f"matvec_{name}_err"] <= tol:
            raise AssertionError(f"sharded matvec {name}: {out[f'matvec_{name}_err']:.3e} > {tol}")
        if name == "f32":
            xh = exchange_halo(xd[:, vars_].reshape(layer.bs, lay.n_loc, -1), group, axis=1)
            xh = xh.reshape(layer.bs, -1)
            sdesc, window = slab_desc(desc, lay), (4 * lay.R, lay.n_loc * lay.R)
            e = rel_err(ns.stencil_apply(sdesc, coef_h, xh, window=window),
                        ns.stencil_apply_plain(sdesc, coef_h, xh, window=window))
            out["window_vs_plain_err"] = e
            if not e <= 1e-6:
                raise AssertionError(f"K1 window vs plain on the slab: {e:.3e}")
    return out


def parallel_rank(rank, n_procs, dev, task, seed, bs=32, dims=(8, 32, 32)):
    """One rank of phase 16c.  task 'gloo': (a) the sharded matvec, (b) the
    sharded point layer step (sp 2), (c) the dp 2 training step; 'nccl':
    (d) the point layer forward with a mesh of sp 1.  Returns CPU results,
    the launch counts of (b) or (d) (cleared just before, read just after),
    step times and peak memory."""
    from mech_nn_discovery_pde_torch.ops import _cuda
    from mech_nn_discovery_pde_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    res = {"backend": dist.get_backend(), "device": str(dev)}
    if task == "nccl":
        mesh = make_mesh((1, 1), device_type="cuda")
        layer = point_layer(dev, bs, dims, mesh=mesh)
        (c0, r0, i0), steps = bench_inputs(layer, layer.bs, layer.coord_dims, seed, dev)
        with torch.no_grad():
            layer(c0, r0, i0, steps)  # warm-up
            torch.cuda.synchronize()
            _cuda.LAUNCHES.clear()
            _cuda.WINDOW_LAUNCHES.clear()
            t0 = time.perf_counter()
            u0, _, stats = layer(c0, r0, i0, steps)
            torch.cuda.synchronize()
        res.update(forward_s=time.perf_counter() - t0, counts=dict(_cuda.LAUNCHES),
                   window_counts=dict(_cuda.WINDOW_LAUNCHES), u0=u0.cpu(),
                   rel_rnorm=stats["rel_rnorm"].cpu())
        return res

    mesh = make_mesh((1, 2), device_type="cuda")
    layer = point_layer(dev, bs, dims, mesh=mesh)
    (c0, r0, i0), steps = bench_inputs(layer, layer.bs, layer.coord_dims, seed, dev)
    res.update(sharded_matvec_check(mesh, layer, c0, r0, i0, steps, dev))
    with torch.no_grad():
        _, _, hier = layer._prepare(c0, r0, i0, steps)
    res["coef0_bytes"] = hier["levels"][0]["coef"].numel() * 4
    res["binv0_bytes"] = hier["levels"][0]["binv"].numel() * 4
    del hier
    layer_step(layer, c0, r0, i0, steps)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _cuda.LAUNCHES.clear()
    _cuda.WINDOW_LAUNCHES.clear()
    t0 = time.perf_counter()
    u0, stats, (gc, gr) = layer_step(layer, c0, r0, i0, steps)
    torch.cuda.synchronize()
    res.update(step_s=time.perf_counter() - t0, counts=dict(_cuda.LAUNCHES),
               window_counts=dict(_cuda.WINDOW_LAUNCHES),
               max_mem=torch.cuda.max_memory_allocated(dev), u0=u0.cpu(),
               rel_rnorm=stats["rel_rnorm"].cpu(), iters=stats["iters"].cpu(),
               gc=gc.cpu(), gr=gr.cpu())
    del layer
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    loss, params, dt, rel = dp_gl_step(dev, seed, make_mesh((2, 1), device_type="cuda"), bs,
                                       dims)
    res.update(dp_loss=loss, dp_params=params, dp_step_s=dt, dp_rel_rnorm=rel,
               dp_max_mem=torch.cuda.max_memory_allocated(dev))
    return res


def window_row(layer, c0, r0, i0, steps, dev, n_sp=2):
    """K1 with its output window at the sharded apply's shapes (rank 0 of
    sp 2 at the GL fine level: a slab of 12 planes, the window on 4): against
    its plain version and the whole-grid K1's rows, timed beside its bound
    and a CSR product over the window's rows.  One process, the card to
    itself.  Returns the kernels-line row."""
    from mech_nn_discovery_pde_torch.ops import normal_stencil as ns
    from mech_nn_discovery_pde_torch.parallel.halo import HALO

    with torch.no_grad():
        values, _, _ = layer._prepare(c0, r0, i0, steps)
    sys0, desc = layer.system, layer.mg_solver.descs[0]
    coef = ns.build_normal_coef(sys0.spec, desc, sys0.split_values(values.float()))
    bs, NC, N = coef.shape
    m, d0 = desc.n_mi, desc.coord_dims[0]
    R, n_loc = N // d0, d0 // n_sp
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((bs, N * m), generator=g, device=dev)
    zc = coef.new_zeros((bs, NC, HALO * R))
    zx = x.new_zeros((bs, HALO * R * m))
    n_slab = (n_loc + 2 * HALO) * R
    coef_h = torch.cat([zc, coef, zc], dim=2)[:, :, :n_slab].contiguous()
    xh = torch.cat([zx, x, zx], dim=1)[:, : n_slab * m].contiguous()
    sdesc = desc._replace(coord_dims=(n_loc + 2 * HALO,) + desc.coord_dims[1:], grid_size=n_slab)
    window = (HALO * R, n_loc * R)
    y_k = ns.stencil_apply(sdesc, coef_h, xh, window=window)
    y_p = ns.stencil_apply_plain(sdesc, coef_h, xh, window=window)
    check("K1 window vs plain (slab of rank 0, sp 2)", rel_err(y_k, y_p), 1e-6)
    check("K1 window vs whole-grid K1 rows", rel_err(y_k, ns.stencil_apply(desc, coef, x)
                                                    [:, : n_loc * R * m]), 1e-6)
    A_w = stencil_csr(sdesc, coef_h, window)
    xcol = xh.reshape(-1, 1)
    lib = lambda: torch.sparse.mm(A_w, xcol)
    check("K1 window vs CSR yardstick", rel_err(lib().reshape(bs, -1), y_k), 1e-5)
    # bytes: the window's fields, the axis-0 band fields of the HALO planes
    # below it (the reversed reads), x on the window and its halo planes,
    # the window's y; 2 flops per field value read
    n_out = n_loc * R
    nb0 = 4 * (1 + 2 * layer.order)  # axis 0's band channels
    n_bytes = 4 * (bs * NC * n_out + bs * nb0 * HALO * R + bs * n_slab * m + bs * n_out * m)
    bnd, by = bound(n_bytes, 2 * bs * (NC + nb0) * n_out)
    row = dict(slab_points=n_slab, window=list(window), bs=bs,
               max_abs_err=abs_err(y_k, y_p),
               ms=time_ms(lambda: ns.stencil_apply(sdesc, coef_h, xh, window=window)),
               ms_back_to_back=time_ms_back_to_back(
                   lambda: ns.stencil_apply(sdesc, coef_h, xh, window=window)),
               plain_ms=time_ms(lambda: ns.stencil_apply_plain(sdesc, coef_h, xh, window=window)),
               bound_ms=bnd, bound_by=by, library_ms=time_ms(lib),
               whole_grid_ms_back_to_back=time_ms_back_to_back(
                   lambda: ns.stencil_apply(desc, coef, x)))
    log(f"  K1 window: {row['ms']:.4f} ms, back to back {row['ms_back_to_back']:.4f} ms "
        f"(bound {bnd:.4f}, {by}; plain {row['plain_ms']:.4f}; CSR {row['library_ms']:.4f}; "
        f"whole grid back to back {row['whole_grid_ms_back_to_back']:.4f})")
    return row


def phase_parallel(seed, dev, smi):
    """Phase 16c: parallel/ on the card (see the module docstring).  Two
    processes share cuda:0 over gloo (exchanges and reductions staged
    through host memory) for (a) the sharded matvec, (b) the sharded point
    layer step against the unsharded one here, (c) the dp 2 training step
    against one process; then one NCCL process at world size 1 for (d).
    Returns (launch counts of (b) summed over the ranks and of (d), each with
    its windowed K1 count, the K1 window row).  Every check runs; the phase
    fails at its end if any missed.

    The 3.1e-3 bar is b30c4rm's: the point option's own step sits at about
    it (3.11e-3, PERF.md §5), so the sharded step fails it only where the
    unsharded step meets it.  The unsharded step's movement under a 1e-7
    change of its coefficients or rhs is the noise floor of (b): an
    unconverged f32 IFT backward turns such a change into gradient changes
    of order 1e-1."""
    from mech_nn_discovery_pde_torch.parallel.dryrun import spawn_ranks

    missed = []

    def want(ok, msg):
        if not ok:
            log(f"  MISSED: {msg}")
            missed.append(msg)

    t_phase = time.perf_counter()
    layer = point_layer(dev)
    (c0, r0, i0), steps = bench_inputs(layer, layer.bs, layer.coord_dims, seed, dev)
    layer_step(layer, c0, r0, i0, steps)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    u_ref, st_ref, (gc_ref, gr_ref) = layer_step(layer, c0, r0, i0, steps)
    torch.cuda.synchronize()
    ref_s, ref_mem = time.perf_counter() - t0, torch.cuda.max_memory_allocated(dev)
    # the unsharded step's own movement under a 1e-7 change of the
    # coefficients or the rhs, either way: the noise floor of the
    # comparisons below
    pert = [0.0, 0.0, 0.0]
    for cs, rs in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        u_p, _, (gc_p, gr_p) = layer_step(layer, c0 * (1 + cs * 1e-7), r0 * (1 + rs * 1e-7),
                                          i0, steps)
        pert = [max(a, b) for a, b in zip(pert, (rel_err(u_p, u_ref), rel_err(gc_p, gc_ref),
                                                  rel_err(gr_p, gr_ref)))]
        del u_p, gc_p, gr_p
    with torch.no_grad():
        _, _, hier = layer._prepare(c0, r0, i0, steps)
    coef0_bytes = hier["levels"][0]["coef"].numel() * 4
    del hier
    row = window_row(layer, c0, r0, i0, steps, dev)
    del layer
    torch.cuda.empty_cache()
    dp_ref = dp_gl_step(dev, seed)
    dp_pert = dp_gl_step(dev, seed, scale=1 + 1e-7)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = spawn_ranks(parallel_rank, 2, args=("gloo", seed), backend="gloo", device="cuda",
                        timeout_s=600)
    log(f"parallel: 2 gloo processes on {ranks[0]['device']} and {ranks[1]['device']} "
        f"(backend {ranks[0]['backend']}) in {time.perf_counter() - t0:.1f} s")
    for r, res in enumerate(ranks):
        log(f"  rank {r}: matvec f32 err {res['matvec_f32_err']:.3e}, f64 "
            f"{res['matvec_f64_err']:.3e}, K1 window vs plain on its slab "
            f"{res['window_vs_plain_err']:.3e}")
    # (b) the sharded layer step against the unsharded one
    rel_ref = float(st_ref["rel_rnorm"].max())
    log(f"  unsharded point step: {ref_s:.4f} s, max memory {ref_mem / 2**30:.3f} GiB, "
        f"rel_rnorm max {rel_ref:.4e}; under coefficients or rhs x (1 +- 1e-7) it moves u0 by "
        f"up to "
        f"{pert[0]:.3e}, the coefficient gradient {pert[1]:.3e}, the rhs gradient {pert[2]:.3e}")
    counts = {}
    for r, res in enumerate(ranks):
        rel_s = float(res["rel_rnorm"].max())
        eu = rel_err(res["u0"], u_ref.cpu())
        ec, er = rel_err(res["gc"], gc_ref.cpu()), rel_err(res["gr"], gr_ref.cpu())
        log(f"  rank {r} sharded step (sp 2): {res['step_s']:.4f} s, max memory "
            f"{res['max_mem'] / 2**30:.3f} GiB [{smi}; two processes share one card: not a "
            f"scaling figure]; iters {sorted(set(res['iters'].tolist()))}, rel_rnorm max "
            f"{rel_s:.4e}; u0 {eu:.3e}, coefficient gradient {ec:.3e}, rhs gradient {er:.3e} "
            f"from the unsharded step; launches {res['counts']} (windowed K1 "
            f"{res['window_counts']})")
        log(f"  rank {r} stencil fields {res['coef0_bytes'] / 2**20:.2f} MiB "
            f"({res['coef0_bytes'] / coef0_bytes:.3f} x the unsharded {coef0_bytes / 2**20:.2f} "
            f"MiB), point-block inverses {res['binv0_bytes'] / 2**20:.2f} MiB")
        want(rel_s <= 1.2 * rel_ref, f"rank {r}: sharded rel_rnorm {rel_s:.4e} above 1.2 x "
             f"the unsharded {rel_ref:.4e}")
        want(rel_s <= 3.1e-3 or rel_ref > 3.1e-3, f"rank {r}: sharded rel_rnorm {rel_s:.4e} "
             f"above the 3.1e-3 bar the unsharded step meets ({rel_ref:.4e})")
        for what, e, tol, floor in (("u0", eu, 1e-3, pert[0]),
                                    ("coefficient gradient", ec, 2e-2, pert[1]),
                                    ("rhs gradient", er, 2e-2, pert[2])):
            if e > tol:
                log(f"  rank {r}: sharded step {what} {e:.3e} from the unsharded, above its "
                    f"{tol} bar; the unsharded step itself moves {floor:.3e} under a 1e-7 change")
            want(e <= max(tol, 2 * floor), f"rank {r}: sharded step {what} {e:.3e} from the "
                 f"unsharded, above {tol} and above 2x the unsharded step's own movement "
                 f"{floor:.3e} under a 1e-7 change")
        for n, c in res["counts"].items():
            counts[n] = counts.get(n, 0) + c
        for n, c in res["window_counts"].items():
            counts[f"{n}_windowed"] = counts.get(f"{n}_windowed", 0) + c
    want(counts.get("k1_stencil_apply_windowed") and counts.get("k2_point_block_apply"),
         f"sharded step launched no windowed K1 or no K2 point-block kernel: {counts}")
    # (c) dp 2 against one process
    loss1, params1, dt1, rel1 = dp_ref
    e_pert = params_err(dp_pert[1], params1)
    log(f"  dp step, one process (bs 32): loss {loss1:.8f}, {dt1:.4f} s, forward rel_rnorm "
        f"{rel1:.3e}; with the patches x (1 + 1e-7) its parameters move {e_pert:.3e}")
    for r, res in enumerate(ranks):
        e = params_err(res["dp_params"], params1)
        log(f"  rank {r} dp 2 step (bs 16): loss {res['dp_loss']:.8f}, {res['dp_step_s']:.4f} s, "
            f"forward rel_rnorm {res['dp_rel_rnorm']:.3e}, max memory "
            f"{res['dp_max_mem'] / 2**30:.3f} GiB [{smi}; two processes share one card]; "
            f"parameters {e:.3e} from the one-process step")
        want(e <= 1e-5, f"rank {r}: dp 2 parameters {e:.3e} from the one-process step")
    # (d) NCCL at world size 1
    t0 = time.perf_counter()
    (nres,) = spawn_ranks(parallel_rank, 1, args=("nccl", seed), backend="nccl", device="cuda",
                          timeout_s=600)
    rel_n = float(nres["rel_rnorm"].max())
    eu = rel_err(nres["u0"], u_ref.cpu())
    log(f"parallel: 1 process, backend {nres['backend']} on {nres['device']}, in "
        f"{time.perf_counter() - t0:.1f} s: forward with a mesh of sp 1 {nres['forward_s']:.4f} "
        f"s, rel_rnorm max {rel_n:.4e}, u0 {eu:.3e} from the unsharded step; launches "
        f"{nres['counts']} (windowed K1 {nres['window_counts']})")
    want(nres["backend"] == "nccl", f"sp 1 forward ran on {nres['backend']}, not NCCL")
    want(rel_n <= 1.2 * rel_ref and eu <= 1e-3,
         f"NCCL sp 1 forward: rel_rnorm {rel_n:.4e} (unsharded {rel_ref:.4e}), u0 {eu:.3e}")
    ncounts = dict(nres["counts"])
    for n, c in nres["window_counts"].items():
        ncounts[f"{n}_windowed"] = c
    log(f"phase 16c took {time.perf_counter() - t_phase:.1f} s")
    if missed:
        raise AssertionError(f"phase 16c: {len(missed)} checks missed: {missed}")
    return counts, ncounts, row


def time_hierarchy_build(layer, c0, r0, i0, steps, n=5):
    """The hierarchy build (`layer._prepare`) and its level-1 coarse rescale
    timed with the rescale's products as the solver runs them (ELL, each
    value vector packed once) and with COO products in their place (gather +
    index_add), interleaved in one process: median ms of n each."""
    from mech_nn_discovery_pde_torch.ops.system import PDESystem

    mg = layer.mg_solver
    ell = (PDESystem.pack_values, PDESystem.matvec_packed)
    coo = (lambda self, values, adjoint=True: values, PDESystem.matvec_coo)
    ts = {(w, k): [] for w in ("prepare", "rescale") for k in ("ell", "coo")}
    with torch.no_grad():
        for _ in range(n + 1):
            for kind, (pack, mv) in (("ell", ell), ("coo", coo)):
                PDESystem.pack_values, PDESystem.matvec_packed = pack, mv
                try:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    _, _, hier = layer._prepare(c0, r0, i0, steps)
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    lv = hier["levels"]
                    mg._rescale_coarse_values(1, lv[0]["values"], lv[1]["values"])
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                finally:
                    PDESystem.pack_values, PDESystem.matvec_packed = ell
                del hier
                ts[("prepare", kind)].append(t1 - t0)
                ts[("rescale", kind)].append(t2 - t1)
    med = {key: statistics.median(v[1:]) * 1e3 for key, v in ts.items()}
    log(f"hierarchy build: {med[('prepare', 'ell')]} ms with the rescale on ELL, "
        f"{med[('prepare', 'coo')]} ms on COO; the level-1 rescale alone "
        f"{med[('rescale', 'ell')]} ms on ELL, {med[('rescale', 'coo')]} ms on COO "
        f"(median of {n})")


def profile_v_cycle(layer, c0, r0, i0, steps):
    """Where a factored step's time goes, on the unit that makes most of it:
    one preconditioner application (a V-cycle; about 60 a step) on the
    layer's hierarchy, its median host time over 5 and one profiled run:
    device busy time, idle share, kernels by time.  (A whole profiled step
    holds about 230,000 activities, whose trace takes minutes to read.)"""
    from torch.profiler import ProfilerActivity, profile

    mg = layer.mg_solver
    with torch.no_grad():
        values, rhs_vec, hier = layer._prepare(c0, r0, i0, steps)
        r = layer.system.rmatvec_s(values, rhs_vec).float().contiguous()
        ts = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mg.precondition(hier, r)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        dt = statistics.median(ts[1:])
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            mg.precondition(hier, r)
            torch.cuda.synchronize()
    _, busy_us, by_name = kernel_counts(prof)
    log(f"profiler: factored V-cycle {dt * 1e3:.2f} ms (median of 5), device busy "
        f"{busy_us / 1e3:.2f} ms in {sum(c for _, c in by_name.values())} activities, idle "
        f"share {max(0.0, 1 - busy_us / 1e6 / dt):.3f}")
    for kname, (us, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        log(f"  {us / 1e3:10.3f} ms  x{c:6d}  {kname[:90]}")


@contextlib.contextmanager
def line_route():
    """Block applies at nt 1 launch line_block.cu's streamed kernels, as every
    point-block launch did before csrc/point_block.cu (their source is
    unchanged since): the earlier design, timed beside the point kernels in
    the same process."""
    from mech_nn_discovery_pde_torch.ops import fused_smoother as fs

    point_path = fs.point_path
    fs.point_path = lambda nt, bw: False
    try:
        yield
    finally:
        fs.point_path = point_path


ROUTES = {"line": line_route, "point": contextlib.nullcontext}
ROUTE_K2 = {"line": "k2_line_block_apply", "point": "k2_point_block_apply"}


def phase_point_route(seed, layer, dev):
    """Phase 16, continued: the point step (phase 16's layer, inputs and
    budget) with its point blocks on the point-block kernel and, as before
    it, on line_block.cu's streamed K2 at nt 1 (`line_route`).  One step on
    each route at the unperturbed inputs gives its forward rel_rnorm (the
    point route's within 1 % of the line route's: the kernels sum in another
    order) and warms it up; then 2 timed steps each in turns line, point,
    point, line; then one profiled step each: K2's device ms per step, its
    launches, the device's busy time.  Returns the numbers by route."""
    from torch.profiler import ProfilerActivity, profile

    (c0, r0, i0), steps = bench_inputs(layer, layer.bs, layer.coord_dims, seed, dev)

    def step(c):
        c = c.clone().requires_grad_(True)
        r = r0.clone().requires_grad_(True)
        i = i0.clone().requires_grad_(True)
        u0, _, stats = layer(c, r, i, steps)
        (u0**2).sum().backward()
        return stats

    out = {name: {"step_s": []} for name in ROUTES}
    for name, route in ROUTES.items():
        with route():
            out[name]["rel_rnorm"] = float(step(c0)["rel_rnorm"].max())
    for k, name in enumerate(("line", "point", "point", "line")):
        with ROUTES[name]():
            for j in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(c0 + 1e-6 * (2 * k + j + 1))
                torch.cuda.synchronize()
                out[name]["step_s"].append(time.perf_counter() - t0)
    for name, route in ROUTES.items():
        with route():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step(c0)
                torch.cuda.synchronize()
        _, busy_us, by_name = kernel_counts(prof)
        k2 = [(us, c) for e, (us, c) in by_name.items() if ROUTE_K2[name] in e]
        o = out[name]
        o.update(step_s_median=statistics.median(o["step_s"]),
                 k2_device_ms=sum(us for us, _ in k2) / 1e3, k2_launches=sum(c for _, c in k2),
                 device_busy_s=busy_us / 1e6)
        log(f"point step, block applies on {ROUTE_K2[name]}: median {o['step_s_median']:.4f} s "
            f"over 4 ({', '.join(f'{t:.4f}' for t in o['step_s'])}), rel_rnorm max "
            f"{o['rel_rnorm']:.4e}; profiled step: K2 {o['k2_device_ms']:.3f} device ms in "
            f"{o['k2_launches']} launches, device busy {o['device_busy_s']:.4f} s")
    ratio = out["point"]["rel_rnorm"] / out["line"]["rel_rnorm"]
    log(f"point step rel_rnorm, point-block kernel over line kernel: {ratio:.5f}")
    if not abs(ratio - 1) <= 0.01:
        raise AssertionError(f"point step rel_rnorm {out['point']['rel_rnorm']:.4e} not within "
                             f"1 % of the line kernel's {out['line']['rel_rnorm']:.4e}")
    return out


def point_kernels():
    """The point-block kernels by storage mode: (kernels-line key, label,
    apply, plain version, factored)."""
    from mech_nn_discovery_pde_torch.ops import fused_smoother as fs

    return {
        "f32": ("k2_point", "K2 f32", fs.block_apply, fs.block_apply_plain, False),
        "bf16": ("k2_point_bf16", "K2 bf16", fs.block_apply, fs.block_apply_plain, False),
        "bf16_factored": ("k3_point", "K3", fs.factored_block_apply,
                          fs.factored_block_apply_plain, True),
    }


def check_point_kernel(label, kern, plain, blocks, x, b, c1, c2):
    """A point-block kernel (nt 1) against its plain version, plain apply
    and with the Chebyshev epilogue in place (1e-5, the tolerance of K2 and
    K3's checks).  Returns the apply's max-abs error and its result."""
    t_k, t_p = kern(blocks, x, 1), plain(blocks, x, 1)
    check(f"{label} apply", rel_err(t_k, t_p), 1e-5)
    d_k, d_p = b.clone(), b.clone()
    kern(blocks, x, 1, d=d_k, c1=c1, c2=c2)
    plain(blocks, x, 1, d=d_p, c1=c1, c2=c2)
    check(f"{label} Chebyshev epilogue", rel_err(d_k, d_p), 1e-5)
    return abs_err(t_k, t_p), t_k


def graph_ms(run, n=20):
    """Milliseconds per call of n back-to-back calls of run captured in one
    CUDA graph and replayed (median of 10 replays): the device's time per
    launch without the host's, which is the slower below about 0.02 ms."""
    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            run()
    torch.cuda.synchronize()
    return time_ms(graph.replay, n=10, warmup=2) / n


def time_point_kernel(label, kern, plain, blocks, x, t_k, factored):
    """A point-block kernel's times at one shape: alone, back to back and on
    the device alone (`graph_ms`), beside line_block.cu's streamed kernel
    at nt 1 in turns (line, point, point, line; back to back the mean of
    each pair), its plain version, its bmm yardstick (two for K3; checked
    against the kernel) and its bound."""
    bw = blocks.shape[-1]
    run = lambda: kern(blocks, x, 1, d=t_k)  # noqa: E731
    row, b2b = {}, {"line": [], "point": []}
    for name in ("line", "point", "point", "line"):
        pre = "parent_" if name == "line" else ""
        with ROUTES[name]():
            if f"{pre}ms" not in row:
                row[f"{pre}ms"] = time_ms(run)
                row[f"{pre}device_ms"] = graph_ms(run)
            b2b[name].append(time_ms_back_to_back(run))
    row["ms_back_to_back"] = statistics.mean(b2b["point"])
    row["parent_ms_back_to_back"] = statistics.mean(b2b["line"])
    row["plain_ms"] = time_ms(lambda: plain(blocks, x, 1))
    lib, to_vec = block_library_call(blocks, x, 1, bw, factored)
    check(f"{label} {'two-bmm' if factored else 'bmm'} yardstick", rel_err(to_vec(lib()), t_k),
          1e-5)
    row["library_ms"] = time_ms(lib)
    row["library_ms_back_to_back"] = time_ms_back_to_back(lib)
    row["bound_ms"], row["bound_by"] = block_bound(blocks, x.numel(), factored)
    log(f"  {label}: {row['ms']:.4f} ms, back to back {row['ms_back_to_back']:.4f} ms "
        f"({b2b['point'][0]:.4f}, {b2b['point'][1]:.4f}), device {row['device_ms']:.4f} ms; "
        f"bound {row['bound_ms']:.4f} ({row['bound_by']}; "
        f"{row['bound_ms'] / row['ms_back_to_back']:.1%} of it back to back, "
        f"{row['bound_ms'] / row['device_ms']:.1%} on the device); line_block.cu's kernel "
        f"{row['parent_ms']:.4f} ms, back to back {row['parent_ms_back_to_back']:.4f} "
        f"({b2b['line'][0]:.4f}, {b2b['line'][1]:.4f}), device {row['parent_device_ms']:.4f}; "
        f"plain {row['plain_ms']:.4f}; {'two bmm' if factored else 'bmm'} "
        f"{row['library_ms']:.4f}, back to back {row['library_ms_back_to_back']:.4f}")
    return row


def point_forward(layer, mode, seed, dev):
    """One forward of a point layer with `mode` preconditioner storage, the
    entry point its users call, with the launch counts cleared just before
    and read just after: the launches of that storage mode's point-block
    kernel.  u0 must be finite, except under 'bf16' (quality-fatal at GL
    scale; rel_rnorm printed with no bar)."""
    from mech_nn_discovery_pde_torch.ops import _cuda

    (c0, r0, i0), steps = bench_inputs(layer, layer.bs, layer.coord_dims, seed, dev)
    torch.cuda.synchronize()
    _cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    with torch.no_grad():
        u0, _, stats = layer(c0, r0, i0, steps)
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    finite = bool(torch.isfinite(u0).all())
    log(f"point forward, {mode} storage: {time.perf_counter() - t0:.3f} s, launches {counts}, "
        f"rel_rnorm max {float(stats['rel_rnorm'].max()):.4e}, u0 finite: {finite}")
    if not finite and mode != "bf16":
        raise AssertionError(f"point forward, {mode} storage: non-finite u0")
    return counts


# (bs, S, bw): every point width at an item count that no tile divides, and
# fewer items than one tile
POINT_WIDTH_CASES = ((3, 677, 2), (3, 677, 3), (2, 1001, 4), (2, 1001, 5), (3, 1111, 7),
                     (1, 5, 7))


def phase_point_blocks(seed, layer, dev):
    """Phase 16b: the point-block kernels K2 f32, K2 bf16 and K3 (nt 1,
    bw 7) on the blocks of point hierarchies (the f32 one of phase 16's
    layer; 'bf16' and 'bf16_factored' layers built here, each driven by one
    forward whose launch counts are its kernel's path), at the fine level
    (bs 32 x 8192 blocks) and level 1 (2048): each against its plain
    version with and without the epilogue, and timed (`time_point_kernel`).
    Then every kernel at bw 2, 3, 4, 5 and 7 on random SPD blocks at item
    counts no tile divides and below one tile, and at bw 7 on operands at
    offsets that are not 16-byte aligned (the kernels' own load path for
    every tile).  Returns (the kernels-line rows by key, the launch counts
    of the bf16 and bf16_factored forwards)."""
    rows, counts = {}, {}
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    for mode, (key, label, kern, plain, factored) in point_kernels().items():
        lay = layer
        if mode != "f32":
            lay = b30c4rm_layer(dev, mode, layer.bs, layer.coord_dims, mg_block_smoother="point")
            counts[mode] = point_forward(lay, mode, seed, dev)
        (c0, r0, i0), steps = bench_inputs(lay, lay.bs, lay.coord_dims, seed, dev)
        with torch.no_grad():
            _, _, hier = lay._prepare(c0, r0, i0, steps)
        for k in (0, 1):
            blocks = hier["levels"][k]["binv"]
            bs, S, bw, _ = blocks.shape
            want = torch.bfloat16 if mode != "f32" else torch.float32
            if blocks.dtype != want or (bw, lay.mg_solver._block_nt(k)) != (lay.n_orders, 1):
                raise AssertionError(f"{mode} point hierarchy level {k}: blocks {blocks.dtype} "
                                     f"of width {bw}, want {want}, nt 1, bw n_mi")
            if factored and int((blocks.tril(-1) != 0).sum()):
                raise AssertionError(f"stored point W at level {k} is not upper-triangular")
            x = torch.randn((bs, S * bw), generator=g, device=dev)
            b = torch.randn((bs, S * bw), generator=g, device=dev)
            c1 = torch.rand((bs,), generator=g, device=dev)
            c2 = torch.rand((bs,), generator=g, device=dev)
            lbl = f"{label} point blocks (level {k}: bs {bs}, S {S}, bw {bw})"
            err, t_k = check_point_kernel(lbl, kern, plain, blocks, x, b, c1, c2)
            row = time_point_kernel(lbl, kern, plain, blocks, x, t_k, factored)
            if k == 0:
                rows[key] = dict(max_abs_err=err, S=S, bw=bw, **row)
            else:
                rows[key].update({f"{n}_level1": v for n, v in row.items() if n != "bound_by"})
            del x, b, t_k
        del hier, lay
        torch.cuda.empty_cache()
    for bs, S, bw in POINT_WIDTH_CASES:
        binv, W = spd_blocks(bs, S, bw, g, dev)
        x = torch.randn((bs, S * bw), generator=g, device=dev)
        b = torch.randn((bs, S * bw), generator=g, device=dev)
        c1 = torch.rand((bs,), generator=g, device=dev)
        c2 = torch.rand((bs,), generator=g, device=dev)
        for mode, (_, label, kern, plain, _) in point_kernels().items():
            blocks = {"f32": binv, "bf16": binv.to(torch.bfloat16), "bf16_factored": W}[mode]
            check_point_kernel(f"{label} bw {bw}, {bs * S} items", kern, plain, blocks, x, b,
                               c1, c2)
    # bs 1: a slice that drops the first item is contiguous and 196 B (28 B
    # for r) past a 16-byte boundary
    binv, W = spd_blocks(1, 1001, 7, g, dev)
    x = torch.randn((1, 1001 * 7), generator=g, device=dev)[:, 7:]
    b = torch.randn((1, 1000 * 7), generator=g, device=dev)
    c1, c2 = torch.rand((1,), generator=g, device=dev), torch.rand((1,), generator=g, device=dev)
    for mode, (_, label, kern, plain, _) in point_kernels().items():
        blocks = {"f32": binv, "bf16": binv.to(torch.bfloat16), "bf16_factored": W}[mode][:, 1:]
        if blocks.data_ptr() % 16 == 0 or not blocks.is_contiguous() or not x.is_contiguous():
            raise AssertionError("unaligned point case: operands aligned or not contiguous")
        check_point_kernel(f"{label} bw 7, operands off 16-byte alignment", kern, plain, blocks,
                           x, b, c1, c2)
    torch.cuda.synchronize()
    return rows, counts


def phase_krylov(layer, hier, values, rhs_vec, dev, iters=60):
    """Phase 18: the other Krylov solvers at the fine level of phase 3's
    hierarchy (bs 32, 57,344 unknowns) with K1 f32 as AtA, b = A^T rhs:
    cg, minres, gmres (restart 30), lgmres (restart 20) and cg_block for a
    fixed 60 iterations (tol 0), and cg_normal on the structured A and A^T.
    Each: the true residual ||b - AtA x|| (K1) finite and below ||b||, and
    within 10 % of the reported one where the solver reports a true
    residual (gmres, lgmres); cg_block's x within 1e-3 of cg's.  Prints ms
    per iteration.  Returns the launch counts of the solves."""
    from mech_nn_discovery_pde_torch.ops import _cuda
    from mech_nn_discovery_pde_torch.ops.normal_stencil import stencil_apply
    from mech_nn_discovery_pde_torch.solvers import krylov

    mg, sys0 = layer.mg_solver, layer.system
    desc, coef = mg.descs[0], hier["levels"][0]["coef"]
    v32 = values.float()
    A = lambda v: stencil_apply(desc, coef, v)  # noqa: E731
    b = sys0.rmatvec_s(v32, rhs_vec.float()).contiguous()
    bn = torch.linalg.vector_norm(b, dim=1)
    kw = dict(maxiter=iters, tol=0.0)
    solvers = {
        "cg": lambda: krylov.cg(A, b, **kw),
        "minres": lambda: krylov.minres(A, b, **kw),
        "gmres": lambda: krylov.gmres(A, b, restart=30, atol=0.0, **kw),
        "lgmres": lambda: krylov.lgmres(A, b, restart=20, atol=0.0, **kw),
        "cg_block": lambda: krylov.cg_block(A, b, **kw),
        "cg_normal": lambda: krylov.cg_normal(lambda x: sys0.matvec_s(v32, x),
                                              lambda y: sys0.rmatvec_s(v32, y), b, **kw),
    }
    torch.cuda.synchronize()
    _cuda.LAUNCHES.clear()
    xs = {}
    for name, solve in solvers.items():
        t0 = time.perf_counter()
        res = solve()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        x, rep_rn = (res[0], res[1]) if name == "cg_block" else (res.x, res.rnorm)
        xs[name] = x
        true_rn = torch.linalg.vector_norm(b - A(x), dim=1)
        ratio = true_rn / bn
        log(f"  {name}: {dt / iters * 1e3:.3f} ms per iteration; true rel residual max "
            f"{float(ratio.max()):.4e} mean {float(ratio.mean()):.4e}; reported/true max "
            f"{float((rep_rn / true_rn).max()):.4f} min {float((rep_rn / true_rn).min()):.4f}")
        if not (bool(torch.isfinite(true_rn).all()) and bool((true_rn < bn).all())):
            raise AssertionError(f"krylov {name}: true residual not finite or not below ||b||")
        if name in ("gmres", "lgmres") and not float((rep_rn / true_rn - 1).abs().max()) <= 0.1:
            raise AssertionError(f"krylov {name}: reported residual not within 10 % of the true one")
    counts = dict(_cuda.LAUNCHES)
    check("cg_block vs cg x", rel_err(xs["cg_block"], xs["cg"]), 1e-3)
    log(f"krylov launches {counts}")
    if counts.get("k1_stencil_apply", 0) == 0:
        raise AssertionError("krylov solvers launched no K1")
    return counts


def phase_native(dev):
    """Phase 19: the native pair-table builder (ops/native.py, built with
    g++ into _build/) must load; the GL fine system's tables equal its NumPy
    twin's exactly.  Prints both times (host)."""
    import numpy as np

    from mech_nn_discovery_pde_torch.discovery.ginzburg_landau import GLDiscovery
    from mech_nn_discovery_pde_torch.ops import native
    from mech_nn_discovery_pde_torch.ops.system import PDESystem

    t0 = time.perf_counter()
    ok = native.available()
    log(f"native library: available {ok} ({time.perf_counter() - t0:.2f} s to build and load)")
    if not ok:
        raise AssertionError(f"native library did not load: {native.error()}")
    sys0 = PDESystem.build((8, 32, 32), order=2, init_index_mi_list=GLDiscovery.IV_LIST,
                           step_size=0.01)
    t0 = time.perf_counter()
    got = native.build_pairs_sorted(sys0.rows_all, sys0.cols_all, sys0.num_vars)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = native.pairs_sorted_numpy(sys0.rows_all, sys0.cols_all, sys0.num_vars)
    t_numpy = time.perf_counter() - t0
    if not all(np.array_equal(a, w) for a, w in zip(got, want)):
        raise AssertionError("native pair tables differ from NumPy's")
    log(f"native pair tables (GL fine level, {len(got[0])} pairs) equal NumPy's: native "
        f"{t_native:.3f} s, NumPy {t_numpy:.3f} s")


def phase_bf16_forward(seed, dev, bs=32, dims=(8, 32, 32), downsample_first=False,
                       level_blocks=None):
    """Phase 5: one forward of b30c4rm with all-bf16 preconditioner storage,
    with the launch counts cleared just before and read just after: K1's
    bf16-field variant and K2's bf16 one must launch (phase 5b: the
    kernels `level_blocks` gives each level, and no other block kernel
    there).  Returns the launch counts of that forward, the layer and the
    block applies' launches by level."""
    from mech_nn_discovery_pde_torch.ops import _cuda

    layer = b30c4rm_layer(dev, "bf16", bs, dims, downsample_first=downsample_first)
    (c0, r0, i0), steps = bench_inputs(layer, bs, dims, seed, dev)
    torch.cuda.synchronize()
    _cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    with torch.no_grad(), launches_by_level(layer) as by_level:
        u0, _, stats = layer(c0, r0, i0, steps)
        torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    rel = stats["rel_rnorm"]
    log(f"bf16 forward {dims} {time.perf_counter() - t0:.3f} s: launches {counts}; block "
        f"applies by level { {k: dict(v) for k, v in sorted(by_level.items())} }; FGMRES "
        f"iters {sorted(set(stats['iters'].tolist()))}, rel_rnorm max {float(rel.max()):.4e} "
        f"mean {float(rel.mean()):.4e} (no bar: quality-fatal at GL scale)")
    if not bool(torch.isfinite(u0).all()):
        raise AssertionError("bf16 forward: non-finite u0")
    blocks = (tuple(n for v in level_blocks.values() for n in v) if level_blocks
              else ("k2_line_block_apply_bf16",))
    for n in ("k1_stencil_apply_bf16", *blocks):
        if counts.get(n, 0) == 0:
            raise AssertionError(f"bf16 forward did not launch {n}")
    for k, want in (level_blocks or {}).items():
        if set(by_level.get(k, {})) != set(want):
            raise AssertionError(f"bf16 forward: level {k} block applies "
                                 f"{dict(by_level.get(k, {}))}, want {want}")
    return counts, layer, {k: dict(v) for k, v in by_level.items()}


def level_kernel(layer, c0, r0, i0, steps, mode, seed, dev, level=0):
    """The long-window layer's block kernel at one level at the main path's
    shapes: the blocks the layer's hierarchy stores there (bw 350, bs x 1024
    lines at the fine level; bw 175, bs x 256 lines at level 1; B^-1 in f32
    or bf16, or W), against its plain version with and without the epilogue
    (1e-5) and its bmm yardstick, then timed (`time_line_kernel`)."""
    from mech_nn_discovery_pde_torch.ops import _cuda
    from mech_nn_discovery_pde_torch.ops import fused_smoother as fs

    with torch.no_grad():
        _, _, hier = layer._prepare(c0, r0, i0, steps)
    blocks = hier["levels"][level]["binv"]
    del hier
    nt = layer.mg_solver.dim_list[level][0]
    bs, S, bw, _ = blocks.shape
    m, n = bw // nt, nt * S * (bw // nt)
    g = torch.Generator(device=dev).manual_seed(seed + 6 + level)
    x = torch.randn((bs, n), generator=g, device=dev)
    b = torch.randn((bs, n), generator=g, device=dev)
    c1 = torch.rand((bs,), generator=g, device=dev)
    c2 = torch.rand((bs,), generator=g, device=dev)
    factored = mode == "bf16_factored"
    name, _, kern, plain, _ = line_kernels()[2 if factored else 1 if mode == "bf16" else 0]
    geo = fs.line_block_geometry(bs, S, bw, blocks.element_size(), _cuda.sm_count(dev),
                                 factored)
    label = (f"{name} ({geo.route}) on the long window's "
             f"{'fine level' if level == 0 else f'level {level}'} (bs {bs}, {S} lines of {bw}^2)")
    resident = resident_clusters(geo) if geo.route == "cluster" else None
    log(f"  {label}: {geo}" + (f"; {resident} clusters resident at once" if resident else ""))
    t_k, err = check_line_kernel(label, kern, plain, blocks, x, b, c1, c2, nt)
    lib, to_vec = block_library_call(blocks, x, nt, m, factored)
    check(f"{label} {'two-bmm' if factored else 'bmm'} yardstick", rel_err(to_vec(lib()), t_k),
          1e-5)
    kernels = fs._K3_FN if factored else fs._K2_FN[blocks.dtype]
    row = dict(kernel=kernels.line_counted[geo.route], max_abs_err=err, bw=bw, lines=S, bs=bs,
               path=geo.route, panel_rows=geo.panel_rows, cluster=geo.cluster,
               stages=geo.stages, ctas=geo.ctas, resident_clusters=resident)
    row.update(time_line_kernel(label, lambda: kern(blocks, x, nt, d=t_k),
                                lambda: plain(blocks, x, nt), lib, blocks, bs * n, factored))
    return row


# the long-window step's forward rel_rnorm bar: 7 % above the 4.65e-3 (f32
# storage) and 4.68e-3 ('bf16_factored') both modes reach at --seed 0 on an
# H100 after their 30 FGMRES iterations (the GL bar, 3.1e-3, is for
# (8, 32, 32) patches); the row-tiled kernels move it by 0.01 %
LONG_REL_BAR = 5.0e-3


# the block applies' device ms a long-window step at level 1 with the
# streamed kernels of the parent design (bw 175 blocks copied by one warp's
# plain loads; NVIDIA H100 80GB HBM3, 700.00 W), beside which phase 5b
# prints this design's
LEVEL1_BEFORE_MS = {"f32": 866.0, "bf16_factored": 789.0}


def phase_long_window(seed, dev, bs=8, dims=(50, 32, 32)):
    """Phase 5b: the GL layer step with a long time window, (50, 32, 32)
    patches at n_grid 3 with MultigridLayer's default downsample_first=True
    (levels (50, 32, 32), (25, 16, 16), (12, 8, 8): time-line blocks of bw
    350 at the fine level and 175 at level 1; the coarsest a dense solve),
    bs 8, the b30c4rm solver settings.  In f32 storage (K2 on panels at
    both levels) and 'bf16_factored' (K3 on a cluster at both levels):
    `time_layer_step` (3 timed runs; rel_rnorm at most LONG_REL_BAR; at
    each level the kernels LONG_BLOCK_KERNEL gives it; the block applies'
    device ms by level, level 1's beside LEVEL1_BEFORE_MS), the peak memory,
    and the kernel of each level at the main path's shapes (`level_kernel`).
    Then one all-'bf16' forward (K2 bf16 on panels at the fine level,
    streamed at level 1) and its kernels at both levels.  Returns (kernel
    rows by key: the fine level's by kernel, level 1's as
    "level1_<storage mode>"; launch counts by storage mode; level 1's launch
    counts by storage mode; the steps' numbers)."""
    t_phase = time.perf_counter()
    rows, counts, level1, steps_out = {}, {}, {}, {}
    for precond, key in (("f32", "k2_panels"), ("bf16_factored", "k3_cluster")):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        layer = b30c4rm_layer(dev, precond, bs, dims, downsample_first=True)
        (c0, r0, i0), steps = bench_inputs(layer, bs, dims, seed, dev)
        mg = layer.mg_solver
        m = layer.system.var_set.n_mi
        log(f"long-window layer ({precond} storage) built in {time.perf_counter() - t0:.2f} s: "
            f"levels {mg.dim_list}, line blocks of bw "
            f"{[d[0] * m for d in mg.dim_list[:-1]]}; {layer.system.describe()}")
        label = f"long-window {precond} layer step (bs {bs}, {dims})"
        levels = LONG_BLOCK_KERNEL[precond]
        blocks = tuple(sorted({n for v in levels.values() for n in v}))
        res = time_layer_step(layer, c0, r0, i0, steps, label, blocks, rel_bar=LONG_REL_BAR,
                              level_blocks=levels, runs=3)
        res["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"{label}: peak memory {res['peak_memory_gib']:.3f} GiB; level 1's block applies "
            f"{res['block_ms_by_level'].get(1, 0.0):.1f} ms of device time a step (the streamed "
            f"kernels of the parent design: {LEVEL1_BEFORE_MS[precond]} ms)")
        rows[key] = level_kernel(layer, c0, r0, i0, steps, precond, seed, dev)
        rows[f"level1_{precond}"] = level_kernel(layer, c0, r0, i0, steps, precond, seed, dev, 1)
        counts[precond], steps_out[precond] = res["counts"], res
        level1[precond] = res["by_level"].get(1, {})
        del layer, mg
    torch.cuda.empty_cache()
    levels = LONG_BLOCK_KERNEL["bf16"]
    counts["bf16"], layer, by_level = phase_bf16_forward(seed, dev, bs, dims,
                                                         downsample_first=True,
                                                         level_blocks=levels)
    level1["bf16"] = by_level.get(1, {})
    (c0, r0, i0), steps = bench_inputs(layer, bs, dims, seed, dev)
    rows["k2_panels_bf16"] = level_kernel(layer, c0, r0, i0, steps, "bf16", seed, dev)
    rows["level1_bf16"] = level_kernel(layer, c0, r0, i0, steps, "bf16", seed, dev, 1)
    del layer
    torch.cuda.empty_cache()
    log(f"phase 5b took {time.perf_counter() - t_phase:.1f} s")
    return rows, counts, level1, steps_out


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


def spd_blocks(bs, S, bw, g, dev):
    """Random SPD blocks A (bs, S, bw, bw): their inverses (K2's operand)
    and the factors W = L^-T, exactly upper triangular (K3's, in bf16)."""
    M = torch.randn((bs, S, bw, bw), generator=g, device=dev, dtype=torch.float64)
    A = M @ M.transpose(-1, -2) / bw + torch.eye(bw, device=dev, dtype=torch.float64)
    L = torch.linalg.cholesky(A)
    eye = torch.eye(bw, device=dev, dtype=torch.float64).expand_as(A)
    linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return (torch.cholesky_inverse(L).float().contiguous(),
            linv.transpose(-1, -2).triu().to(torch.bfloat16).contiguous())


def block_library_call(blocks, x, nt, m, factored):
    """The PyTorch call computing a time-line block apply, on an f32 copy of
    the blocks (bs, S, bw, bw): one bmm for B^-1 r (K2), two for W (W^T r)
    (K3: no single call computes it).  Returns (call, to_vec): the call
    gives the (bs*S, bw, 1) blocks of the result, to_vec lays them out as
    the kernels' (bs, n) vector (for the check, outside the timing)."""
    from mech_nn_discovery_pde_torch.ops import fused_smoother as fs

    bs, S, bw, _ = blocks.shape
    B = blocks.float().reshape(bs * S, bw, bw)
    rb = fs.line_vec_to_blocks(x, nt, m).reshape(bs * S, bw, 1).contiguous()
    if factored:
        Bt = B.transpose(1, 2)
        call = lambda: torch.bmm(B, torch.bmm(Bt, rb))  # noqa: E731
    else:
        call = lambda: torch.bmm(B, rb)  # noqa: E731
    return call, lambda z: fs.line_blocks_to_vec(z.reshape(bs, S, bw), nt, m)


def time_line_kernel(label, run, plain, lib, blocks, n_vec, factored):
    """A line-block kernel's times at one shape: alone, back to back and on
    the device alone (`graph_ms`); its plain version; its library yardstick
    (one bmm, two for K3); its bound (`block_bound`: the blocks, r read,
    the result written)."""
    row = dict(ms=time_ms(run), device_ms=graph_ms(run), ms_back_to_back=time_ms_back_to_back(run),
               plain_ms=time_ms(plain), library_ms=time_ms(lib),
               library_ms_back_to_back=time_ms_back_to_back(lib))
    row["bound_ms"], row["bound_by"] = block_bound(blocks, n_vec, factored)
    log(f"  {label}: {row['ms']:.4f} ms, back to back {row['ms_back_to_back']:.4f} ms, device "
        f"{row['device_ms']:.4f}; bound {row['bound_ms']:.4f} ({row['bound_by']}; "
        f"{row['bound_ms'] / row['ms_back_to_back']:.1%} of it back to back, "
        f"{row['bound_ms'] / row['device_ms']:.1%} on the device); plain "
        f"{row['plain_ms']:.4f}; {'two bmm' if factored else 'bmm'} {row['library_ms']:.4f}, "
        f"back to back {row['library_ms_back_to_back']:.4f}")
    return row


def line_kernels():
    """K2 f32, K2 bf16 and K3 on the line blocks: (label, key, apply, plain
    version, factored), the key that of the kernels line."""
    from mech_nn_discovery_pde_torch.ops import fused_smoother as fs

    return (("K2 f32", "k2", fs.block_apply, fs.block_apply_plain, False),
            ("K2 bf16", "k2_bf16", fs.block_apply, fs.block_apply_plain, False),
            ("K3", "k3", fs.factored_block_apply, fs.factored_block_apply_plain, True))


def resident_clusters(geo) -> int:
    """For the cluster kernel's geometry: the clusters the card holds at once
    (the launcher caps the grid at it; csrc/line_block.cu
    k3_cluster_occupancy)."""
    import ctypes

    from mech_nn_discovery_pde_torch.ops import _cuda

    fn = _cuda.library("line_block").k3_cluster_occupancy
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    n = fn(geo.cluster, geo.smem_bytes)
    if n < 1:
        raise AssertionError(f"k3_cluster_occupancy({geo.cluster}, {geo.smem_bytes}) = {n}")
    return n


def check_line_kernel(label, kern, plain, blocks, x, b, c1, c2, nt, tol=1e-5):
    """A line-block kernel against its plain version, alone and with the
    Chebyshev epilogue; returns (kernel's t, its max-abs error)."""
    t_k, t_p = kern(blocks, x, nt), plain(blocks, x, nt)
    check(f"{label} apply", rel_err(t_k, t_p), tol)
    d_k, d_p = b.clone(), b.clone()
    kern(blocks, x, nt, d=d_k, c1=c1, c2=c2)
    plain(blocks, x, nt, d=d_p, c1=c1, c2=c2)
    check(f"{label} Chebyshev epilogue", rel_err(d_k, d_p), tol)
    return t_k, abs_err(t_k, t_p)


# (nt, m, S, timed): bw 280 and 350 at bs 2 x 64 lines, timed; the others
# for correctness only: bw 245 and 345, whose blocks are aligned to 4 or 2
# bytes (the two-sweep load path's units; the panel copy's head and tail);
# bw 406, where K3's cluster grows to 6 CTAs (350 and 345: 4, neither a
# multiple of the cluster, the last CTA's rows partial); bw 980, K3 past
# the cluster (the two-sweep kernel) and K2 at panels of 8 and 16 rows
WIDE_SHAPES = ((40, 7, 64, True), (50, 7, 64, True), (35, 7, 6, False), (69, 5, 6, False),
               (58, 7, 6, False), (140, 7, 2, False))


def phase_wide_blocks(dev, seed, bs=2):
    """Phase 2d: K2 (f32 and bf16 inverses) and K3 at time-line blocks wider
    than the streamed path holds, against their plain versions with and
    without the Chebyshev epilogue (1e-5), random SPD blocks from --seed, at
    WIDE_SHAPES: each launch's kernel (`route`) is the one its shape gives
    (`line_block_route`): the panel kernel (K2), the cluster kernel (K3 to
    bw 916) or the two-sweep one (K3 beyond).  bw 280 and 350 are timed
    (`time_line_kernel`): alone, back to back and on the device, beside
    their bound (`block_bound`), their plain version and their bmm
    yardstick (two for K3), also on random blocks of 4 x S lines, a working
    set beyond L2 ("*_4S"; the S-line blocks stay in L2 between
    back-to-back launches).  Returns the timed rows, each with its route."""
    from mech_nn_discovery_pde_torch.ops import _cuda
    from mech_nn_discovery_pde_torch.ops import fused_smoother as fs

    g = torch.Generator(device=dev).manual_seed(seed + 4)
    rows = []
    for nt, m, S, timed in WIDE_SHAPES:
        bw = nt * m
        n = nt * S * m
        x = torch.randn((bs, n), generator=g, device=dev)
        b = torch.randn((bs, n), generator=g, device=dev)
        c1 = torch.rand((bs,), generator=g, device=dev)
        c2 = torch.rand((bs,), generator=g, device=dev)
        binv, W = spd_blocks(bs, S, bw, g, dev)
        operands = {"k2": binv, "k2_bf16": binv.to(torch.bfloat16), "k3": W}
        for name, key, kern, plain, factored in line_kernels():
            blocks = operands[key]
            geo = fs.line_block_geometry(bs, S, bw, blocks.element_size(), _cuda.sm_count(dev),
                                         factored)
            if geo.route != fs.line_block_route(bw, geo.panel_rows, factored):
                raise AssertionError(f"{name} bw {bw}: geometry {geo} off its shape's route")
            label = f"{name} bw {bw} ({geo.route})"
            resident = resident_clusters(geo) if geo.route == "cluster" else None
            log(f"  {label}: {geo}" + (f"; {resident} clusters resident at once of the "
                                       f"{geo.ctas // geo.cluster} asked" if resident else ""))
            _cuda.LAUNCHES.clear()
            t_k, err = check_line_kernel(label, kern, plain, blocks, x, b, c1, c2, nt)
            torch.cuda.synchronize()
            kernels = fs._K3_FN if factored else fs._K2_FN[blocks.dtype]
            if dict(_cuda.LAUNCHES) != {kernels.line_counted[geo.route]: 2}:
                raise AssertionError(f"{label}: launches {dict(_cuda.LAUNCHES)}, want 2 of "
                                     f"{kernels.line_counted[geo.route]}")
            if not timed:
                continue
            lib, to_vec = block_library_call(blocks, x, nt, m, factored)
            check(f"{label} {'two-bmm' if factored else 'bmm'} yardstick",
                  rel_err(to_vec(lib()), t_k), 1e-5)
            row = dict(kernel=key, bw=bw, route=geo.route, panel_rows=geo.panel_rows,
                       cluster=geo.cluster, stages=geo.stages, ctas=geo.ctas, bulk=geo.bulk,
                       resident_clusters=resident, max_abs_err=err)
            row.update(time_line_kernel(label, lambda: kern(blocks, x, nt, d=t_k),
                                        lambda: plain(blocks, x, nt), lib, blocks, bs * n,
                                        factored))
            del lib
            # the same launch on random blocks of 4 x S lines: 80 MB or more,
            # beyond the 50 MB L2, which holds the S-line blocks (20-40 MB
            # at bw 280) across back-to-back launches
            big = torch.randn((bs, 4 * S, bw, bw), generator=g, device=dev)
            big = (big.triu() if factored else big).to(blocks.dtype)
            xb = torch.randn((bs, 4 * n), generator=g, device=dev)
            t_big = kern(big, xb, nt)
            check(f"{label} apply, 4 x S lines", rel_err(t_big, plain(big, xb, nt)), 1e-5)
            lib, _ = block_library_call(big, xb, nt, m, factored)
            mb = big.numel() * big.element_size() / 1e6
            big_row = time_line_kernel(f"{label}, {4 * S} lines ({mb:.0f} MB of blocks)",
                                       lambda: kern(big, xb, nt, d=t_big),
                                       lambda: plain(big, xb, nt), lib, big, bs * 4 * n,
                                       factored)
            row.update({f"{k}_4S": v for k, v in big_row.items() if k != "bound_by"})
            del big, xb, t_big, lib
            rows.append(row)
        del binv, W, operands
    return rows


def phase_dense(dev):
    """Phase 7: the dense path's entry() forward (Burgers (32, 32), bs 10,
    f32_ir) held to the same inputs solved at precision "f64" (max-abs
    <= 1e-6); rel_rnorm; forward and forward + IFT backward of sum(u0^2),
    medians of 5; one profiled forward + backward; the factor solves'
    triangular-solve route timed beside torch.cholesky_solve."""
    from torch.profiler import ProfilerActivity, profile

    from mech_nn_discovery_pde_torch.config import PDEConfig
    from mech_nn_discovery_pde_torch.entry import IV_LIST, entry
    from mech_nn_discovery_pde_torch.layers.dense import PDEDenseLayer
    from mech_nn_discovery_pde_torch.solvers.cholesky import cho_solve

    fn, args = entry(device=dev)
    layer = fn.layer
    layer64 = PDEDenseLayer(bs=layer.bs, coord_dims=layer.coord_dims, order=2,
                            init_index_mi_list=IV_LIST, config=PDEConfig(precision="f64"),
                            device=dev)
    with torch.no_grad():
        u0 = fn(*args)
        u64 = layer64(args[0], args[1], args[2], list(args[3:]))[0]
        st = layer.solve_stats(args[0], args[1], args[2], list(args[3:]))
    torch.cuda.synchronize()
    err = abs_err(u0, u64)
    rel = st["rel_rnorm"]
    log(f"entry() f32_ir forward: u0 {tuple(u0.shape)}, max-abs vs f64 {err:.3e} (limit 1e-6); "
        f"rel_rnorm max {float(rel.max()):.4e} mean {float(rel.mean()):.4e}; finite "
        f"{bool(st['finite'].all())}")
    if not (bool(torch.isfinite(u0).all()) and err <= 1e-6 and bool(st["finite"].all())):
        raise AssertionError(f"entry() forward: max-abs {err:.3e} against f64 (limit 1e-6)")

    def fwd():
        with torch.no_grad():
            return fn(*args)

    def fwd_bwd():
        c, r, i = (a.clone().requires_grad_(True) for a in args[:3])
        (fn(c, r, i, *args[3:]) ** 2).sum().backward()
        return c.grad, r.grad, i.grad

    out = {}
    for name, f in (("forward", fwd), ("forward+backward", fwd_bwd)):
        f()
        torch.cuda.synchronize()
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            f()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        ts.sort()
        out[name] = ts[2]
        log(f"entry() {name}: median {ts[2] * 1e3:.2f} ms over 5 (min {ts[0] * 1e3:.2f}, "
            f"max {ts[-1] * 1e3:.2f})")
    grads = fwd_bwd()
    if not all(bool(torch.isfinite(gr).all()) for gr in grads):
        raise AssertionError("entry() backward: non-finite gradient")
    # the triangular-solve route of the factor solves (solvers/cholesky.py
    # cho_solve) beside torch.cholesky_solve, on the forward's f32 factors
    with torch.no_grad():
        values, _ = layer._prepare(args[0], args[1], args[2], list(args[3:]))
        L, _ = layer.inner.factor(values)
        rhs = torch.randn(L.shape[:2], device=dev, dtype=L.dtype)
        check("cho_solve vs torch.cholesky_solve",
              rel_err(cho_solve(L, rhs), torch.cholesky_solve(rhs[..., None], L)[..., 0]), 1e-4)
        t_tri = time_ms(lambda: cho_solve(L, rhs), n=5)
        t_cho = time_ms(lambda: torch.cholesky_solve(rhs[..., None], L), n=5)
    log(f"factor solve ({tuple(L.shape)} f32): two triangular solves {t_tri:.3f} ms, "
        f"torch.cholesky_solve {t_cho:.3f} ms")
    out["cho_solve_ms"], out["cholesky_solve_ms"] = t_tri, t_cho
    del L, values
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fwd_bwd()
        torch.cuda.synchronize()
    _, busy_us, by_name = kernel_counts(prof)
    log(f"profiler: entry() forward + backward device busy {busy_us / 1e3:.2f} ms "
        f"(idle share {max(0.0, 1 - busy_us / 1e6 / out['forward+backward']):.3f})")
    for name, (us, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"  {us / 1e3:10.3f} ms  x{c:5d}  {name[:90]}")
    return out


class _Records(logging.Handler):
    """Collects the port's per-solve log lines ("solve[forward] ...")."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def phase_burgers(dev, steps=3):
    """Phase 8: Adam steps of BurgersDiscovery.loss_fn at the BurgersConfig
    defaults: the full 128 x 256 field through the width-128, depth-12
    ResNet, bs 10 dense (32, 32) solves in f32_ir; a finite loss, the step
    times and each solve's rel_rnorm (the layer's log_solves lines)."""
    from mech_nn_discovery_pde_torch.data.datasets import BurgersDataset, PatchLoader
    from mech_nn_discovery_pde_torch.discovery.burgers import BurgersConfig, BurgersDiscovery
    from mech_nn_discovery_pde_torch.discovery.common import make_update

    cfg = BurgersConfig()
    t0 = time.perf_counter()
    ds = BurgersDataset(solver_dim=cfg.solver_dim, data_root=cfg.data_root)
    log(f"Burgers data ready in {time.perf_counter() - t0:.1f} s: u {ds.data.shape}, "
        f"{len(ds)} patches")
    model = BurgersDiscovery(cfg, ds, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr)
    update = make_update(model.loss_fn, opt)
    batches = iter(PatchLoader(ds, cfg.batch_size, seed=cfg.seed))
    rec = _Records()
    pde_log = logging.getLogger("pde")
    pde_log.addHandler(rec)
    pde_log.setLevel(logging.INFO)
    times = []
    try:
        for i in range(steps):
            patch, t_idx, x_idx = next(batches)
            rec.lines.clear()
            t0 = time.perf_counter()
            loss, aux = update(patch, t_idx, x_idx)
            lv = float(loss)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            log(f"Burgers step {i}: loss {lv:.6e} (x_loss {float(aux['x_loss']):.4e}, var_loss "
                f"{float(aux['var_loss']):.4e}) {times[-1]:.3f} s; " + "; ".join(rec.lines))
            if not math.isfinite(lv) or not any("forward" in ln for ln in rec.lines):
                raise AssertionError(f"Burgers step {i}: loss {lv}, solve logs {rec.lines}")
    finally:
        pde_log.removeHandler(rec)
    return times


def phase_sine(dev, epochs=25):
    """Phase 9: the sine fit at the SineFitConfig defaults with f64 solves
    for 25 epochs; its last loss must be below 0.2 x its first."""
    from mech_nn_discovery_pde_torch.config import PDEConfig
    from mech_nn_discovery_pde_torch.fit.sine_fit import SineFitConfig, train

    t0 = time.perf_counter()
    _, hist = train(SineFitConfig(epochs=epochs, pde=PDEConfig(precision="f64")), device=dev)
    dt = time.perf_counter() - t0
    log(f"sine fit: {epochs} epochs in {dt:.2f} s, loss {hist[0]:.4e} -> {hist[-1]:.4e} "
        f"(ratio {hist[-1] / hist[0]:.4f}, limit 0.2)")
    if not (all(math.isfinite(h) for h in hist) and hist[-1] < 0.2 * hist[0]):
        raise AssertionError(f"sine fit: loss {hist[0]} -> {hist[-1]}")
    return dt


def k1_launches_by_type(prof):
    """K1 f64 / f32 and K2 launches in a trace, by kernel instantiation."""
    out = {"k1_f64": 0, "k1_f32": 0, "k2": 0}
    for e in device_events(prof):
        if "k1_stencil_apply<double" in e.name:
            out["k1_f64"] += 1
        elif "k1_stencil_apply<float" in e.name:
            out["k1_f32"] += 1
        elif "k2_line_block_apply" in e.name:
            out["k2"] += 1
    return out


def phase_transport(dev):
    """Phase 10: both transport examples' main().  The multigrid one ((8,
    512), n_grid 6, default PDEConfig: f64 outer FGMRES, K1 f64 inside it,
    K1 f32 and K2 at bw 40 in the V-cycle) must reach an interior advection
    error <= 3.0e-2, the dense one <= 2.5e-2.  Returns the launch counts of
    the multigrid example; one window is profiled to count the kernels by
    instantiation."""
    from torch.profiler import ProfilerActivity, profile

    from mech_nn_discovery_pde_torch.examples import transport_dense, transport_multigrid
    from mech_nn_discovery_pde_torch.ops import _cuda

    torch.cuda.synchronize()
    _cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    _, err_mg = transport_multigrid.main(device=dev)
    torch.cuda.synchronize()
    dt_mg = time.perf_counter() - t0
    counts = dict(_cuda.LAUNCHES)
    log(f"transport multigrid: {dt_mg:.2f} s for 4 windows, error {err_mg:.4e} (limit 3.0e-2); "
        f"launches {counts}")
    t0 = time.perf_counter()
    _, err_d = transport_dense.main(device=dev)
    torch.cuda.synchronize()
    log(f"transport dense: {time.perf_counter() - t0:.2f} s for 8 windows, error {err_d:.4e} "
        f"(limit 2.5e-2)")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        transport_multigrid.main(device=dev, windows=1)
        torch.cuda.synchronize()
    by_type = k1_launches_by_type(prof)
    log(f"profiler: one multigrid transport window launches {by_type}")
    if not (err_mg <= 3.0e-2 and err_d <= 2.5e-2):
        raise AssertionError(f"transport errors {err_mg:.3e} (multigrid), {err_d:.3e} (dense)")
    for n in ("k1_stencil_apply_f64", "k1_stencil_apply", "k2_line_block_apply"):
        if counts.get(n, 0) == 0:
            raise AssertionError(f"transport multigrid did not launch {n}")
    if min(by_type.values()) == 0:
        raise AssertionError(f"profiler: transport window kernels {by_type}")
    return counts


def phase_kamani(dev, steps=3):
    """Phase 11: Adam steps of KamaniDiscovery.loss_fn at the KamaniConfig
    defaults (bs 2048 dense (24,) f32_ir solves with 6 PCG steps, the
    width-100, depth-9 ResNet1D, f32 nets; the optimizer and LR schedule of
    build_optimizer) on Kamani data from the port's generator (500
    amplitudes, into data/kamani/ on first use).  A finite loss, row 3 of
    the coefficients pinned to [1, 0, 0], |exponents| <= 2; the last step
    profiled (device busy time, idle share, kernels by time); then the
    closed-loop error of the learned and of the true model, the latter below
    0.01 at every amplitude."""
    from torch.profiler import ProfilerActivity, profile

    from mech_nn_discovery_pde_torch.data.datasets import KamaniDataset, PatchLoader
    from mech_nn_discovery_pde_torch.discovery import kamani
    from mech_nn_discovery_pde_torch.discovery.common import make_update

    cfg = kamani.KamaniConfig(plot_every=0)
    t0 = time.perf_counter()
    ds = KamaniDataset(solver_dim=cfg.solver_dim, data_root=cfg.data_root)
    log(f"Kamani data ready in {time.perf_counter() - t0:.1f} s: u {ds.u.shape}, "
        f"{len(ds)} windows")
    model = kamani.KamaniDiscovery(cfg, ds, device=dev)
    steps_pe = len(ds) // cfg.batch_size
    opt, sched = kamani.build_optimizer(cfg, model, steps_pe, steps_pe * cfg.epochs)
    update = make_update(model.loss_fn, opt, sched)
    batches = iter(PatchLoader(ds, cfg.batch_size, seed=cfg.seed))
    times = []
    for i in range(steps):
        _, u, _, sd, sdd = next(batches)
        last = i == steps - 1
        with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if last
              else contextlib.nullcontext()) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, aux = update(u, sd, sdd)
            lv = float(loss)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        log(f"Kamani step {i}: loss {lv:.6e} (u_loss {float(aux['u_loss']):.4e}, var_loss "
            f"{float(aux['var_loss']):.4e}), fwd rel_rnorm {float(aux['fwd_rel_rnorm']):.3e}, "
            f"{times[-1]:.4f} s")
        if not math.isfinite(lv):
            raise AssertionError(f"Kamani step {i}: loss {lv}")
    _, busy_us, by_name = kernel_counts(prof)
    log(f"profiler: Kamani step {steps - 1} device busy {busy_us / 1e3:.2f} ms in "
        f"{sum(c for _, c in by_name.values())} device activities (idle share "
        f"{max(0.0, 1 - busy_us / 1e6 / times[-1]):.3f} of the profiled step)")
    for name, (us, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        log(f"  {us / 1e3:10.3f} ms  x{c:5d}  {name[:90]}")
    pr, er = (a.detach().cpu().numpy() for a in model.get_params())
    if not (pr[3].tolist() == [1.0, 0.0, 0.0] and abs(er).max() <= 2.0):
        raise AssertionError(f"Kamani parameters: pinned row {pr[3]}, max |er| {abs(er).max()}")
    t0 = time.perf_counter()
    learned = kamani.closed_loop_error(pr, er)
    truth = kamani.closed_loop_error(*kamani.true_params())
    log(f"closed-loop error ({time.perf_counter() - t0:.1f} s): learned "
        + ", ".join(f"a={a}: {e:.4g}" for a, e in learned.items()) + "; true model "
        + ", ".join(f"a={a}: {e:.3e}" for a, e in truth.items()) + " (limit 0.01)")
    if not max(truth.values()) < 0.01:
        raise AssertionError(f"closed-loop error of the true model {truth}")
    return times


def phase_gl_transform(dev, steps=3, cfg=None):
    """Phase 12: Adam steps of GLDiscovery.loss_fn at GLConfig(nn_transform
    =True) defaults (phase 6's step plus two width-128, depth-12 ResNets on
    bs x nt = 256 frames of 32 x 32, forward and backward, in float32), then
    one backward_probe on the last batch.  A finite loss, K1 and K2 launched
    in the steps, every probe solve finite.  Returns the launch counts of
    the steps and the probe."""
    from mech_nn_discovery_pde_torch.data.datasets import PatchLoader, ReactDiffDataset
    from mech_nn_discovery_pde_torch.discovery.common import make_update
    from mech_nn_discovery_pde_torch.discovery.ginzburg_landau import GLConfig, GLDiscovery
    from mech_nn_discovery_pde_torch.ops import _cuda

    cfg = cfg or GLConfig(nn_transform=True)
    ds = ReactDiffDataset(solver_dim=cfg.solver_dim, data_root=cfg.data_root,
                          downsample=cfg.downsample, first_equation=cfg.first_equation)
    model = GLDiscovery(cfg, ds, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr)
    update = make_update(model.loss_fn, opt)
    batches = iter(PatchLoader(ds, cfg.batch_size, seed=cfg.seed))
    torch.cuda.synchronize()
    _cuda.LAUNCHES.clear()
    for i in range(steps):
        u, v, _, _, _ = next(batches)
        t0 = time.perf_counter()
        loss, aux = update(u, v)
        lv = float(loss)
        torch.cuda.synchronize()
        log(f"GL nn_transform step {i}: loss {lv:.6e}  fwd iters {float(aux['fwd_iters']):.1f}  "
            f"fwd rel_rnorm {float(aux['fwd_rel_rnorm']):.3e}  {time.perf_counter() - t0:.3f} s")
        if not math.isfinite(lv):
            raise AssertionError(f"non-finite loss at GL nn_transform step {i}")
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    _cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    st = model.backward_probe(u, v)
    torch.cuda.synchronize()
    counts_p = dict(_cuda.LAUNCHES)
    log(f"GL nn_transform launches (steps): {counts}; backward probe "
        f"{time.perf_counter() - t0:.3f} s: iters {st['iters'].tolist()}, rel_rnorm max "
        f"{float(st['rel_rnorm'].max()):.3e} mean {float(st['rel_rnorm'].mean()):.3e}, "
        f"launches {counts_p}")
    for n in ("k1_stencil_apply", "k2_line_block_apply"):
        if counts.get(n, 0) == 0 or counts_p.get(n, 0) == 0:
            raise AssertionError(f"GL nn_transform: {n} launched {counts.get(n, 0)} times in "
                                 f"the steps, {counts_p.get(n, 0)} in the probe")
    if not bool(st["finite"].all()):
        raise AssertionError(f"backward probe: non-finite solves {st['finite'].tolist()}")
    return counts


def phase_resume(dev):
    """Phase 13: Kamani train() for 1 epoch of 1 step with a checkpoint
    every epoch, in a fresh run directory under logs/; then train() again
    with resume_from that directory and 2 epochs.  The second run must
    start at epoch 1 from the checkpoint's parameters, Adam moments and
    scheduler step bit for bit, and its one step must move the
    parameters.  The run directory is removed afterwards."""
    import os
    import shutil
    import tempfile

    from mech_nn_discovery_pde_torch.discovery import kamani

    started = []

    class Probe(kamani.TrainHarness):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            started.append((self, self.start_epoch, copy_state(self.state_dict())))

    os.makedirs("logs", exist_ok=True)
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_kamani_", dir="logs")
    kw = dict(steps_per_epoch=1, ckpt_every=1, plot_every=0, resume_from=run_dir)
    own = kamani.TrainHarness
    kamani.TrainHarness = Probe
    try:
        t0 = time.perf_counter()
        kamani.train(kamani.KamaniConfig(epochs=1, **kw), device=dev)
        t1 = time.perf_counter()
        saved = torch.load(os.path.join(run_dir, "ckpt", "0.pt"), map_location=dev,
                           weights_only=True)
        model = kamani.train(kamani.KamaniConfig(epochs=2, **kw), device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        (_, e0, _), (h, e1, resumed) = started
        diff = first_difference(resumed, saved)
        moved = any(not torch.equal(p, saved["model"][n]) for n, p in model.state_dict().items())
        log(f"resume: first run {t1 - t0:.2f} s, resumed run {t2 - t1:.2f} s; start epochs "
            f"{e0}, {e1}; restored state equal to the checkpoint: {diff is None}; scheduler "
            f"step {resumed['scheduler']['last_epoch']}; parameters moved by the resumed step: "
            f"{moved}\nresumed run's phase timings:\n{h.timer.report()}")
        if (e0, e1) != (0, 1) or diff is not None or not moved:
            raise AssertionError(f"resume: start epochs {e0}, {e1}; first difference {diff}; "
                                 f"moved {moved}")
    finally:
        kamani.TrainHarness = own
        shutil.rmtree(run_dir, ignore_errors=True)


def copy_state(x):
    """A deep copy of a state dict (tensors cloned)."""
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, dict):
        return {k: copy_state(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(copy_state(v) for v in x)
    return x


def first_difference(a, b, path="state"):
    """The path of the first entry where a and b differ (tensors bit for bit,
    dtype included), or None."""
    if torch.is_tensor(b):
        same = torch.is_tensor(a) and a.dtype == b.dtype and torch.equal(a, b.to(a.device))
        return None if same else path
    if isinstance(b, dict):
        if a.keys() != b.keys():
            return path
        return next((d for k in b if (d := first_difference(a[k], b[k], f"{path}.{k}"))), None)
    if isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return path
        return next((d for i, (x, y) in enumerate(zip(a, b))
                     if (d := first_difference(x, y, f"{path}[{i}]"))), None)
    return None if a == b else path


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
    outs = _cuda.build(ptxas=True)
    log(f"kernels built in {time.perf_counter() - t0:.1f} s (nvcc {_cuda.nvcc_path()})")
    if "line_block" in outs:  # built in this run: read ptxas's report
        check_line_block_ptxas(outs["line_block"])
    if "stencil_apply" in outs:
        check_k1_ptxas(outs["stencil_apply"])
    if "point_block" in outs:
        check_point_block_ptxas(outs["point_block"])

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
    values, rhs_vec, hier = layer._prepare(c0, r0, i0, steps)
    torch.cuda.synchronize()
    log(f"hierarchy built in {time.perf_counter() - t0:.2f} s; lmax level 0 "
        f"{float(hier['levels'][0]['lmax'].min()):.4f}..{float(hier['levels'][0]['lmax'].max()):.4f}")
    time_hierarchy_build(layer, c0, r0, i0, steps)
    report = phase_kernels(layer, hier, values.detach(), dev, args.seed)
    with torch.no_grad():
        counts_kry = phase_krylov(layer, hier, values.detach(), rhs_vec, dev)
    del rhs_vec
    phase_odd_shape(dev, args.seed)
    wide = phase_wide_blocks(dev, args.seed)
    phase_k1_layouts(dev, args.seed)
    del layer, hier, values
    torch.cuda.empty_cache()
    tk = phase_transport_kernels(dev, args.seed)
    # K1 f64's entry takes its numbers at the shapes of the path that
    # launches it (the transport example); its GL-shape numbers stay beside
    report["k1_f64"] = dict(tk["k1_f64"], gl_shapes=report["k1_f64"])
    report["k1"]["transport"], report["k2"]["transport"] = tk["k1"], tk["k2"]
    torch.cuda.empty_cache()

    _, stencil_rel = phase_layer(args.seed, dev)
    counts_w, _ = phase_layer(args.seed, dev, precond="bf16_factored")
    torch.cuda.empty_cache()
    counts_b, _, _ = phase_bf16_forward(args.seed, dev)
    torch.cuda.empty_cache()
    long_rows, counts_long, counts_level1, long_steps = phase_long_window(args.seed, dev)
    report.update(long_rows)
    counts = phase_trainer(dev)
    torch.cuda.empty_cache()
    phase_dense(dev)
    torch.cuda.empty_cache()
    phase_burgers(dev)
    torch.cuda.empty_cache()
    phase_sine(dev)
    counts_t = phase_transport(dev)
    torch.cuda.empty_cache()
    phase_kamani(dev)
    torch.cuda.empty_cache()
    counts_nt = phase_gl_transform(dev)
    torch.cuda.empty_cache()
    phase_resume(dev)
    torch.cuda.empty_cache()

    t_new = time.perf_counter()
    new_counts = {"krylov": counts_kry,
                  **{f"long_window_{mode}": c for mode, c in counts_long.items()}}
    for name, evolution, opts in OPTION_PHASES:
        new_counts[name], opt_layer = phase_option(args.seed, dev, name, evolution, opts,
                                                   stencil_rel)
        if name == "point":
            point_step = phase_point_route(args.seed, opt_layer, dev)
            point_rows, point_counts = phase_point_blocks(args.seed, opt_layer, dev)
            report.update(point_rows)
            report["k2_point"]["point_step"] = point_step
        del opt_layer
        torch.cuda.empty_cache()
        if name == "point":
            (new_counts["parallel_sp2"], new_counts["parallel_nccl_sp1"],
             report["k1"]["window"]) = phase_parallel(args.seed, dev, smi)
            torch.cuda.empty_cache()
    phase_native(dev)
    log(f"phases 14-19 took {time.perf_counter() - t_new:.1f} s")

    stencil = "mech_nn_discovery_pde_torch/csrc/stencil_apply.cu"
    line = "mech_nn_discovery_pde_torch/csrc/line_block.cu"
    point = "mech_nn_discovery_pde_torch/csrc/point_block.cu"
    tpu_fs = "mech_nn_discovery_pde_tpu/ops/fused_smoother.py"
    trainer, step_w, fwd_b = "GL trainer, 3 steps", "b30c4rmw layer step", "b30c4rm bf16 forward"
    long_w = "long-window layer step ((50, 32, 32), bs 8), {} storage"
    transport = "transport multigrid example, 4 windows"
    kernels = [  # (name, source, TPU kernel, launch counts of its path, key)
        ("k1_stencil_apply", stencil, "mech_nn_discovery_pde_tpu/ops/normal_stencil.py:404",
         trainer, counts, "k1"),
        ("k1_stencil_apply_f64", stencil, "mech_nn_discovery_pde_tpu/ops/normal_stencil.py:404",
         transport, counts_t, "k1_f64"),
        ("k2_line_block_apply", line, f"{tpu_fs}:128", trainer, counts, "k2"),
        ("k3_factored_line_block_apply", line, f"{tpu_fs}:104", step_w, counts_w, "k3"),
        ("k1_stencil_apply_bf16", stencil, f"{tpu_fs}:51", fwd_b, counts_b, "k1_bf16"),
        ("k2_line_block_apply_bf16", line, f"{tpu_fs}:87", fwd_b, counts_b, "k2_bf16"),
        ("k2_point_block_apply", point, f"{tpu_fs}:128", "point layer step, 3 steps",
         new_counts["point"], "k2_point"),
        ("k2_point_block_apply_bf16", point, f"{tpu_fs}:87", "point forward, bf16 storage",
         point_counts["bf16"], "k2_point_bf16"),
        ("k3_point_block_apply", point, f"{tpu_fs}:104", "point forward, bf16_factored storage",
         point_counts["bf16_factored"], "k3_point"),
        ("k2_line_block_apply_panels", line, f"{tpu_fs}:128", long_w.format("f32"),
         counts_long["f32"], "k2_panels"),
        ("k2_line_block_apply_panels_bf16", line, f"{tpu_fs}:87",
         long_w.format("bf16").replace("layer step", "forward"), counts_long["bf16"],
         "k2_panels_bf16"),
        ("k3_factored_line_block_apply_cluster", line, f"{tpu_fs}:104",
         long_w.format("bf16_factored"), counts_long["bf16_factored"], "k3_cluster"),
    ]
    # the long window's level-1 kernels (bw 175), rows of their own: each
    # with its launches at level 1 of its path
    level1_path = "long-window {} storage, level 1 (bs 8, 256 lines of 175^2)"
    for precond, what in (("f32", "layer step"), ("bf16_factored", "layer step"),
                          ("bf16", "forward")):
        row = report[f"level1_{precond}"]
        rep = f"{tpu_fs}:{104 if precond == 'bf16_factored' else 87 if precond == 'bf16' else 128}"
        kernels.append((row["kernel"], line, rep,
                        level1_path.format(precond).replace("storage", f"storage {what}"),
                        counts_level1[precond], f"level1_{precond}"))
    # each line-block kernel also carries the phase-2d rows of its route
    entry_of = {("k2", "streamed"): "k2", ("k2_bf16", "streamed"): "k2_bf16",
                ("k3", "streamed"): "k3", ("k2", "panels"): "k2_panels",
                ("k2_bf16", "panels"): "k2_panels_bf16", ("k3", "cluster"): "k3_cluster"}
    wide_rows = {}
    for r in wide:
        wide_rows.setdefault(entry_of[r["kernel"], r["route"]], []).append(
            {k: v for k, v in r.items() if k != "kernel"})
    kernels = [dict(name=n, route="cuda", source=src, replaces=rep, launches=c.get(n, 0),
                    launches_in=path, **report[key],
                    **({"wide_blocks": wide_rows[key]} if key in wide_rows else {}))
               for n, src, rep, path, c, key in kernels]
    # K1 and K2 also carry their launches on the GL nn_transform path (phase 12),
    # and every kernel its launches on the paths of phases 14-18
    for kd in kernels[0], kernels[2]:
        kd["launches_gl_nn_transform"] = counts_nt.get(kd["name"], 0)
    for kd in kernels:
        kd["launches_new_paths"] = {p: c.get(kd["name"], 0) for p, c in new_counts.items()}
        for p in ("parallel_sp2", "parallel_nccl_sp1"):
            if f"{kd['name']}_windowed" in new_counts[p]:
                kd["launches_new_paths"][f"{p}_windowed"] = new_counts[p][f"{kd['name']}_windowed"]
    next(kd for kd in kernels if kd["name"] == "k2_line_block_apply_panels")[
        "long_window_steps"] = {
            mode: {k: v for k, v in st.items() if k not in ("counts", "top_kernels")}
            for mode, st in long_steps.items()}
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
