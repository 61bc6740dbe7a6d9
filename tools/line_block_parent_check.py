"""Run another checkout's line-block kernels in turns with this one's.

    python3 tools/line_block_parent_check.py OTHER_CHECKOUT [--seed 0]

OTHER_CHECKOUT is another commit's tree (for example the parent's, unpacked
with `git archive`).  Its `csrc/line_block.cu` is built with this
checkout's nvcc flags and its `ops/fused_smoother.line_block_geometry` (and
its `line_block_launch_args`, where it has one) are swapped in for this
checkout's while its turn runs (`OtherLineBlock`); the C launchers keep
their signature, so the solver runs either unchanged.
In one process, each comparison in turns other, this, this, other:

1. the streamed K2 (f32, bf16) and K3 at the GL fine level (bs 32, 1024
   lines of 56 x 56) give the other checkout's output bit for bit, with and
   without the Chebyshev epilogue;
2. K2 f32, K2 bf16 and K3 at chip_smoke.py's timed wide shapes (bw 280 and
   350, bs 2 x 64 lines, and 4 x as many lines), then at the long window's
   level-1 shape (bs 8, 256 lines of 175 x 175), on each checkout's
   kernels: each against the plain version (1e-5), then alone, back to back
   and on the device (a CUDA graph of 20 launches);
3. the long-window layer step ((50, 32, 32), bs 8, downsample_first=True)
   in f32 and 'bf16_factored' storage: one step on each checkout's kernels
   gives its forward rel_rnorm (this checkout's must be within 1 % of the
   other's: the row-tiled kernels sum in another order, and the
   unconverged solves follow it) and finite gradients, then 2 timed steps
   each in turns; then the fine level's kernel at the step's own blocks
   (also K2 bf16, from one 'bf16' layer's hierarchy), timed as in 2.

Prints the card's name and power limit first and one JSON object of the
numbers last; exits nonzero if a check fails.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from chip_smoke import log  # noqa: E402
from mech_nn_discovery_pde_torch.ops import _cuda  # noqa: E402
from mech_nn_discovery_pde_torch.ops import fused_smoother as fs  # noqa: E402


class OtherLineBlock:
    """Another checkout's line-block kernels: its csrc/line_block.cu, built
    with this checkout's nvcc flags into its own _build/, and its
    ops/fused_smoother.line_block_geometry and launch arguments, swapped in
    for this checkout's by `active()`.  The wrappers keep their epilogue, so the solver and
    `block_apply` run the other's kernels unchanged (their launches count
    under this checkout's names)."""

    def __init__(self, root):
        pkg = Path(root).resolve() / "mech_nn_discovery_pde_torch"
        so = pkg / "_build" / "libline_block_other.so"
        so.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        subprocess.run([_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o", str(so),
                        str(pkg / "csrc" / "line_block.cu")], check=True)
        self.lib = ctypes.CDLL(str(so))
        for fn, argtypes in _cuda._SIGNATURES["line_block"].items():
            getattr(self.lib, fn).argtypes = argtypes
            getattr(self.lib, fn).restype = ctypes.c_int
        self.lib.k2_error_string.argtypes = [ctypes.c_int]
        self.lib.k2_error_string.restype = ctypes.c_char_p
        spec = importlib.util.spec_from_file_location("other_fused_smoother",
                                                      pkg / "ops" / "fused_smoother.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod  # its dataclasses look their module up
        spec.loader.exec_module(mod)
        self.geometry_fn = mod.line_block_geometry
        self.launch_args_fn = getattr(mod, "line_block_launch_args", None)
        self.geometry_type = mod.LineBlockGeometry
        log(f"other line_block.cu from {pkg} built in {time.perf_counter() - t0:.1f} s")

    def geometry(self, bs, S, bw, entry_bytes, n_sm, factored=False):
        """The other checkout's geometry as this one's type (its route where
        it names one; else a launch of blocks wider than one CTA counts as
        "panels" (K2) or "two_sweep" (K3), the routes whose launchers take
        the other's arguments)."""
        g = self.geometry_fn(bs, S, bw, entry_bytes, n_sm, factored)
        route = getattr(g, "route", None) or (
            "streamed" if g.panel_rows == bw else "two_sweep" if factored else "panels")
        return fs.LineBlockGeometry(ctas=g.ctas, stages=g.stages, smem_bytes=g.smem_bytes,
                                    bulk=g.bulk, panel_rows=g.panel_rows, route=route,
                                    cluster=getattr(g, "cluster", 1), walk=getattr(g, "walk", 0))

    def launch_args(self, geo, bw, entry_bytes, factored, ptr):
        """The other checkout's (smem_bytes, flags) of a launch: its own
        `line_block_launch_args` where it has one, else its geometry's
        shared memory and the bulk copy where the blocks are 16-byte
        aligned."""
        if self.launch_args_fn is None:
            return geo.smem_bytes, int(geo.bulk and ptr % 16 == 0)
        return self.launch_args_fn(self.geometry_type(**dataclasses.asdict(geo)), bw,
                                   entry_bytes, factored, ptr)

    @contextlib.contextmanager
    def active(self):
        own = _cuda.library("line_block"), fs.line_block_geometry, fs.line_block_launch_args
        _cuda._LIBS["line_block"], fs.line_block_geometry = self.lib, self.geometry
        fs.line_block_launch_args = self.launch_args
        try:
            yield
        finally:
            _cuda._LIBS["line_block"], fs.line_block_geometry, fs.line_block_launch_args = own


def turns(other):
    """(who, context) in turns other, this, this, other."""
    return tuple((w, other.active if w == "other" else contextlib.nullcontext)
                 for w in ("other", "this", "this", "other"))


def streamed_bitwise(dev, seed, other, bs=32, S=1024, nt=8, m=7):
    """Part 1: the streamed K2 (f32, bf16) and K3 at the GL fine level give
    the other checkout's output bit for bit, with and without the epilogue."""
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    bw, n = nt * m, nt * S * m
    x = torch.randn((bs, n), generator=g, device=dev)
    b = torch.randn((bs, n), generator=g, device=dev)
    c1 = torch.rand((bs,), generator=g, device=dev)
    c2 = torch.rand((bs,), generator=g, device=dev)
    binv, W = cs.spd_blocks(bs, S, bw, g, dev)
    operands = {"k2": binv, "k2_bf16": binv.to(torch.bfloat16), "k3": W}
    for name, key, kern, _, _ in cs.line_kernels():
        outs = {}
        for who, ctx in turns(other)[:2]:
            with ctx():
                d = b.clone()
                kern(operands[key], x, nt, d=d, c1=c1, c2=c2)
                outs[who] = (kern(operands[key], x, nt), d)
        same = all(torch.equal(a, c) for a, c in zip(outs["this"], outs["other"]))
        log(f"{name} streamed at the GL fine level (bs {bs}, {S} lines of {bw}^2): "
            f"{'bit for bit' if same else 'DIFFERENT from'} the other checkout's, with and "
            "without the epilogue")
        if not same:
            raise AssertionError(f"{name} streamed output differs from the other checkout's")


def kernel_turns(label, kern, plain, blocks, x, nt, factored, other):
    """One kernel at one shape on each checkout's build: checked against the
    plain version (1e-5), then alone, back to back (the mean of each
    checkout's two turns) and on the device (`chip_smoke.graph_ms`), beside
    the bound (`chip_smoke.block_bound`)."""
    want = plain(blocks, x, nt)
    t = kern(blocks, x, nt)
    run = lambda: kern(blocks, x, nt, d=t)  # noqa: E731
    row, b2b = {}, {"this": [], "other": []}
    for who, ctx in turns(other):
        pre = "" if who == "this" else "other_"
        with ctx():
            if f"{pre}ms" not in row:
                cs.check(f"{label} on {'this' if who == 'this' else 'the other'} checkout's "
                         "kernel", cs.rel_err(kern(blocks, x, nt), want), 1e-5)
                row[f"{pre}ms"] = cs.time_ms(run)
                row[f"{pre}device_ms"] = cs.graph_ms(run)
            b2b[who].append(cs.time_ms_back_to_back(run))
    row["ms_back_to_back"] = statistics.mean(b2b["this"])
    row["other_ms_back_to_back"] = statistics.mean(b2b["other"])
    row["bound_ms"], _ = cs.block_bound(blocks, x.numel(), factored)
    log(f"  {label}: this {row['ms']:.4f} ms, back to back {row['ms_back_to_back']:.4f} "
        f"({', '.join(f'{v:.4f}' for v in b2b['this'])}), device {row['device_ms']:.4f}; "
        f"the other's {row['other_ms']:.4f}, back to back {row['other_ms_back_to_back']:.4f} "
        f"({', '.join(f'{v:.4f}' for v in b2b['other'])}), device {row['other_device_ms']:.4f}; "
        f"bound {row['bound_ms']:.4f} ({row['bound_ms'] / row['ms_back_to_back']:.1%} and "
        f"{row['bound_ms'] / row['other_ms_back_to_back']:.1%} of it back to back)")
    return row


def wide_turns(dev, seed, other, bs=2):
    """Part 2: the timed shapes of chip_smoke.WIDE_SHAPES, on S and 4 x S
    lines."""
    g = torch.Generator(device=dev).manual_seed(seed + 4)
    rows = {}
    for nt, m, S, timed in cs.WIDE_SHAPES:
        if not timed:
            continue
        bw = nt * m
        for lines in (S, 4 * S):
            x = torch.randn((bs, nt * lines * m), generator=g, device=dev)
            binv, W = cs.spd_blocks(bs, lines, bw, g, dev)
            operands = {"k2": binv, "k2_bf16": binv.to(torch.bfloat16), "k3": W}
            for name, key, kern, plain, factored in cs.line_kernels():
                rows[f"{key} bw {bw}, {lines} lines"] = kernel_turns(
                    f"{name} bw {bw}, {lines} lines", kern, plain, operands[key], x, nt,
                    factored, other)
            del binv, W, operands
            torch.cuda.empty_cache()
    return rows


def level1_turns(dev, seed, other, bs=8, S=256, nt=25, m=7):
    """Part 2b: K2 f32, K2 bf16 and K3 at the long window's level-1 shape
    (bs 8, 256 lines of 175 x 175) on random SPD blocks, on each
    checkout's kernels (`kernel_turns`)."""
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    bw = nt * m
    x = torch.randn((bs, nt * S * m), generator=g, device=dev)
    binv, W = cs.spd_blocks(bs, S, bw, g, dev)
    operands = {"k2": binv, "k2_bf16": binv.to(torch.bfloat16), "k3": W}
    rows = {}
    for name, key, kern, plain, factored in cs.line_kernels():
        rows[f"{key} level 1"] = kernel_turns(
            f"{name} at the long window's level-1 shape (bs {bs}, {S} lines of {bw}^2)", kern,
            plain, operands[key], x, nt, factored, other)
    del binv, W, operands
    torch.cuda.empty_cache()
    return rows


def step_turns(layer, c0, r0, i0, steps, label, other):
    """Part 3's step: one on each checkout's kernels at the unperturbed
    inputs (rel_rnorm, finite gradients; also the warm-up), then 2 timed
    steps each in turns."""
    rel, ts = {}, {"this": [], "other": []}
    for who, ctx in turns(other)[:2]:
        with ctx():
            stats, grads = cs.grad_step(layer, c0, r0, i0, steps)
            torch.cuda.synchronize()
        rel[who] = float(stats["rel_rnorm"].max())
        if not all(bool(torch.isfinite(gr).all()) for gr in grads):
            raise AssertionError(f"{label} on the {who} checkout's kernels: non-finite gradient")
    for k, (who, ctx) in enumerate(turns(other)):
        with ctx():
            for j in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cs.grad_step(layer, c0 + 1e-6 * (2 * k + j + 1), r0, i0, steps)
                torch.cuda.synchronize()
                ts[who].append(time.perf_counter() - t0)
    ratio = rel["this"] / rel["other"]
    out = dict(rel_rnorm=rel["this"], other_rel_rnorm=rel["other"], step_s=ts["this"],
               other_step_s=ts["other"], step_s_median=statistics.median(ts["this"]),
               other_step_s_median=statistics.median(ts["other"]))
    log(f"{label} in turns: this checkout's kernels median {out['step_s_median']:.4f} s "
        f"({', '.join(f'{t:.4f}' for t in ts['this'])}), the other's "
        f"{out['other_step_s_median']:.4f} s ({', '.join(f'{t:.4f}' for t in ts['other'])}); "
        f"rel_rnorm {rel['this']:.4e} against the other's {rel['other']:.4e} "
        f"(ratio {ratio:.5f})")
    if not abs(ratio - 1) <= 0.01:
        raise AssertionError(f"{label}: rel_rnorm {rel['this']:.4e} not within 1 % of the "
                             f"other checkout's {rel['other']:.4e}")
    return out


def fine_blocks(layer, c0, r0, i0, steps):
    """The fine level's stored blocks of the layer's hierarchy and its nt."""
    with torch.no_grad():
        _, _, hier = layer._prepare(c0, r0, i0, steps)
    return hier["levels"][0]["binv"], layer.mg_solver.dim_list[0][0]


def long_window_turns(dev, seed, other, bs=8, dims=(50, 32, 32)):
    """Part 3."""
    kernels = {k[1]: k for k in cs.line_kernels()}
    out = {}
    for precond, key in (("f32", "k2"), ("bf16_factored", "k3"), ("bf16", "k2_bf16")):
        layer = cs.b30c4rm_layer(dev, precond, bs, dims, downsample_first=True)
        (c0, r0, i0), steps = cs.bench_inputs(layer, bs, dims, seed, dev)
        label = f"long-window {precond} layer step (bs {bs}, {dims})"
        res = {} if precond == "bf16" else step_turns(layer, c0, r0, i0, steps, label, other)
        blocks, nt = fine_blocks(layer, c0, r0, i0, steps)
        g = torch.Generator(device=dev).manual_seed(seed + 6)
        x = torch.randn((bs, blocks.shape[1] * blocks.shape[2]), generator=g, device=dev)
        name, _, kern, plain, factored = kernels[key]
        res["fine_level"] = kernel_turns(f"{name} at the long window's fine level ({precond})",
                                         kern, plain, blocks, x, nt, factored, other)
        out[precond] = res
        del layer, blocks
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="another checkout's root")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _cuda.build()
    other = OtherLineBlock(args.other)
    streamed_bitwise(dev, args.seed, other)
    wide = wide_turns(dev, args.seed, other)
    wide.update(level1_turns(dev, args.seed, other))
    long_window = long_window_turns(dev, args.seed, other)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"wide": wide, "long_window": long_window}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
