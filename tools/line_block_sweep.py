"""Time the row-tiled K2 and K3 kernels (csrc/line_block.cu) over a grid of
launch geometries at one shape, through the library's own launchers.

    python3 tools/line_block_sweep.py [--bs 8] [--lines 1024] [--nt 50] [--m 7]

K2 (f32 and bf16 B^-1, the panel kernel): panels of 24, 16 and 8 rows at
1 to 4 CTAs an SM, with 2 stages and with the most (up to 4) that fit.  K3
(the cluster kernel): one stage a CTA at every cluster of 2 to 8 CTAs and 1
to 3 CTAs an SM, and one CTA an SM with 2 and 3 stages.  Each geometry is
checked against the plain version (1e-5) and timed back to back (median of
10 runs of 10 launches), beside the bound (B^-1 or W's upper triangle, r
and d read once, d written, at 3.35 TB/s); K3's line also gives the clusters the card holds at
once.  Prints the card's name and power limit first.  Needs a CUDA device
and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mech_nn_discovery_pde_torch.ops import _cuda  # noqa: E402
from mech_nn_discovery_pde_torch.ops import fused_smoother as fs  # noqa: E402

SMEM_PER_SM, SMEM_PER_BLOCK, RESERVED = 233472, 232448, 1024


def back_to_back_ms(call) -> float:
    call()
    torch.cuda.synchronize()
    ts = []
    for _ in range(10):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(10):
            call()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1) / 10)
    return statistics.median(ts)


def sweep(lib, label, blocks, x, nt, factored, geometries):
    """Time `blocks` on each (rows, stages, ctas) of `geometries`."""
    bs, S, bw, _ = blocks.shape
    m = bw // nt
    fn = getattr(lib, fs._K3_FN.line_fn if factored else fs._K2_FN[blocks.dtype].line_fn)
    plain = (fs.factored_block_apply_plain if factored else fs.block_apply_plain)(blocks, x, nt)
    # K3 needs W's upper triangle only: bw (bw + 1) / 2 entries a block
    entries = bs * S * (bw * (bw + 1) // 2 if factored else bw * bw)
    bound = (entries * blocks.element_size() + 8 * x.numel()) / 3.35e9
    d = torch.empty_like(x)
    stream = _cuda.stream_ptr(x.device)
    for rows, stages, ctas in geometries:
        smem = fs.line_block_smem_bytes(bw, stages, blocks.element_size(), factored, rows)
        call = lambda: fn(blocks.data_ptr(), x.data_ptr(), d.data_ptr(), None, None,  # noqa: E731
                          m, nt, S, bs, ctas, rows, stages, smem, 1, stream)
        code = call()
        if code:
            raise RuntimeError(f"{label} rows {rows} stages {stages}: CUDA error {code}")
        torch.cuda.synchronize()
        err = float((d - plain).abs().max() / plain.abs().max())
        if not err <= 1e-5:
            raise AssertionError(f"{label} rows {rows} stages {stages}: error {err:.2e}")
        ms = back_to_back_ms(call)
        extra = ""
        if factored:
            extra = f", {lib.k3_cluster_occupancy(-(-bw // rows), smem)} clusters resident"
        print(f"{label} rows {rows} stages {stages} ctas {ctas}{extra}: {ms:.4f} ms, "
              f"{bound / ms:.1%} of the {bound:.4f} ms bound", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bs", type=int, default=8)
    ap.add_argument("--lines", type=int, default=1024)
    ap.add_argument("--nt", type=int, default=50)
    ap.add_argument("--m", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    lib = _cuda.library("line_block")
    lib.k3_cluster_occupancy.argtypes = [ctypes.c_int, ctypes.c_int]
    dev = torch.device("cuda", 0)
    n_sm = _cuda.sm_count(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    bs, S, nt = args.bs, args.lines, args.nt
    bw = nt * args.m
    x = torch.randn((bs, nt * S * args.m), generator=g, device=dev)
    blocks = torch.randn((bs, S, bw, bw), generator=g, device=dev) / bw
    for dtype in (torch.float32, torch.bfloat16):
        b = blocks.to(dtype)
        geos = []
        for rows in (24, 16, 8):
            for per_sm in (4, 3, 2, 1):
                budget = min(SMEM_PER_SM // per_sm - RESERVED, SMEM_PER_BLOCK)
                most = max((st for st in range(1, 5) if fs.line_block_smem_bytes(
                    bw, st, b.element_size(), False, rows) <= budget), default=0)
                ctas = min(bs * S * -(-bw // rows), n_sm * per_sm)
                geos += [(rows, st, ctas) for st in sorted({2, most}) if 1 <= st <= most]
        sweep(lib, f"K2 {str(dtype)[6:]} bw {bw}", b, x, nt, False, geos)
    W = blocks.triu().to(torch.bfloat16)
    geos = []
    for c in range(2, 9):
        rows = 8 * -(-bw // (8 * c))
        if fs.line_block_route(bw, rows, True) != "cluster":
            continue
        C = -(-bw // rows)
        for per_sm, stages in ((3, 1), (2, 1), (1, 1), (1, 2), (1, 3)):
            smem = fs.line_block_smem_bytes(bw, stages, 2, True, rows)
            if per_sm * (smem + RESERVED) <= SMEM_PER_SM and smem <= SMEM_PER_BLOCK:
                geos.append((rows, stages, C * min(bs * S, n_sm * per_sm // C)))
    sweep(lib, f"K3 bw {bw}", W, x, nt, True, sorted(set(geos)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
