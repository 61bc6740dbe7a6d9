"""Time K2 and K3 (csrc/line_block.cu) over a grid of launch geometries,
through the library's own launchers.

    python3 tools/line_block_sweep.py [--bs 8] [--lines 1024] [--nt 50] [--m 7]
    python3 tools/line_block_sweep.py --mid [--bs 8] [--lines 256] [--out FILE]

Default (the row-tiled kernels at one shape, the long window's fine level):
K2 (f32 and bf16 B^-1, the panel kernel): panels of 24, 16 and 8 rows at 1
to 4 CTAs an SM, with 2 stages and with the most (up to 4) that fit.  K3
(the cluster kernel): one stage a CTA at every cluster of 2 to 8 CTAs and
1 to 3 CTAs an SM, and one CTA an SM with 2 and 3 stages.

--mid (the crossover from the streamed kernels to the row-tiled ones): at
every bw = nt * m for nt 8 to 34 at m 7 and m 5 (bw 40 to 238), bs x lines
blocks (the long window's level 1: 8 x 256), K2 in f32 and bf16 on the
streamed kernel (1, 2, 4 and 8 CTAs an SM of 2 stages and 1 or 2 CTAs of 3,
where they fit; one CTA of one stage where none does) and on the panel
kernel (24 and 16 rows, 3 CTAs an SM of 2 and 3 stages), and K3 on the
streamed kernel (as K2) and on the cluster
kernel (clusters of 2 and 3 CTAs: 1 to 4 CTAs an SM of one stage, 2 and 3
of two); the full table goes to --out, and a summary by width (the fastest
of each kernel, the geometry `line_block_geometry` picks and its time) to
the standard output.

Each geometry is checked against the plain version (1e-5) and timed back to
back (median of 10 runs of 10 launches), beside the bound (B^-1 or W's
upper triangle, r and d read once, d written, at 3.35 TB/s); K3's cluster
lines also give the clusters the card holds at once.  Prints the card's
name and power limit first.  Needs a CUDA device and nvcc.
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


def geometry(bw, eb, factored, rows, stages, ctas):
    """A LineBlockGeometry of the route `rows` gives (the streamed walk of
    `line_block_walk`)."""
    route = fs.line_block_route(bw, rows, factored)
    return fs.LineBlockGeometry(
        ctas=ctas, stages=stages, smem_bytes=fs.line_block_smem_bytes(bw, stages, eb, factored,
                                                                      rows),
        bulk=True, panel_rows=rows, route=route,
        cluster=-(-bw // rows) if route == "cluster" else 1,
        walk=fs.line_block_walk(bw, eb, factored) if route == "streamed" else 0)


def bound_ms(blocks, factored) -> float:
    """B^-1 (K3: W's upper triangle, bw (bw + 1) / 2 entries a block) read
    once, r and d read and d written, at 3.35 TB/s."""
    bs, S, bw, _ = blocks.shape
    entries = bs * S * (bw * (bw + 1) // 2 if factored else bw * bw)
    return (entries * blocks.element_size() + 12 * bs * S * bw) / 3.35e9


def sweep(lib, label, blocks, x, nt, factored, geometries, out=print):
    """Time `blocks` on each geometry; returns [(geometry, ms)]."""
    bs, S, bw, _ = blocks.shape
    m, eb = bw // nt, blocks.element_size()
    fn = getattr(lib, fs._K3_FN.line_fn if factored else fs._K2_FN[blocks.dtype].line_fn)
    plain = (fs.factored_block_apply_plain if factored else fs.block_apply_plain)(blocks, x, nt)
    bound = bound_ms(blocks, factored)
    d = torch.empty_like(x)
    stream = _cuda.stream_ptr(x.device)
    rows_out = []
    for geo in geometries:
        smem, flags = fs.line_block_launch_args(geo, bw, eb, factored, blocks.data_ptr())
        call = lambda: fn(blocks.data_ptr(), x.data_ptr(), d.data_ptr(), None, None,  # noqa: E731
                          m, nt, S, bs, geo.ctas, geo.panel_rows, geo.stages, smem, flags, stream)
        what = (f"{label} {geo.route} rows {geo.panel_rows} stages {geo.stages} ctas {geo.ctas}"
                + (f" walk {geo.walk}" if geo.route == "streamed" else ""))
        code = call()
        if code:
            raise RuntimeError(f"{what}: CUDA error {code}")
        torch.cuda.synchronize()
        err = float((d - plain).abs().max() / plain.abs().max())
        if not err <= 1e-5:
            raise AssertionError(f"{what}: error {err:.2e}")
        ms = back_to_back_ms(call)
        extra = ""
        if geo.route == "cluster":
            extra = f", {lib.k3_cluster_occupancy(geo.cluster, smem)} clusters resident"
        out(f"{what}{extra}: {ms:.4f} ms, {bound / ms:.1%} of the {bound:.4f} ms bound")
        rows_out.append((geo, ms))
    return rows_out, bound


def fits(per_sm, smem) -> bool:
    return per_sm * (smem + RESERVED) <= SMEM_PER_SM and smem <= SMEM_PER_BLOCK


def mid_geometries(bw, eb, factored, items, n_sm):
    """--mid's geometries at one width: streamed, and panels (K2) or
    cluster (K3)."""
    geos = []
    for per_sm, stages in ((8, 2), (4, 2), (2, 2), (1, 2), (2, 3), (1, 3)):
        if fits(per_sm, fs.line_block_smem_bytes(bw, stages, eb, factored)):
            geos.append(geometry(bw, eb, factored, bw, stages, min(items, n_sm * per_sm)))
    if not geos and fits(1, fs.line_block_smem_bytes(bw, 1, eb, factored)):
        # one stage, no overlap of an item's copy with its compute
        geos.append(geometry(bw, eb, factored, bw, 1, min(items, n_sm)))
    if not factored:
        for rows in (24, 16):
            for stages in (2, 3):
                g = geometry(bw, eb, False, rows, stages,
                             min(items * -(-bw // rows), n_sm * fs._PANEL_CTAS_PER_SM))
                if rows < bw and fits(fs._PANEL_CTAS_PER_SM, g.smem_bytes):
                    geos.append(g)
        return geos
    for c in (2, 3):
        rows = 8 * -(-bw // (8 * c))
        if rows >= bw or -(-bw // rows) != c:
            continue
        for per_sm, stages in ((4, 1), (3, 1), (2, 1), (1, 1), (3, 2), (2, 2)):
            smem = fs.line_block_smem_bytes(bw, stages, 2, True, rows)
            if fits(per_sm, smem):
                geos.append(geometry(bw, eb, True, rows, stages,
                                     c * min(items, n_sm * per_sm // c)))
    return geos


def mid(lib, args, dev, n_sm) -> int:
    g = torch.Generator(device=dev).manual_seed(0)
    bs, S = args.bs, args.lines
    log = open(args.out, "w") if args.out else None

    def out(line):
        (log.write(line + "\n") if log else print(line, flush=True))

    print("width: kernel fastest streamed (CTAs x stages) | fastest row-tiled | picked route "
          "ms (share of bound)", flush=True)
    for m in (7, 5):
        for nt in range(8, 35):
            bw = nt * m
            x = torch.randn((bs, nt * S * m), generator=g, device=dev)
            blocks = torch.randn((bs, S, bw, bw), generator=g, device=dev) / bw
            for key, b, factored in (("K2 f32", blocks, False),
                                     ("K2 bf16", blocks.to(torch.bfloat16), False),
                                     ("K3", blocks.triu().to(torch.bfloat16), True)):
                eb = b.element_size()
                pick = fs.line_block_geometry(bs, S, bw, eb, n_sm, factored)
                geos = mid_geometries(bw, eb, factored, bs * S, n_sm)
                rows, bound = sweep(lib, f"{key} bw {bw} (nt {nt}, m {m})", b, x, nt, factored,
                                    geos + [pick] * (pick not in geos), out)
                best = {}
                for geo, ms in rows:
                    r = "streamed" if geo.route == "streamed" else "tiled"
                    if r not in best or ms < best[r][1]:
                        best[r] = (geo, ms)
                picked = next(ms for geo, ms in rows if geo == pick)
                desc = " | ".join(
                    f"{k} {geo.route} {geo.panel_rows}r {geo.ctas // n_sm or 1}x{geo.stages} "
                    f"{ms:.4f}" for k, (geo, ms) in sorted(best.items()))
                print(f"bw {bw} {key}: {desc} | picked {pick.route} {picked:.4f} "
                      f"({bound / picked:.1%})", flush=True)
            del x, blocks
            torch.cuda.empty_cache()
    if log:
        log.close()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bs", type=int, default=8)
    ap.add_argument("--lines", type=int, default=None)
    ap.add_argument("--nt", type=int, default=50)
    ap.add_argument("--m", type=int, default=7)
    ap.add_argument("--mid", action="store_true")
    ap.add_argument("--out", default=None)
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
    if args.mid:
        args.lines = args.lines or 256
        return mid(lib, args, dev, n_sm)
    g = torch.Generator(device=dev).manual_seed(0)
    bs, S, nt = args.bs, args.lines or 1024, args.nt
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
                geos += [geometry(bw, b.element_size(), False, rows, st, ctas)
                         for st in sorted({2, most}) if 1 <= st <= most]
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
            if fits(per_sm, smem):
                geos.append((rows, stages, C * min(bs * S, n_sm * per_sm // C)))
    sweep(lib, f"K3 bw {bw}", W, x, nt, True,
          [geometry(bw, 2, True, *g_) for g_ in sorted(set(geos))])
    return 0


if __name__ == "__main__":
    sys.exit(main())
