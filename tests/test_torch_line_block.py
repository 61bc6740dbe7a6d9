"""Launch geometry of the line-block kernels K2 and K3 (csrc/line_block.cu),
computed in Python by `ops.fused_smoother.line_block_geometry` and passed to
the kernels: shared memory within a Hopper SM's, bytes in flight at the GL
shapes, the 1-D bulk copy chosen only for blocks whose bytes are a multiple
of 16, and blocks too large for one CTA's shared memory on the row-tiled
kernels their width gives (K2 on (item, panel) units, K3 on a thread-block
cluster or, past 8 CTAs, in two sweeps), each block row computed once.  The
kernels themselves run only on the card (chip_smoke.py holds them against
their plain versions there)."""

import numpy as np
import pytest

from mech_nn_discovery_pde_torch.ops import fused_smoother as fs

H100_SMS = 132
SMEM_PER_BLOCK = 232448  # 227 KB
SMEM_PER_SM = 233472  # 228 KB, 1 KB of it reserved per resident block

CASES = {
    # bs, S, bw, entry bytes, factored (K3), SMs
    "gl-fine-k2-f32": (32, 1024, 56, 4, False, H100_SMS),
    "gl-fine-k2-bf16": (32, 1024, 56, 2, False, H100_SMS),
    "gl-fine-k3": (32, 1024, 56, 2, True, H100_SMS),
    "gl-level1-k2-f32": (32, 256, 56, 4, False, H100_SMS),
    "gl-level1-k3": (32, 256, 56, 2, True, H100_SMS),
    "bw42-k2-f32": (2, 144, 42, 4, False, H100_SMS),
    "bw42-k2-bf16": (2, 144, 42, 2, False, H100_SMS),
    "bw42-k3": (2, 144, 42, 2, True, H100_SMS),
    "tiny": (1, 3, 6, 4, False, 2),
    "tiny-odd-k3": (3, 5, 5, 2, True, 7),
    "one-stage-f32": (2, 4, 224, 4, False, H100_SMS),
}


@pytest.mark.parametrize("case", list(CASES))
def test_line_block_geometry(case):
    bs, S, bw, eb, factored, n_sm = CASES[case]
    geo = fs.line_block_geometry(bs, S, bw, eb, n_sm, factored)
    # shared memory: the kernel's layout, within one block's, and the CTAs
    # that share an SM within the SM's
    assert geo.smem_bytes == fs.line_block_smem_bytes(bw, geo.stages, eb, factored)
    # CTA c walks the items c, c + ctas, ... (csrc/line_block.cu), which
    # takes each item once for any ctas >= 1; ctas <= bs*S leaves none idle
    assert geo.stages >= 1 and 1 <= geo.ctas <= bs * S
    assert geo.smem_bytes <= SMEM_PER_BLOCK
    assert -(-geo.ctas // n_sm) * (geo.smem_bytes + 1024) <= SMEM_PER_SM
    # bulk copies only for blocks whose bytes are a multiple of 16
    assert geo.bulk == (bw * bw * eb % 16 == 0)


@pytest.mark.parametrize("case", [c for c in CASES if c.startswith("gl-")])
def test_line_block_geometry_keeps_bytes_in_flight(case):
    """At the GL shapes every SM holds the same number of CTAs, and together
    they keep at least 32 KB of blocks in flight ((stages - 1) per CTA while
    one is computed on)."""
    bs, S, bw, eb, factored, n_sm = CASES[case]
    geo = fs.line_block_geometry(bs, S, bw, eb, n_sm, factored)
    assert geo.bulk
    assert geo.ctas % n_sm == 0
    assert geo.ctas // n_sm * (geo.stages - 1) * bw * bw * eb >= 32 * 1024


@pytest.mark.parametrize("largest,eb,factored", [(240, 4, False), (339, 2, False), (337, 2, True)],
                         ids=["k2-f32", "k2-bf16", "k3"])
def test_line_block_geometry_rejects_what_does_not_fit(largest, eb, factored):
    """The largest block each kernel stages whole runs one CTA of one stage
    on the streamed path; one more row and column takes a row-tiled kernel
    (K2 the panel kernel, K3 the cluster kernel), whose stages fit one
    CTA's shared memory.  A bad shape still raises."""
    geo = fs.line_block_geometry(1, 1, largest, eb, H100_SMS, factored)
    assert geo.stages == 1 and geo.smem_bytes <= SMEM_PER_BLOCK
    assert geo.panel_rows == largest and geo.route == "streamed"
    wide = fs.line_block_geometry(1, 1, largest + 1, eb, H100_SMS, factored)
    assert 1 <= wide.panel_rows < largest + 1
    assert wide.route == ("cluster" if factored else "panels")
    assert wide.smem_bytes == fs.line_block_smem_bytes(largest + 1, wide.stages, eb, factored,
                                                       wide.panel_rows)
    assert wide.smem_bytes <= SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="bad shape"):
        fs.line_block_geometry(0, 4, 56, eb, H100_SMS, factored)


WIDE = {
    # bs, S, bw, entry bytes, factored: chip_smoke.py's wide-block shapes
    # (bw 280 = nt 40 x m 7 and bw 350 = nt 50 x m 7, at 64 lines and at the
    # long-window layer's fine level, 1024 lines of bs 8; bw 345 and 406:
    # K3 clusters of 4 and 6 CTAs; bw 980: K3 past the cluster), the K3
    # dispatch edges, and a very wide block
    "bw280-k2-f32": (2, 64, 280, 4, False),
    "bw350-k2-f32": (2, 64, 350, 4, False),
    "bw350-k2-bf16": (2, 64, 350, 2, False),
    "bw350-k3": (2, 64, 350, 2, True),
    "long-window-k2-f32": (8, 1024, 350, 4, False),
    "long-window-k2-bf16": (8, 1024, 350, 2, False),
    "long-window-k3": (8, 1024, 350, 2, True),
    "bw241-k2-f32": (2, 64, 241, 4, False),
    "bw345-k3": (2, 6, 345, 2, True),
    "bw406-k3": (2, 6, 406, 2, True),
    "bw980-k2-f32": (2, 2, 980, 4, False),
    "bw980-k3": (2, 2, 980, 2, True),
    "bw512-k3": (1, 3, 512, 2, True),
    "bw513-k3": (1, 3, 513, 2, True),
    "bw640-k3": (1, 3, 640, 2, True),
    "bw641-k3": (1, 3, 641, 2, True),
    "bw916-k3": (1, 2, 916, 2, True),
    "bw917-k3": (1, 2, 917, 2, True),
    "bw2000-k3": (1, 2, 2000, 2, True),
    "bw4000-k2-f32": (1, 2, 4000, 4, False),
}


def _row_cover(geo, bs, S, bw):
    """How often each (item, block row) is computed by the CTAs' walk
    (csrc/line_block.cu): the panel kernel's CTA c takes the units (item,
    panel) c, c + ctas, ...; the cluster kernel's cluster k the items k,
    k + clusters, ..., its CTA j the rows j * rows, ... of each; the
    two-sweep kernel's CTA c the items c, c + ctas, ..., all panels."""
    rows, items = geo.panel_rows, bs * S
    seen = np.zeros((items, bw), dtype=np.int64)
    if geo.route == "panels":
        panels = -(-bw // rows)
        for c in range(geo.ctas):
            for u in range(c, items * panels, geo.ctas):
                it, p = divmod(u, panels)
                seen[it, p * rows:min(bw, (p + 1) * rows)] += 1
    elif geo.route == "cluster":
        clusters = geo.ctas // geo.cluster
        for k in range(clusters):
            for it in range(k, items, clusters):
                for j in range(geo.cluster):
                    seen[it, j * rows:min(bw, (j + 1) * rows)] += 1
    else:
        for c in range(geo.ctas):
            for it in range(c, items, geo.ctas):
                seen[it] += 1
    return seen


@pytest.mark.parametrize("case", list(WIDE))
def test_line_block_geometry_tiles_wide_blocks(case):
    """The row-tiled kernels: fewer rows a stage than the block; shared
    memory as the kernel lays it out, within one CTA's and, for the CTAs
    that share an SM, within the SM's; the route `line_block_route` gives
    for the shape; every (item, block row) computed exactly once by the
    CTAs' walk.  Panel kernel (K2): at most 24 rows, a consumer warp per 4,
    whole units of 16 bytes a stage so every stage (and its r) starts
    16-byte aligned, and room for a panel shifted by up to 15 bytes (the
    bulk copy of its aligned interior).  Cluster kernel (K3): C = ceil(bw /
    rows) <= 8 CTAs hold the block (C rows >= bw), each some rows, whole
    clusters.  Two-sweep kernel: a consumer warp per 32 panel rows, enough
    panel loads per item that r's double buffer is never rewritten early,
    and the bulk copy only where every block and panel is a multiple of 16
    bytes."""
    bs, S, bw, eb, factored = WIDE[case]
    geo = fs.line_block_geometry(bs, S, bw, eb, H100_SMS, factored)
    rows = geo.panel_rows
    assert 1 <= rows < bw
    assert geo.route == fs.line_block_route(bw, rows, factored)
    assert geo.smem_bytes == fs.line_block_smem_bytes(bw, geo.stages, eb, factored, rows)
    assert geo.smem_bytes <= SMEM_PER_BLOCK
    assert geo.stages >= 1
    if geo.route == "panels":
        assert not factored and rows <= 24 and (rows % 8 == 0 or bw > 3000)
        assert 1 <= geo.ctas <= bs * S * -(-bw // rows)
        per_sm = -(-geo.ctas // H100_SMS)
        assert per_sm * (geo.smem_bytes + 1024) <= SMEM_PER_SM
        assert 32 + 32 * -(-rows // 4) <= 224 and geo.bulk
        stage = (geo.smem_bytes - 16 * geo.stages) // geo.stages
        assert stage % 16 == 0 and stage - 4 * bw >= rows * bw * eb + 15
        if rows % 8 == 0 and rows < 24:
            # 8 more rows would not leave each CTA of the SM 2 stages
            bigger = fs.line_block_smem_bytes(bw, 2, eb, False, rows + 8)
            assert per_sm * (bigger + 1024) > SMEM_PER_SM
    elif geo.route == "cluster":
        assert factored and eb == 2 and geo.bulk
        C = geo.cluster
        assert 2 <= C <= 8 and C == -(-bw // rows) and C * rows >= bw > (C - 1) * rows
        assert geo.stages == 1 and geo.ctas % C == 0
        per_sm = -(-geo.ctas // H100_SMS)
        assert 1 <= geo.ctas // C <= min(bs * S, 3 * H100_SMS // C)
        assert per_sm <= 3 and per_sm * (geo.smem_bytes + 1024) <= SMEM_PER_SM
        if bs * S >= H100_SMS:
            # the most CTAs an SM: one more would not fit
            assert per_sm == 3 or (per_sm + 1) * (geo.smem_bytes + 1024) > SMEM_PER_SM
    else:
        assert geo.route == "two_sweep" and factored
        assert -(-bw // rows) > 8
        assert 1 <= geo.ctas <= bs * S
        assert -(-geo.ctas // H100_SMS) * (geo.smem_bytes + 1024) <= SMEM_PER_SM
        assert 32 + -(-rows // 32) * 32 <= 1024
        assert 2 * -(-bw // rows) >= geo.stages
        assert geo.bulk == (bw * bw * eb % 16 == 0 and rows * bw * eb % 16 == 0)
    if bs * S * bw <= 64 * 64 * 350:
        assert (_row_cover(geo, bs, S, bw) == 1).all()


@pytest.mark.parametrize("bw,route", [(337, "streamed"), (338, "cluster"), (916, "cluster"),
                                      (917, "two_sweep")])
def test_k3_dispatch_edge(bw, route):
    """K3's kernel follows from the width alone, with the edges the
    geometry's docstring states: the streamed kernel to bw 337, a cluster
    of up to 8 CTAs (W read once) to bw 916, the two-sweep kernel above,
    at any batch."""
    for bs, S in ((1, 1), (8, 1024)):
        assert fs.line_block_geometry(bs, S, bw, 2, H100_SMS, True).route == route
    doc = " ".join(fs.line_block_geometry.__doc__.split())
    assert "<= 337 for K3" in doc and "up to bw 916" in doc


# ---- the point-block kernels (csrc/point_block.cu): nt == 1, bw = n_mi

POINT_CASES = {
    # bs, N (items a sample), bw, entry bytes, factored (K3), SMs
    "gl-fine-k2-f32": (32, 8192, 7, 4, False, H100_SMS),
    "gl-fine-k2-bf16": (32, 8192, 7, 2, False, H100_SMS),
    "gl-fine-k3": (32, 8192, 7, 2, True, H100_SMS),
    "gl-level1-k2-f32": (32, 2048, 7, 4, False, H100_SMS),
    "gl-level1-k2-bf16": (32, 2048, 7, 2, False, H100_SMS),
    "gl-level1-k3": (32, 2048, 7, 2, True, H100_SMS),
    "gl-level2-k2-f32": (32, 512, 7, 4, False, H100_SMS),
    "sp2-slab-k2-f32": (32, 4096, 7, 4, False, H100_SMS),
    "transport-bw5-k2-f32": (5, 4096, 5, 4, False, H100_SMS),
    "transport-bw5-k3": (5, 4096, 5, 2, True, H100_SMS),
    "bw2-k2-bf16": (3, 1001, 2, 2, False, H100_SMS),
    "bw3-k3": (2, 333, 3, 2, True, H100_SMS),
    "bw4-k2-f32": (2, 999, 4, 4, False, 7),
    "partial-tile-bw7": (3, 37, 7, 4, False, H100_SMS),
    "under-one-tile-k3": (1, 5, 7, 2, True, H100_SMS),
}
GL_POINT = [c for c in POINT_CASES if c.startswith("gl-") and "level2" not in c]


@pytest.mark.parametrize("case", list(POINT_CASES))
def test_point_block_geometry(case):
    """Shared memory within a block's and, for the CTAs that share an SM,
    within the SM's; one consumer thread per block row of a tile of a
    multiple of 32 items (whole warps, the named barrier's unit); the bulk
    copy only where every full tile's blocks and r are multiples of 16
    bytes at 16-byte offsets; and the walk of CTA c over the tiles c,
    c + ctas, ... takes every item exactly once."""
    bs, N, bw, eb, factored, n_sm = POINT_CASES[case]
    geo = fs.point_block_geometry(bs, N, bw, eb, n_sm, factored)
    tile = geo.tile
    assert tile % 32 == 0 and tile * bw <= 256
    assert geo.smem_bytes == fs.point_block_smem_bytes(bw, tile, geo.stages, eb, factored)
    assert geo.smem_bytes <= SMEM_PER_BLOCK
    assert -(-geo.ctas // n_sm) * (geo.smem_bytes + 1024) <= SMEM_PER_SM
    assert 1 <= geo.stages <= 8
    items = bs * N
    n_tiles = -(-items // tile)
    assert 1 <= geo.ctas <= n_tiles
    full = items // tile
    aligned = all(t * tile * bw * bw * eb % 16 == 0 and t * tile * bw * 4 % 16 == 0
                  for t in range(full + 1))
    assert geo.bulk == (aligned and tile * bw * bw * eb % 16 == 0 and tile * bw * 4 % 16 == 0)
    seen = np.zeros(items, dtype=np.int64)
    for c in range(geo.ctas):
        for t in range(c, n_tiles, geo.ctas):
            seen[t * tile:min(items, (t + 1) * tile)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("case", GL_POINT)
def test_point_block_geometry_keeps_bytes_in_flight(case):
    """At the GL point shapes (fine level and level 1) every SM holds the
    same number of CTAs, and together they keep at least 32 KB of blocks in
    flight ((stages - 1) tiles per CTA while one is computed on)."""
    bs, N, bw, eb, factored, n_sm = POINT_CASES[case]
    geo = fs.point_block_geometry(bs, N, bw, eb, n_sm, factored)
    assert geo.bulk and geo.ctas % n_sm == 0
    assert geo.ctas // n_sm * (geo.stages - 1) * geo.tile * bw * bw * eb >= 32 * 1024


class _FakeLib:
    """Records the launcher a block apply calls (and its argument count)."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, fn):
        return lambda *args: self.calls.append((fn, len(args), args)) or 0


@pytest.mark.parametrize("nt,m", [(1, 2), (1, 3), (1, 4), (1, 5), (1, 7), (8, 7), (6, 5),
                                  (2, 7), (1, 42), (40, 7), (50, 7)])
def test_block_apply_dispatch(nt, m, monkeypatch):
    """The launcher picks the point-block kernels exactly for nt == 1 at the
    widths they instantiate, which are the n_mi of every VariableSet layout
    (the solver's time lines span at least 6 positions, its point blocks
    one), and the line kernels for every nt > 1, with the argument count
    of the C launcher it calls, the geometry's launch arguments, and the
    launch counted under the kernel of its route (at bw 280 and 350 the
    row-tiled ones)."""
    import torch

    from mech_nn_discovery_pde_torch.ops import _cuda
    from mech_nn_discovery_pde_torch.ops.multi_index import VariableSet

    assert sorted({VariableSet((8,) * n, o).n_mi for n in (1, 2, 3) for o in (1, 2)}) == list(
        fs.POINT_WIDTHS)
    calls = []
    monkeypatch.setattr(_cuda, "require_cuda", lambda *t: None)
    monkeypatch.setattr(_cuda, "sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(_cuda, "library", lambda name: _FakeLib(calls))
    monkeypatch.setattr(_cuda, "check", lambda name, kernel, code: calls.append((name, kernel)))
    bs, S, bw = 2, 5, nt * m
    r = torch.zeros((bs, nt * S * m))
    point = nt == 1 and m in fs.POINT_WIDTHS
    assert fs.point_path(nt, bw) == point
    bf16 = torch.bfloat16
    for kernels, dtype in ((fs._K2_FN[torch.float32], torch.float32),
                           (fs._K2_FN[bf16], bf16), (fs._K3_FN, bf16)):
        calls.clear()
        fs._launch_line_block(kernels, torch.zeros((bs, S, bw, bw), dtype=dtype), r, nt, None,
                              None, None)
        lib = "point_block" if point else "line_block"
        fn = kernels.point_fn if point else kernels.line_fn
        (called, n_args, args), counted_call = calls
        assert (called, n_args) == (fn, len(_cuda._SIGNATURES[lib][fn]))
        if point:
            assert counted_call == (lib, kernels.point_counted)
            continue
        geo = fs.line_block_geometry(bs, S, bw, torch.empty((), dtype=dtype).element_size(),
                                     H100_SMS, kernels.factored)
        assert args[5:14] == (m, nt, S, bs, geo.ctas, geo.panel_rows, geo.stages,
                              geo.smem_bytes, int(geo.bulk))
        assert counted_call == (lib, kernels.line_counted[geo.route])
        assert (geo.route != "streamed") == (bw > {torch.float32: 240, bf16: 339}[dtype]
                                             if not kernels.factored else bw > 337)


def _bank_ways(byte_addrs):
    """Shared-memory wavefronts of one warp-wide load: the most distinct
    4-byte words any of the 32 banks is asked for (one word is a broadcast)."""
    banks = {}
    for a in byte_addrs:
        banks.setdefault(a // 4 % 32, set()).add(a // 4)
    return max(len(w) for w in banks.values())


@pytest.mark.parametrize("bw", fs.POINT_WIDTHS)
def test_point_block_shared_memory_banks(bw):
    """Each warp-wide shared-memory load of the point kernels, with the
    column order point_block.cu uses (thread q of a tile starts its row at
    column (q bw / 32) mod bw at an even bw, at 0 at an odd one, and wraps):
    K2's block rows and r conflict-free in f32 and at most 2-way in bf16;
    K3's (bf16) pass-1 columns and pass-2 rows, where the lanes whose step
    falls outside the upper triangle read nothing, at most 2-way."""
    consumers = fs.point_block_geometry(1, 1024, bw, 4, H100_SMS).tile * bw
    for eb, ways in ((4, 1), (2, 2)):
        for warp in range(consumers // 32):
            qs = range(32 * warp, 32 * warp + 32)
            for c in range(bw):
                col = [(c + (q * bw * eb // 128 % bw if bw % 2 == 0 else 0)) % bw for q in qs]
                assert _bank_ways([(q * bw + j) * eb for q, j in zip(qs, col)]) <= ways
                assert _bank_ways([(q // bw * bw + j) * 4 for q, j in zip(qs, col)]) == 1
                if eb == 2:  # K3: pass 1 reads W[c, j] (c <= j), pass 2 W[i, col] (col >= i)
                    assert _bank_ways([((q // bw * bw + c) * bw + q % bw) * 2
                                       for q in qs if c <= q % bw]) <= 2
                    assert _bank_ways([(q * bw + j) * 2 for q, j in zip(qs, col)
                                       if j >= q % bw]) <= 2
