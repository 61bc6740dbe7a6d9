"""Launch geometry of the line-block kernels K2 and K3 (csrc/line_block.cu),
computed in Python by `ops.fused_smoother.line_block_geometry` and passed to
the kernels: shared memory within a Hopper SM's, bytes in flight at the GL
shapes, the 1-D bulk copy chosen only for blocks whose bytes are a multiple
of 16, and blocks too large for one CTA's shared memory streamed in panels
of rows (the row-tiled path).  The kernels themselves run only on the card
(chip_smoke.py holds them against their plain versions there)."""

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
    on the streamed path; one more row and column takes the row-tiled path,
    whose stages fit one CTA's shared memory.  A bad shape still raises."""
    geo = fs.line_block_geometry(1, 1, largest, eb, H100_SMS, factored)
    assert geo.stages == 1 and geo.smem_bytes <= SMEM_PER_BLOCK
    assert geo.panel_rows == largest
    wide = fs.line_block_geometry(1, 1, largest + 1, eb, H100_SMS, factored)
    assert 1 <= wide.panel_rows < largest + 1
    assert wide.smem_bytes == fs.line_block_smem_bytes(largest + 1, wide.stages, eb, factored,
                                                       wide.panel_rows)
    assert wide.smem_bytes <= SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="bad shape"):
        fs.line_block_geometry(0, 4, 56, eb, H100_SMS, factored)


WIDE = {
    # bs, S, bw, entry bytes, factored: chip_smoke.py's wide-block shapes
    # (bw 280 = nt 40 x m 7 and bw 350 = nt 50 x m 7), and a very wide block
    "bw280-k2-f32": (2, 64, 280, 4, False),
    "bw350-k2-f32": (2, 64, 350, 4, False),
    "bw350-k2-bf16": (2, 64, 350, 2, False),
    "bw350-k3": (2, 64, 350, 2, True),
    "bw241-k2-f32": (2, 64, 241, 4, False),
    "bw2000-k3": (1, 2, 2000, 2, True),
}


@pytest.mark.parametrize("case", list(WIDE))
def test_line_block_geometry_tiles_wide_blocks(case):
    """The row-tiled path: panels of fewer rows than the block, as many CTAs
    per SM as shared memory holds, a consumer warp per 32 panel rows within
    the 1024 threads of a CTA, enough panel loads per item that r's
    double buffer is never rewritten early (csrc/line_block.cu
    check_launch), and the bulk copy only where every block and panel
    is a multiple of 16 bytes."""
    bs, S, bw, eb, factored = WIDE[case]
    geo = fs.line_block_geometry(bs, S, bw, eb, H100_SMS, factored)
    rows = geo.panel_rows
    assert 1 <= rows < bw
    assert geo.smem_bytes == fs.line_block_smem_bytes(bw, geo.stages, eb, factored, rows)
    assert geo.smem_bytes <= SMEM_PER_BLOCK
    assert -(-geo.ctas // H100_SMS) * (geo.smem_bytes + 1024) <= SMEM_PER_SM
    assert 1 <= geo.ctas <= bs * S
    assert 32 + -(-rows // 32) * 32 <= 1024
    assert (2 if factored else 1) * -(-bw // rows) >= geo.stages
    assert geo.bulk == (bw * bw * eb % 16 == 0 and rows * bw * eb % 16 == 0)
    if rows >= 32:
        # the panels fill the shared memory of the CTAs that share an SM:
        # one more row would not fit (or would cost one full warp of rows)
        per_sm = SMEM_PER_SM // (geo.smem_bytes + 1024)
        bigger = fs.line_block_smem_bytes(bw, geo.stages, eb, factored, rows + 8)
        assert rows + 8 >= bw or per_sm * (bigger + 1024) > SMEM_PER_SM


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
        return lambda *args: self.calls.append((fn, len(args))) or 0


@pytest.mark.parametrize("nt,m", [(1, 2), (1, 3), (1, 4), (1, 5), (1, 7), (8, 7), (6, 5),
                                  (2, 7), (1, 42)])
def test_block_apply_dispatch(nt, m, monkeypatch):
    """The launcher picks the point-block kernels exactly for nt == 1 at the
    widths they instantiate, which are the n_mi of every VariableSet layout
    (the solver's time lines span at least 6 positions, its point blocks
    one), and the line kernels for every nt > 1, with the argument count
    of the C launcher it calls."""
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
        counted = kernels.point_counted if point else kernels.line_counted
        assert calls == [(fn, len(_cuda._SIGNATURES[lib][fn])), (lib, counted)]


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
