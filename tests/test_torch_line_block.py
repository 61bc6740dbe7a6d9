"""Launch geometry of the line-block kernels K2 and K3 (csrc/line_block.cu),
computed in Python by `ops.fused_smoother.line_block_geometry` and passed to
the kernels: shared memory within a Hopper SM's, bytes in flight at the GL
shapes, the 1-D bulk copy chosen only for blocks whose bytes are a multiple
of 16, and blocks too large for one CTA's shared memory streamed in panels
of rows (the row-tiled path).  The kernels themselves run only on the card
(chip_smoke.py holds them against their plain versions there)."""

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
