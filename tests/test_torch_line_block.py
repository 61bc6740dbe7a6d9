"""Launch geometry of the line-block kernels K2 and K3 (csrc/line_block.cu),
computed in Python by `ops.fused_smoother.line_block_geometry` and passed to
the kernels: shared memory within a Hopper SM's, bytes in flight, every
block moved by a bulk copy (of the whole block where all are 16-byte
aligned, else of its aligned interior), the streamed kernels' column walks
at most 2-way bank-conflicted, the GL shapes' geometry pinned, and blocks
wider than the streamed ring holds in 2 stages of 2 CTAs an SM on the
row-tiled kernels their width gives (K2 on (item, panel) units, K3 on a
thread-block cluster or, past 8 CTAs, in two sweeps), each block row
computed once; and the plain block applies at odd nt against the JAX
package's.  The kernels themselves run only on the card (chip_smoke.py
holds them against their plain versions there)."""

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


def _per_sm(geo, n_sm):
    return -(-geo.ctas // n_sm)


def _in_flight(geo, bw, eb):
    """Bytes of blocks (panels) in flight per SM while each CTA computes on
    one: (stages - 1) a CTA."""
    unit = {"streamed": bw, "panels": geo.panel_rows}[geo.route]
    return _per_sm(geo, H100_SMS) * (geo.stages - 1) * unit * bw * eb


@pytest.mark.parametrize("case", list(CASES))
def test_line_block_geometry(case):
    bs, S, bw, eb, factored, n_sm = CASES[case]
    geo = fs.line_block_geometry(bs, S, bw, eb, n_sm, factored)
    # shared memory: the kernel's layout, within one block's, and the CTAs
    # that share an SM within the SM's
    assert geo.route == fs.line_block_route(bw, geo.panel_rows, factored)
    assert geo.smem_bytes == fs.line_block_smem_bytes(bw, geo.stages, eb, factored,
                                                      geo.panel_rows)
    # CTA c walks the items c, c + ctas, ... (csrc/line_block.cu), which
    # takes each item once for any ctas >= 1; ctas <= bs*S leaves none idle
    # (the panel kernel's units: bs*S*panels)
    units = bs * S * (-(-bw // geo.panel_rows) if geo.route == "panels" else 1)
    assert geo.stages >= 1 and 1 <= geo.ctas <= units
    assert geo.smem_bytes <= SMEM_PER_BLOCK
    assert -(-geo.ctas // n_sm) * (geo.smem_bytes + 1024) <= SMEM_PER_SM
    # every block by a bulk copy: of the whole block where all are 16-byte
    # aligned (bytes a multiple of 16 at an aligned pointer), else of its
    # aligned interior, the stage holding 16 more bytes for the shift
    assert geo.bulk
    if geo.route == "streamed":
        whole = bw * bw * eb % 16 == 0
        assert fs.line_block_launch_args(geo, bw, eb, factored, 1 << 20) == (
            geo.smem_bytes, int(whole) | geo.walk << 1)
        smem, flags = fs.line_block_launch_args(geo, bw, eb, factored, (1 << 20) + eb)
        assert flags == geo.walk << 1
        assert smem == geo.smem_bytes + (16 * geo.stages if whole else 0)


# the GL shapes' streamed geometry (ctas, stages, smem_bytes, walk): as
# before the mid-width redesign, so their launches and sums stay the same
GL_PINNED = {
    "gl-fine-k2-f32": (1056, 2, 25568, 1),
    "gl-fine-k2-bf16": (1056, 2, 13024, 1),
    "gl-fine-k3": (1056, 2, 13472, 0),
    "gl-level1-k2-f32": (1056, 2, 25568, 1),
    "gl-level1-k3": (1056, 2, 13472, 0),
    "bw42-k2-f32": (288, 2, 14496, 1),
    "bw42-k2-bf16": (288, 2, 7488, 1),
    "bw42-k3": (288, 2, 7824, 0),
}


@pytest.mark.parametrize("case", list(GL_PINNED))
def test_line_block_geometry_pinned_at_gl_shapes(case):
    """The GL fine level and level 1 (bw 56) and the odd shape bw 42 keep
    the streamed kernels' geometry, CTAs, stages and shared memory as
    before, and their column walk (K2 thread i from column i; K3 pass 2
    from the diagonal up); bw 42's bf16 stage grew by 16 bytes for the
    shifted copy of its 3,528-byte blocks.  The transport example's bw 40
    keeps them too."""
    bs, S, bw, eb, factored, n_sm = CASES[case]
    geo = fs.line_block_geometry(bs, S, bw, eb, n_sm, factored)
    assert geo.route == "streamed" and geo.panel_rows == bw
    assert (geo.ctas, geo.stages, geo.smem_bytes, geo.walk) == GL_PINNED[case]
    for eb, factored in ((4, False), (2, False), (2, True)):
        geo = fs.line_block_geometry(5, 512, 40, eb, H100_SMS, factored)
        assert (geo.route, geo.ctas, geo.stages, geo.walk) == ("streamed", 1056, 2,
                                                               0 if factored else 1)


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


# the widest block of the streamed kernels (their crossover to the row-tiled
# ones) and of one CTA's shared memory, by kernel
STREAMED = {"k2-f32": (137, 240, 4, False), "k2-bf16": (240, 339, 2, False),
            "k3": (168, 337, 2, True)}


@pytest.mark.parametrize("largest,eb,factored", [(240, 4, False), (339, 2, False), (337, 2, True)],
                         ids=["k2-f32", "k2-bf16", "k3"])
def test_line_block_geometry_rejects_what_does_not_fit(largest, eb, factored):
    """The largest block one CTA could stage whole (bw 240 in f32, 339 in
    bf16, 337 for K3) no longer takes the streamed kernel, whose ring would
    hold one stage: it takes a row-tiled kernel (K2 the panel kernel, K3
    the cluster kernel), and so does one more row and column.  The streamed
    kernels' widest block (bw 137 in f32: one CTA of 3 stages; 240 in bf16:
    one CTA of 2; 168 for K3: 2 CTAs of 2) keeps a block in flight while
    one is computed on, 2 in f32 and K3; one more row and column takes the
    row-tiled kernel.  Their stages fit one CTA's shared memory.  A bad
    shape still raises."""
    widest = {240: 137, 339: 240, 337: 168}[largest]
    geo = fs.line_block_geometry(1, 1, widest, eb, H100_SMS, factored)
    assert geo.panel_rows == widest and geo.route == "streamed"
    per_sm = (SMEM_PER_SM // (geo.smem_bytes + 1024), geo.stages)
    assert per_sm == {137: (1, 3), 240: (1, 2), 168: (2, 2)}[widest]
    for bw in (widest + 1, largest, largest + 1):
        wide = fs.line_block_geometry(1, 1, bw, eb, H100_SMS, factored)
        assert 1 <= wide.panel_rows < bw
        assert wide.route == ("cluster" if factored else "panels")
        assert wide.smem_bytes == fs.line_block_smem_bytes(bw, wide.stages, eb, factored,
                                                           wide.panel_rows)
        assert wide.smem_bytes <= SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="bad shape"):
        fs.line_block_geometry(0, 4, 56, eb, H100_SMS, factored)


@pytest.mark.parametrize("kernel", list(STREAMED))
def test_line_block_geometry_every_width(kernel):
    """Every width one CTA could stage whole, at the long window's level-1
    batch (bs 8 x 256 lines): the route `line_block_route` gives for the
    geometry's rows, streamed exactly to the kernel's crossover; every
    block by a bulk copy (`bulk`; the whole block at an aligned pointer
    where its bytes are a multiple of 16); from bw 56 up, at least 32 KB
    of blocks (panels) in flight per SM while each CTA computes on one, on
    the streamed and panel routes of more than one stage (the cluster
    kernel's geometry follows its own rule, measured latency-bound:
    test_line_block_geometry_tiles_wide_blocks)."""
    widest, largest, eb, factored = STREAMED[kernel]
    for bw in range(1, largest + 1):
        geo = fs.line_block_geometry(8, 256, bw, eb, H100_SMS, factored)
        assert geo.route == fs.line_block_route(bw, geo.panel_rows, factored)
        assert (geo.route == "streamed") == (bw <= widest), bw
        assert geo.bulk
        smem, flags = fs.line_block_launch_args(geo, bw, eb, factored, 1 << 20)
        assert smem == geo.smem_bytes
        if geo.route == "streamed":
            assert flags & 1 == (bw * bw * eb % 16 == 0)
        if bw >= 56 and (geo.stages > 1 or bw <= widest) and geo.route != "cluster":
            assert _in_flight(geo, bw, eb) >= 32 * 1024, (bw, geo)


def _naive_ways(addrs):
    """Wavefronts of one warp-wide load, lane by lane."""
    banks = {}
    for a in addrs:
        banks.setdefault(a // 4 % 32, set()).add(a // 4)
    return max(len(w) for w in banks.values())


@pytest.mark.parametrize("kernel", list(STREAMED))
def test_line_block_walk_banks(kernel):
    """At every width the streamed kernel takes, its column walk
    (`line_block_walk`) keeps each warp-wide shared-memory load at most
    2-way bank-conflicted (`line_block_bank_ways`: K2's block rows and r;
    K3's pass-1 columns and pass-2 rows and u), at every placement of the
    block in its stage.  The GL widths keep their walk.  The bank function
    agrees with a lane-by-lane count on K2's 16-way skew at bw 175 in f32
    (rows 176 words apart from diagonal to diagonal) and on K3's pass 2
    from the diagonal at bw 63 (rows 32 bf16 words apart)."""
    widest, _, eb, factored = STREAMED[kernel]
    for bw in range(1, widest + 1):
        walk = fs.line_block_walk(bw, eb, factored)
        assert fs.line_block_bank_ways(bw, eb, factored, walk) <= 2, (bw, walk)
    for bw in (40, 42, 56):
        assert fs.line_block_walk(bw, eb, factored) == (0 if factored else 1)
    assert fs.line_block_bank_ways(175, 4, False, 1) == _naive_ways(
        [(i * 175 + (i + 0) % 175) * 4 for i in range(32)]) == 16
    assert fs.line_block_bank_ways(63, 2, True, 0) == max(
        _naive_ways([shift + (i * 63 + i + q) * 2 for i in range(w0, min(63, w0 + 32))
                     if i + q < 63])
        for shift in (0, 2) for w0 in (0, 32) for q in range(63)
        if any(i + q < 63 for i in range(w0, min(63, w0 + 32)))) > 2


# nt of the plain-versus-JAX test, and its m where not 7: the odd nt 3 and 5
# (bw 21 and 35), then K3's cluster widths bw 169, 175, 350 and 916, where
# its W is packed
PLAIN_NT = {3: 7, 5: 7, 13: 13, 25: 7, 50: 7, 229: 4}


@pytest.mark.parametrize("nt", list(PLAIN_NT))
@pytest.mark.parametrize("factored", [False, True], ids=["k2", "k3"])
def test_plain_block_apply_odd_nt_matches_jax(nt, factored):
    """At odd nt (bw 21 and 35 at m 7: blocks whose bytes are not a multiple
    of 16 in f32 and bf16) and at K3's cluster widths (bw 169, 175, 350 and
    916), K2's and K3's plain versions equal the JAX package's line-block
    route (`MultigridSolver._block_apply`, per sample) in f64 within 1e-10,
    on random blocks (upper-triangular for K3) of bs 2 and S 3 lines, with
    and without the Chebyshev epilogue.  Where K3's W is stored packed
    (`factored_layout`), its plain version on the packed bf16 W equals it on
    the dense one bit for bit in f32, with and without the epilogue."""
    import types

    import jax.numpy as jnp
    import torch

    from mech_nn_discovery_pde_tpu.ops.system import PDESystem as JaxSystem
    from mech_nn_discovery_pde_tpu.solvers.multigrid import MultigridSolver as JaxSolver

    m, bs, S = PLAIN_NT[nt], 2, 3
    bw = nt * m
    rng = np.random.default_rng(nt + 10 * factored)
    blocks = rng.standard_normal((bs, S, bw, bw)) / bw
    if factored:
        blocks = np.triu(blocks)
    r = rng.standard_normal((bs, nt * S * m))
    x0 = rng.standard_normal((bs, nt * S * m))
    var_set = types.SimpleNamespace(coord_dims=(nt, 3, 1), n_mi=m)
    sysk = types.SimpleNamespace(var_set=var_set)
    sysk.line_vec_to_blocks = lambda v, axis=0: JaxSystem.line_vec_to_blocks(sysk, v, axis)
    sysk.line_blocks_to_vec = lambda z, axis=0: JaxSystem.line_blocks_to_vec(sysk, z, axis)
    solver = types.SimpleNamespace(config=types.SimpleNamespace(mg_block_smoother="line"),
                                   _factored_binv=factored)
    want = np.stack([np.asarray(JaxSolver._block_apply(solver, sysk, jnp.asarray(blocks[b]),
                                                       jnp.asarray(r[b]))) for b in range(bs)])
    plain = fs.factored_block_apply_plain if factored else fs.block_apply_plain
    tb, tr = torch.tensor(blocks), torch.tensor(r)

    def rel(a, b):
        a = a.numpy() if hasattr(a, "numpy") else a
        return float(np.abs(a - b).max() / np.abs(b).max())

    assert rel(plain(tb, tr, nt), want) <= 1e-10
    c1 = torch.tensor([0.5, -2.0], dtype=torch.float64)
    c2 = torch.tensor([3.0, 0.25], dtype=torch.float64)
    d = torch.tensor(x0)
    plain(tb, tr, nt, d=d, c1=c1, c2=c2)
    assert rel(d, c1[:, None].numpy() * x0 + c2[:, None].numpy() * want) <= 1e-10
    packed = factored and fs.factored_layout(nt, bw) == "packed"
    assert packed == (factored and bw > 168)
    if packed:
        w = tb.to(torch.bfloat16)
        wp = fs.pack_upper(w)
        assert tuple(wp.shape) == (bs, S, fs.packed_off(bw, bw))
        r32, x32 = tr.float(), torch.tensor(x0, dtype=torch.float32)
        assert torch.equal(plain(wp, r32, nt), plain(w, r32, nt))
        d_p, d_d = x32.clone(), x32.clone()
        plain(wp, r32, nt, d=d_p, c1=c1.float(), c2=c2.float())
        plain(w, r32, nt, d=d_d, c1=c1.float(), c2=c2.float())
        assert torch.equal(d_p, d_d)


@pytest.mark.parametrize("bw", [1, 2, 7, 169, 350, 916])
def test_pack_upper_round_trips(bw):
    """`pack_upper` keeps each block's upper triangle, row i from
    `packed_off(bw, i)` (a multiple of 8 entries): W[i, i:] after i mod 8
    zeros, then zeros to the width rounded up to 8, also from a transposed
    view (the solver packs (L^-1)^T without forming it); `unpack_upper`
    gives the blocks back exactly, zero below the diagonal; `packed_width`
    reads bw back."""
    import torch

    g = torch.Generator().manual_seed(bw)
    w = torch.randn((2, 3, bw, bw), generator=g).to(torch.bfloat16).triu()
    wp = fs.pack_upper(w)
    bwp = -(-bw // 8) * 8
    assert wp.dtype == w.dtype and tuple(wp.shape) == (2, 3, fs.packed_off(bw, bw))
    assert fs.packed_width(wp.shape[-1]) == bw
    for i in {0, bw // 2, bw - 1}:
        o, a = fs.packed_off(bw, i), i // 8 * 8
        assert o % 8 == 0 and fs.packed_off(bw, i + 1) - o == bwp - a
        assert torch.equal(wp[..., o + i - a:o + i - a + bw - i], w[..., i, i:])
        assert not wp[..., o:o + i - a].any() and not wp[..., o + bw - a:o + bwp - a].any()
    assert torch.equal(fs.unpack_upper(wp), w)
    assert torch.equal(fs.pack_upper(w.transpose(-1, -2).contiguous().transpose(-1, -2)), wp)
    with pytest.raises(ValueError, match="no packed upper triangle"):
        fs.packed_width(fs.packed_off(bw, bw) + 1)


WIDE = {
    # bs, S, bw, entry bytes, factored: chip_smoke.py's wide-block shapes
    # (bw 280 = nt 40 x m 7 and bw 350 = nt 50 x m 7, at 64 lines and at the
    # long-window layer's fine level, 1024 lines of bs 8; bw 345 and 406:
    # K3 clusters of 4 and 6 CTAs; bw 980: K3 past the cluster), the K3
    # dispatch edges, and a very wide block; the long window's level 1, bw
    # 175, in f32 and for K3 (clusters of 2 CTAs of 2 stages, which bw 190
    # no longer holds)
    "bw280-k2-f32": (2, 64, 280, 4, False),
    "bw350-k2-f32": (2, 64, 350, 4, False),
    "bw350-k2-bf16": (2, 64, 350, 2, False),
    "bw350-k3": (2, 64, 350, 2, True),
    "long-window-k2-f32": (8, 1024, 350, 4, False),
    "long-window-k2-bf16": (8, 1024, 350, 2, False),
    "long-window-k3": (8, 1024, 350, 2, True),
    "level1-k2-f32": (8, 256, 175, 4, False),
    "level1-k3": (8, 256, 175, 2, True),
    "bw190-k3": (2, 64, 190, 2, True),
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
    k + clusters, ..., its CTA j the rows of `cluster_rows` from its j-th
    boundary; the two-sweep kernel's CTA c the items c, c + ctas, ..., all
    panels."""
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
        b = fs.cluster_rows(bw, geo.cluster)
        for k in range(clusters):
            for it in range(k, items, clusters):
                for j in range(geo.cluster):
                    seen[it, b[j]:b[j + 1]] += 1
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
        assert 1 <= geo.stages <= 2 and geo.ctas % C == 0
        per_sm = -(-geo.ctas // H100_SMS)
        assert 1 <= geo.ctas // C <= min(bs * S, 2 * H100_SMS // C)
        assert per_sm <= 2 and per_sm * (geo.smem_bytes + 1024) <= SMEM_PER_SM
        # 2 CTAs an SM where any cluster's rows fit them, the smallest such C,
        # and a second stage where it fits too
        budget = lambda k: min(SMEM_PER_SM // k - 1024, SMEM_PER_BLOCK)  # noqa: E731
        smem = lambda c, st: fs.line_block_smem_bytes(bw, st, 2, True, -(-bw // c))  # noqa: E731
        fit = [c for c in range(2, 9) if smem(c, 1) <= budget(2)]
        if fit:
            assert C == fit[0]
            if bs * S >= H100_SMS:
                assert per_sm == 2
        assert (geo.stages == 2) == (smem(C, 2) <= budget(2 if fit else 1))
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


@pytest.mark.parametrize("bw,route", [(168, "streamed"), (169, "cluster"), (175, "cluster"),
                                      (337, "cluster"), (338, "cluster"), (916, "cluster"),
                                      (917, "two_sweep")])
def test_k3_dispatch_edge(bw, route):
    """K3's kernel follows from the width alone, with the edges the
    geometry's docstring states: the streamed kernel to bw 168 (2 stages in
    2 CTAs an SM), a cluster of up to 8 CTAs (W read once) to bw 916, the
    two-sweep kernel above, at any batch."""
    for bs, S in ((1, 1), (8, 1024)):
        assert fs.line_block_geometry(bs, S, bw, 2, H100_SMS, True).route == route
    doc = " ".join(fs.line_block_geometry.__doc__.split())
    assert "<= 168 for K3" in doc and "up to bw 916" in doc


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
                                  (2, 7), (1, 42), (40, 7), (50, 7), (25, 7), (3, 7)])
def test_block_apply_dispatch(nt, m, monkeypatch):
    """The launcher picks the point-block kernels exactly for nt == 1 at the
    widths they instantiate, which are the n_mi of every VariableSet layout
    (the solver's time lines span at least 6 positions, its point blocks
    one), and the line kernels for every nt > 1, with the argument count
    of the C launcher it calls, the geometry's launch arguments, and the
    launch counted under the kernel of its route (at bw 280 and 350 the
    row-tiled ones; the launch's shared memory and flags those of
    `line_block_launch_args` for the blocks' address).  K3's W is packed
    exactly where its route is the cluster kernel (bw 175, 280 and 350:
    `factored_layout`), and the launcher refuses W in the other layout."""
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
        blocks = torch.zeros((bs, S, bw, bw), dtype=dtype)
        if kernels.factored and fs.factored_layout(nt, bw) == "packed":
            with pytest.raises(ValueError, match="stored packed"):
                fs._launch_line_block(kernels, blocks, r, nt, None, None, None)
            blocks = fs.pack_upper(blocks)
        fs._launch_line_block(kernels, blocks, r, nt, None, None, None)
        lib = "point_block" if point else "line_block"
        fn = kernels.point_fn if point else kernels.line_fn
        (called, n_args, args), counted_call = calls
        assert (called, n_args) == (fn, len(_cuda._SIGNATURES[lib][fn]))
        if point:
            assert counted_call == (lib, kernels.point_counted)
            continue
        eb = torch.empty((), dtype=dtype).element_size()
        geo = fs.line_block_geometry(bs, S, bw, eb, H100_SMS, kernels.factored)
        assert args[5:14] == (m, nt, S, bs, geo.ctas, geo.panel_rows, geo.stages,
                              *fs.line_block_launch_args(geo, bw, eb, kernels.factored, args[0]))
        assert counted_call == (lib, kernels.line_counted[geo.route])
        assert (geo.route != "streamed") == (bw > {torch.float32: 137, bf16: 240}[dtype]
                                             if not kernels.factored else bw > 168)
        if kernels.factored:
            assert (blocks.ndim == 3) == (geo.route == "cluster")


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


def test_cluster_shares_are_even():
    """At every width the cluster kernel takes (bw 169 to 916), the split
    `cluster_rows` gives each CTA of the cluster contiguous rows, together
    every row once, whose packed entries are within 10 % of the mean share
    of the packed block (or within one of its rows of it); the launch's rows are
    ceil(bw / C), from which C follows; the layout, sized for the largest
    share and the most rows, fits a CTA's shared memory and, for the CTAs
    an SM holds, the SM's."""
    for bw in range(169, 917):
        geo = fs.line_block_geometry(8, 1024, bw, 2, H100_SMS, True)
        assert geo.route == "cluster", bw
        C = geo.cluster
        assert geo.panel_rows == -(-bw // C) and -(-bw // geo.panel_rows) == C
        b = fs.cluster_rows(bw, C)
        assert b[0] == 0 and b[-1] == bw and all(b[c] < b[c + 1] for c in range(C)), (bw, b)
        mean = fs.packed_off(bw, bw) / C
        for c in range(C):
            share = fs.packed_off(bw, b[c + 1]) - fs.packed_off(bw, b[c])
            row = fs.packed_off(bw, b[c] + 1) - fs.packed_off(bw, b[c])
            assert abs(share - mean) <= max(0.1 * mean, row), (bw, C, b)
        assert geo.smem_bytes <= SMEM_PER_BLOCK
        assert _per_sm(geo, H100_SMS) * (geo.smem_bytes + 1024) <= SMEM_PER_SM


# the long window's cluster geometries (tools/line_block_sweep.py --k3 on an
# H100): ctas, stages, shared memory, cluster, launch rows, the split
LONG_WINDOW_PINNED = {
    "level0": ((8, 1024, 350), (264, 1, 83392, 2, 175, (0, 104, 350))),
    "level1": ((8, 256, 175), (264, 2, 43024, 2, 88, (0, 53, 175))),
}


@pytest.mark.parametrize("level", list(LONG_WINDOW_PINNED))
def test_cluster_geometry_pinned_at_the_long_window(level):
    """K3 at the long window's smoothed levels: the fine level's bw 350 on
    clusters of 2 CTAs of one stage (2 an SM), level 1's bw 175 on clusters
    of 2 of 2 stages, each CTA an equal share of the packed block (bw 350:
    rows 0-103 and 104-349; bw 175: 0-52 and 53-174), the fastest the
    sweep found."""
    (bs, S, bw), (ctas, stages, smem, C, rows, split) = LONG_WINDOW_PINNED[level]
    geo = fs.line_block_geometry(bs, S, bw, 2, H100_SMS, True)
    assert geo.route == "cluster"
    assert (geo.ctas, geo.stages, geo.smem_bytes, geo.cluster, geo.panel_rows) == (
        ctas, stages, smem, C, rows)
    assert fs.cluster_rows(bw, C) == split
    assert fs.factored_layout(bw // 7, bw) == "packed"
