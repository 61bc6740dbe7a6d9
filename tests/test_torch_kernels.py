"""PyTorch port vs the JAX package: the modules that hold the CUDA kernels,
run here on their plain versions (CPU tensors).

- ops/normal_stencil.py: `build_normal_coef` and K1's plain apply against
  the JAX `normal_stencil_matvec` and the COO AtA (f64, 1e-12), and K1's
  epilogue semantics;
- ops/fused_smoother.py: K2's plain block apply and the Chebyshev smoothing
  pass (both starts, emitted residual) against `MultigridSolver._block_apply`
  and `_smooth` (f32, 1e-4, as tests/test_multigrid.py holds the Pallas
  smoother), on the JAX package's own level-0 smoother data;
- the stored-operator modes (mg_precond_dtype): the factor W = L^-T that the
  port builds for 'bf16_factored' (one bf16 ulp), K3's plain apply
  W (W^T r) (1e-5), the factored pass against `_smooth` and against the TPU
  kernel itself (`make_fused_smoother(factored=True)` in interpret mode;
  1e-4), and the 'bf16' pass with bf16 stencil fields and block inverses
  (1e-4), all on the JAX package's level data carried across by
  `line_blocks_from_jax`.

The kernels themselves run only on the card; chip_smoke.py holds them
against these plain versions there.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mech_nn_discovery_pde_torch.config import PDEConfig as TorchConfig
from mech_nn_discovery_pde_torch.ops import fused_smoother as tfs
from mech_nn_discovery_pde_torch.ops import normal_stencil as tns
from mech_nn_discovery_pde_torch.ops.system import PDESystem as TorchSystem
from mech_nn_discovery_pde_torch.solvers.multigrid import MultigridSolver as TorchSolver
from mech_nn_discovery_pde_tpu.config import PDEConfig as JaxConfig
from mech_nn_discovery_pde_tpu.ops import normal_stencil as jns
from mech_nn_discovery_pde_tpu.ops.fused_smoother import make_fused_smoother
from mech_nn_discovery_pde_tpu.ops.structured import split_values as jsplit
from mech_nn_discovery_pde_tpu.ops.system import PDESystem as JaxSystem
from mech_nn_discovery_pde_tpu.solvers.multigrid import MultigridSolver as JaxSolver

torch.set_num_threads(1)

IVS = {
    1: [lambda nt: (0, 0, [0], [0])],
    2: [
        lambda nt, nx: (0, 0, [0, 0], [0, nx - 1]),
        lambda nt, nx: (1, 1, [1, 0], [nt - 1, 0]),
    ],
    3: [
        lambda nt, nx, ny: (0, 0, [0, 0, 0], [0, nx - 1, ny - 1]),
        lambda nt, nx, ny: (1, 0, [1, 0, 0], [nt - 1, 0, ny - 1]),
    ],
}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("dims,order,n_iv", [
    ((9,), 2, 1), ((12,), 2, 3), ((7, 9), 2, 1), ((6, 8), 1, 1), ((8, 6), 2, 2),
    ((6, 7, 8), 2, 1), ((10,), 1, 1), ((6, 7, 8), 1, 1),
])
def test_normal_coef_and_k1_plain_match_jax(dims, order, n_iv):
    """Assembled stencil fields equal the JAX package's; K1's plain apply
    equals the JAX stencil apply and the COO product A^T (A x)."""
    kw = dict(order=order, init_index_mi_list=IVS[len(dims)], n_iv=n_iv, step_size=0.2)
    jsys, tsys = JaxSystem.build(dims, **kw), TorchSystem.build(dims, **kw)
    rng = np.random.default_rng(sum(dims) + order + n_iv)
    bs = 2
    values = rng.standard_normal((bs, tsys.n_entries))
    x = rng.standard_normal((bs, tsys.num_vars))

    jdesc = jns.make_desc(jsys.spec)

    @jax.jit
    def jax_ref(v, x):
        def one(v, x):
            coef = jns.build_normal_coef(jsys.spec, jdesc, jsplit(jsys.spec, v))
            return (coef, jns.normal_stencil_matvec(jdesc, coef, x),
                    jsys.rmatvec_coo(v, jsys.matvec_coo(v, x)))
        return jax.vmap(one)(v, x)

    jcoef, jy, jcoo = jax_ref(jnp.asarray(values), jnp.asarray(x))
    tdesc = tns.make_desc(tsys.spec)
    assert tdesc.n_channels == jdesc.n_channels
    assert [tuple(b) for b in tdesc.bands] == [tuple(b) for b in jdesc.bands]
    tv, tx = torch.tensor(values), torch.tensor(x)
    coef = tns.build_normal_coef(tsys.spec, tdesc, tsys.split_values(tv))
    assert rel(coef, jcoef) <= 1e-12
    y = tns.stencil_apply(tdesc, coef, tx)
    assert rel(y, jy) <= 1e-12
    assert rel(y, jcoo) <= 1e-12
    assert rel(tns.stencil_apply_plain(tdesc, coef, tx), jcoo) <= 1e-12


def test_k1_epilogue_semantics():
    """out = rin - A x and xout = xin + x, in place or not; xin None reads
    as zero."""
    dims = (7, 9)
    tsys = TorchSystem.build(dims, order=2, init_index_mi_list=IVS[2])
    rng = np.random.default_rng(3)
    bs = 2
    tv = torch.tensor(rng.standard_normal((bs, tsys.n_entries)))
    x, b, x0 = (torch.tensor(rng.standard_normal((bs, tsys.num_vars))) for _ in range(3))
    desc = tns.make_desc(tsys.spec)
    coef = tns.build_normal_coef(tsys.spec, desc, tsys.split_values(tv))
    Ax = tns.stencil_apply(desc, coef, x)
    r = b.clone()
    xo = x0.clone()
    out = tns.stencil_apply(desc, coef, x, rin=r, out=r, xin=xo, xout=xo)
    assert out is r
    assert rel(r, b - Ax) <= 1e-12
    assert rel(xo, x0 + x) <= 1e-15
    xz = torch.empty_like(x)
    tns.stencil_apply(desc, coef, x, xout=xz)
    assert torch.equal(xz, x)


@pytest.mark.parametrize("window", [(0, 63), (9, 36), (27, 36)])
def test_k1_window(window):
    """An output window (p0, n) gives the whole-grid apply's points p0 ..
    p0+n-1 (reads still over the whole grid), with the epilogue on
    window-sized operands (xout = xin + x's window); a run off the grid
    raises.  The K1 geometry for a window: 16-byte loads only where the
    grid's size and the window's start are multiples of the vector."""
    dims = (7, 9)
    tsys = TorchSystem.build(dims, order=2, init_index_mi_list=IVS[2])
    rng = np.random.default_rng(4)
    tv = torch.tensor(rng.standard_normal((2, tsys.n_entries)))
    x = torch.tensor(rng.standard_normal((2, tsys.num_vars)))
    desc = tns.make_desc(tsys.spec)
    coef = tns.build_normal_coef(tsys.spec, desc, tsys.split_values(tv))
    p0, n = window
    m = desc.n_mi
    win = slice(p0 * m, (p0 + n) * m)
    full = tns.stencil_apply(desc, coef, x)
    assert torch.equal(tns.stencil_apply(desc, coef, x, window=window), full[:, win])
    b, x0 = (torch.tensor(rng.standard_normal((2, n * m))) for _ in range(2))
    xo = x0.clone()
    r = tns.stencil_apply(desc, coef, x, rin=b, xin=xo, xout=xo, window=window)
    assert torch.equal(r, b - full[:, win]) and torch.equal(xo, x0 + x[:, win])
    with pytest.raises(ValueError, match="window"):
        tns.stencil_apply(desc, coef, x, window=(p0 + 1, 63))
    assert tns.stencil_geometry(1 << 16, 32, 4, 132, aligned=True).P == 4
    assert tns.stencil_geometry(1 << 16, 32, 4, 132, aligned=False).P == 1


LAYOUT_DIMS = {1: (10,), 2: (7, 9), 3: (6, 7, 8)}


@pytest.mark.parametrize("n_coord,order", tns.K1_LAYOUTS)
def test_k1_layout_matches_make_desc(n_coord, order):
    """K1's compile-time channel layout is `make_desc`'s band order for every
    (n_coord, order) it is instantiated for; the wrapper's check passes it
    and returns the strides of the axes before the last."""
    dims = LAYOUT_DIMS[n_coord]
    desc = tns.make_desc(TorchSystem.build(dims, order=order, init_index_mi_list=IVS[n_coord]).spec)
    got = tuple((b.coord, b.delta, b.kind, b.mi_k, b.ch) for b in desc.bands)
    assert got == tns.k1_band_layout(n_coord, order)
    assert desc.n_channels == desc.n_mi**2 + len(got)
    strides = [int(np.prod(dims[c + 1:])) for c in range(n_coord - 1)]
    assert tns.k1_layout_args(desc) == (n_coord, order, *(strides + [0, 0])[:2])


def test_k1_layout_check_raises():
    """A descriptor whose bands are permuted, or a layout K1 has no
    instantiation for, raises ValueError, and the wrapper raises it before
    it builds or launches anything (here on CPU tensors, which the launch
    would refuse with another message)."""
    tsys = TorchSystem.build((6, 7, 8), order=2, init_index_mi_list=IVS[3])
    desc = tns.make_desc(tsys.spec)
    bands = list(desc.bands)
    bands[3], bands[4] = bands[4], bands[3]  # vd_0 <-> dv_0 of axis 0, offset 1
    swapped = desc._replace(bands=tuple(bands))
    with pytest.raises(ValueError, match="compile-time layout"):
        tns.k1_layout_args(swapped)
    moved = desc._replace(bands=tuple(b._replace(ch=b.ch + 1) if b.coord == 2 else b
                                      for b in desc.bands))
    with pytest.raises(ValueError, match="compile-time layout"):
        tns.k1_layout_args(moved)
    for n_coord, order in ((4, 1), (3, 3), (0, 1)):
        with pytest.raises(ValueError, match="no layout"):
            tns.k1_band_layout(n_coord, order)
    with pytest.raises(ValueError, match="no layout"):
        tns.k1_layout_args(desc._replace(coord_dims=(6, 7, 8, 2), n_mi=9))
    coef = torch.zeros((1, desc.n_channels, desc.grid_size))
    x = torch.zeros((1, desc.grid_size * desc.n_mi))
    with pytest.raises(ValueError, match="compile-time layout"):
        tns._stencil_apply_k1(swapped, coef, x, None, None, None, None)


H100_SMS = 132
GEOMETRY_CASES = {
    # N, bs, vector itemsize, SMs, operands aligned
    "gl-fine-f32": (8192, 32, 4, H100_SMS, True),
    "gl-fine-f64": (8192, 32, 8, H100_SMS, True),
    "gl-level1-f32": (2048, 32, 4, H100_SMS, True),
    "gl-level1-f64": (2048, 32, 8, H100_SMS, True),
    "gl-fine-unaligned": (8192, 32, 4, H100_SMS, False),
    "small-3d-bs3": (480, 3, 4, H100_SMS, True),
    "small-1d-wide-batch": (40, 300, 4, H100_SMS, True),
    "odd-n": (6 * 7 * 9, 300, 4, H100_SMS, True),
    "n-2-mod-4-f32": (6 * 7 * 11, 400, 4, H100_SMS, True),
    "n-2-mod-4-f64": (6 * 7 * 11, 400, 8, H100_SMS, True),
    "tiny": (7, 1, 8, 2, True),
}


@pytest.mark.parametrize("case", list(GEOMETRY_CASES))
def test_stencil_geometry_covers_each_point_once(case):
    """K1's geometry: thread t of CTA (i, b) takes the points
    (i * threads + t) * P + q, q < P, of sample b when its first point lies
    below N (csrc/stencil_apply.cu).  That covers every point of every
    sample exactly once and nothing past N, with no CTA idle; P > 1 only
    with 16-byte loads on rows whose length it divides."""
    N, bs, itemsize, n_sm, aligned = GEOMETRY_CASES[case]
    geo = tns.stencil_geometry(N, bs, itemsize, n_sm, aligned)
    gx, gy = geo.grid
    assert gy == bs and geo.threads == tns.K1_THREADS
    i, t, q = np.meshgrid(np.arange(gx), np.arange(geo.threads), np.arange(geo.P), indexing="ij")
    p0 = (i * geo.threads + t) * geo.P
    pts = (p0 + q)[p0 < N]
    assert np.array_equal(np.sort(pts), np.arange(N))  # each point once, none past N
    assert (gx - 1) * geo.threads * geo.P < N  # the last CTA has work
    if geo.P > 1:
        assert aligned and N % geo.P == 0 and geo.P * itemsize == 16
    else:
        assert geo.P == 1


def test_stencil_geometry_fills_the_card():
    """16-byte loads at the GL fine level (f32: 4 points a thread, f64: 2);
    at GL level 1, where those would leave SMs with one CTA, one point a
    thread and at least two CTAs on every SM; one point a thread wherever
    the rows or the operands do not allow 16-byte loads."""
    assert tns.stencil_geometry(8192, 32, 4, H100_SMS).P == 4
    assert tns.stencil_geometry(8192, 32, 8, H100_SMS).P == 2
    for itemsize in (4, 8):
        geo = tns.stencil_geometry(2048, 32, itemsize, H100_SMS)
        assert geo.P == 1 and geo.grid[0] * geo.grid[1] >= 2 * H100_SMS
    assert tns.stencil_geometry(8192, 32, 4, H100_SMS, aligned=False).P == 1
    assert tns.stencil_geometry(6 * 7 * 9, 300, 4, H100_SMS).P == 1
    with pytest.raises(ValueError, match="bad shape"):
        tns.stencil_geometry(0, 32, 4, H100_SMS)
    with pytest.raises(ValueError, match="bad shape"):
        tns.stencil_geometry(8192, 32, 2, H100_SMS)


GL_DIMS = (6, 12, 12)
GL_IVS = [
    lambda nt, nx, ny: (0, 0, [0, 0, 0], [0, nx - 1, ny - 1]),
    lambda nt, nx, ny: (1, 0, [1, 0, 0], [nt - 1, 0, ny - 1]),
]
MODES = ("f32", "bf16_factored", "bf16")
FUSED_STEPS = 2  # steps of the TPU kernel's factored pass (interpret mode)


def solver_kw(bs):
    return dict(bs=bs, order=2, n_ind_dim=1, n_iv=1, init_index_mi_list=GL_IVS,
                coord_dims=GL_DIMS, solver_dbl=True, n_grid=2, downsample_first=False)


def to_torch(a):
    """A JAX array as a torch tensor of the same dtype (bf16 via f32, exact)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


@pytest.fixture(scope="module")
def gl_level():
    """The JAX package's level-0 smoother data in every mg_precond_dtype mode
    on the small GL-shaped case of
    tests/test_multigrid.py::test_fused_smoother_matches_xla_smoother, and
    reference block applies and smoothing passes on it; with the
    'bf16_factored' W also the TPU kernel's own factored pass on sample 0
    (the kernel takes one sample), in interpret mode.  One jitted function
    computes it all."""
    bs, dims = 2, GL_DIMS
    solvers = {mode: JaxSolver(config=JaxConfig(precision="f64", mg_precond_dtype=mode),
                               **solver_kw(bs)) for mode in MODES}
    # one jitted copy of the assembled-stencil ops for all three solvers: no
    # value changes, and JAX traces them once instead of once per solver
    ops = [(desc, jax.jit(build), jax.jit(apply_))
           for desc, build, apply_ in solvers["f32"]._nstencil]
    for mgs in solvers.values():
        mgs._nstencil = ops
    sys0 = solvers["f32"].systems[0]
    rng = np.random.default_rng(0)
    gs = sys0.var_set.grid_size
    coeffs = np.zeros((bs, gs, sys0.var_set.n_mi))
    coeffs[..., 0] = 0.4
    coeffs[..., 1] = 1.0
    coeffs[..., 5] = -0.1
    steps = [np.full((bs, d - 1), 0.05) for d in dims]
    rng.standard_normal((bs, gs))  # rhs and iv draws of the JAX test's case
    rng.standard_normal((bs, sys0.n_init_rows))
    n = sys0.num_vars
    b = rng.standard_normal((bs, n)).astype(np.float32)
    x0 = rng.standard_normal((bs, n)).astype(np.float32)
    nt, m = dims[0], sys0.var_set.n_mi
    ratio = solvers["f32"].config.mg_chebyshev_ratio
    fused = make_fused_smoother(solvers["f32"]._nstencil[0][0], dims, FUSED_STEPS, ratio,
                                x0_zero=False, interpret=True, emit_residual=True,
                                factored=True)

    @jax.jit
    def reference(coeffs, steps, b, x0):
        vals = sys0.fill_values(coeffs, steps, dtype=jnp.float64)
        out = {}
        for mode, mgs in solvers.items():
            lvl = mgs._level_precond_data(0, vals)

            def one(lvl, b, x0, mgs=mgs):
                z = jnp.zeros_like(b)
                return {
                    "block": mgs._block_apply(sys0, lvl["binv"], b),
                    "zero4": mgs._smooth(0, lvl, b, z, 4, False, x0_zero=True,
                                         want_residual=True),
                    "x3": mgs._smooth(0, lvl, b, x0, 3, False, want_residual=True),
                }
            out[mode] = (lvl, jax.vmap(one)(lvl, b, x0))
        # the fused kernel's column-major W: w[j][mi, ti, s] = W_s[ti*m+mi, j]
        lvl = out["bf16_factored"][0]
        w = jnp.transpose(lvl["binv"], (0, 3, 2, 1)).reshape(bs, nt * m, nt, m, -1)
        w = jnp.transpose(w, (0, 1, 3, 2, 4))
        pallas = fused(lvl["coef"][0], w[0], b[0], x0[0], lvl["lmax"][0])
        return out, w, pallas

    out, w_fused, pallas = reference(jnp.asarray(coeffs), [jnp.asarray(s) for s in steps],
                                     jnp.asarray(b), jnp.asarray(x0))
    levels = {}
    for mode, (lvl, ref) in out.items():
        levels[mode] = {
            "coef": to_torch(lvl["coef"]), "lmax": to_torch(lvl["lmax"]),
            "binv": tfs.line_blocks_from_jax(np.asarray(lvl["binv"]), nt, m, "rows"),
            "ref": jax.tree.map(np.asarray, ref),
        }
    return {
        "desc": tns.make_desc(TorchSystem.build(dims, order=2, init_index_mi_list=GL_IVS).spec),
        "nt": nt, "m": m, "b": torch.tensor(b), "x0": torch.tensor(x0), "ratio": ratio,
        "values": to_torch(out["f32"][0]["values"]), "levels": levels,
        "w_fused": np.asarray(w_fused), "pallas": jax.tree.map(np.asarray, pallas),
        # the f32 mode's data also at the top level, where the f32 tests read it
        **{k: levels["f32"][k] for k in ("coef", "binv", "lmax", "ref")},
    }


def test_k2_plain_block_apply_matches_jax(gl_level):
    g = gl_level
    got = tfs.block_apply(g["binv"], g["b"], g["nt"])
    assert rel(got, g["ref"]["block"]) <= 1e-4
    assert rel(tfs.block_apply_plain(g["binv"], g["b"], g["nt"]), g["ref"]["block"]) <= 1e-4
    # Chebyshev epilogue: d <- c1 d + c2 B^-1 r
    c1, c2 = torch.tensor([0.5, -2.0]), torch.tensor([3.0, 0.25])
    d = g["x0"].clone()
    tfs.block_apply(g["binv"], g["b"], g["nt"], d=d, c1=c1, c2=c2)
    want = c1[:, None] * g["x0"] + c2[:, None] * got
    assert rel(d, want) <= 1e-6


@pytest.mark.parametrize("steps,x0_zero", [(4, True), (3, False)])
def test_smoothing_pass_matches_jax(gl_level, steps, x0_zero):
    """The kernel-driven pass (plain versions here) and the step-by-step
    plain pass reproduce MultigridSolver._smooth, emitted residual
    included."""
    g = gl_level
    want_x, want_r = g["ref"]["zero4" if x0_zero else "x3"]
    sched = tfs.chebyshev_schedule(g["lmax"], g["ratio"], steps)
    x, r = tfs.chebyshev_smooth(g["desc"], g["nt"], g["coef"], g["binv"], g["b"],
                                g["x0"], sched, steps, x0_zero)
    assert rel(x, want_x) <= 1e-4
    assert rel(r, want_r) <= 1e-4
    xp, rp = tfs.chebyshev_smooth_plain(g["desc"], g["nt"], g["coef"], g["binv"], g["b"],
                                        g["x0"], g["lmax"], g["ratio"], steps, x0_zero)
    assert rel(xp, want_x) <= 1e-4
    assert rel(rp, want_r) <= 1e-4
    # the emitted residual is b - A x
    r_true = tns.stencil_apply(g["desc"], g["coef"], x, rin=g["b"])
    assert rel(r, r_true) <= 1e-4


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp (8 significant bits) at each value of x."""
    return torch.exp2(torch.floor(torch.log2(x.clamp_min(1e-30))) - 7)


def test_factored_w_matches_jax(gl_level):
    """The port's 'bf16_factored' level data stores W = L^-T in bf16, equal
    to the JAX package's W within one bf16 ulp of each block's largest entry
    (both factor the same f32 blocks; rounding may tip either way)."""
    g = gl_level
    mgs = TorchSolver(config=TorchConfig(precision="f64", mg_precond_dtype="bf16_factored"),
                      device="cpu", **solver_kw(2))
    lvl = mgs._level_precond_data(0, g["values"])
    w, wj = lvl["binv"], g["levels"]["bf16_factored"]["binv"]
    assert w.dtype == wj.dtype == torch.bfloat16
    assert lvl["coef"].dtype == torch.float32
    diff = (w.float() - wj.float()).abs().amax(dim=(-2, -1))
    assert bool((diff <= bf16_ulp(wj.float().abs().amax(dim=(-2, -1)))).all())
    assert bool((w.float().tril(-1) == 0).all())  # L^-T is upper-triangular
    assert rel(lvl["lmax"], g["levels"]["bf16_factored"]["lmax"]) <= 1e-4


def test_stored_w_is_exactly_upper_triangular(gl_level):
    """K3 reads only W's upper triangle, so the stored W must be exactly
    upper-triangular.  On the CPU the port's stored W (L^-T with `.triu()`)
    equals the unmasked L^-T of the same blocks bit for bit, and so does the
    JAX package's W carried across from the fused layout."""
    g = gl_level
    mgs = TorchSolver(config=TorchConfig(precision="f64", mg_precond_dtype="bf16_factored"),
                      device="cpu", **solver_kw(2))
    w = mgs._level_precond_data(0, g["values"])["binv"]
    # the unmasked construction: ridge, Cholesky, L^-1, transpose
    B = mgs.systems[0].assemble_line_blocks(g["values"].to(mgs.pdtype))
    eye = torch.eye(B.shape[-1], dtype=B.dtype)
    dmax = torch.diagonal(B, dim1=-2, dim2=-1).max(dim=-1, keepdim=True).values
    B = B + 1e-6 * torch.clamp(dmax, min=1e-30)[..., None] * eye
    L, _ = torch.linalg.cholesky_ex(B)
    linv = torch.linalg.solve_triangular(L, eye.expand_as(B), upper=False)
    assert torch.equal(w, linv.transpose(-1, -2).to(torch.bfloat16).contiguous())
    assert torch.equal(w, w.triu())
    wj = tfs.line_blocks_from_jax(g["w_fused"], g["nt"], g["m"], "fused")
    assert torch.equal(wj, wj.triu())


@pytest.mark.parametrize("factored", [False, True], ids=["k2", "k3"])
@pytest.mark.parametrize("nt", [40, 50])
def test_wide_line_block_plain_matches_jax(nt, factored):
    """At the widths of the row-tiled kernels (bw 280 and 350: nt 40 and 50
    at m 7), K2's and K3's plain versions equal the JAX package's line-block
    route (`MultigridSolver._block_apply` with its `line_vec_to_blocks` /
    `line_blocks_to_vec`, per sample) in f64 within 1e-10, on random blocks
    (upper-triangular for K3) of bs 2 and S 4 lines, with and without the
    Chebyshev epilogue."""
    m, bs, S = 7, 2, 4
    bw = nt * m
    rng = np.random.default_rng(nt + 100 * factored)
    blocks = rng.standard_normal((bs, S, bw, bw)) / bw
    if factored:
        blocks = np.triu(blocks)
    r = rng.standard_normal((bs, nt * S * m))
    x0 = rng.standard_normal((bs, nt * S * m))
    # the JAX route reads only the line layout (coord_dims, n_mi) of its
    # system and the solver's block-smoother options
    var_set = types.SimpleNamespace(coord_dims=(nt, 2, 2), n_mi=m)
    sysk = types.SimpleNamespace(var_set=var_set)
    sysk.line_vec_to_blocks = lambda v, axis=0: JaxSystem.line_vec_to_blocks(sysk, v, axis)
    sysk.line_blocks_to_vec = lambda z, axis=0: JaxSystem.line_blocks_to_vec(sysk, z, axis)
    solver = types.SimpleNamespace(config=types.SimpleNamespace(mg_block_smoother="line"),
                                   _factored_binv=factored)
    want = np.stack([np.asarray(JaxSolver._block_apply(solver, sysk, jnp.asarray(blocks[b]),
                                                       jnp.asarray(r[b]))) for b in range(bs)])
    plain = tfs.factored_block_apply_plain if factored else tfs.block_apply_plain
    tb, tr = torch.tensor(blocks), torch.tensor(r)
    assert rel(plain(tb, tr, nt), want) <= 1e-10
    c1, c2 = torch.tensor([0.5, -2.0], dtype=torch.float64), torch.tensor([3.0, 0.25],
                                                                          dtype=torch.float64)
    d = torch.tensor(x0)
    plain(tb, tr, nt, d=d, c1=c1, c2=c2)
    assert rel(d, c1[:, None].numpy() * x0 + c2[:, None].numpy() * want) <= 1e-10


def test_k3_plain_factored_apply_matches_jax(gl_level):
    """K3's plain apply W (W^T r) on the JAX package's W equals its factored
    `_block_apply` (1e-5), with the Chebyshev epilogue (1e-6)."""
    g = gl_level
    w = g["levels"]["bf16_factored"]["binv"]
    want = g["levels"]["bf16_factored"]["ref"]["block"]
    got = tfs.factored_block_apply(w, g["b"], g["nt"])
    assert rel(got, want) <= 1e-5
    assert rel(tfs.factored_block_apply_plain(w, g["b"], g["nt"]), want) <= 1e-5
    c1, c2 = torch.tensor([0.5, -2.0]), torch.tensor([3.0, 0.25])
    d = g["x0"].clone()
    tfs.factored_block_apply(w, g["b"], g["nt"], d=d, c1=c1, c2=c2)
    assert rel(d, c1[:, None] * g["x0"] + c2[:, None] * got) <= 1e-6


@pytest.mark.parametrize("mode", ["bf16_factored", "bf16"])
@pytest.mark.parametrize("steps,x0_zero", [(4, True), (3, False)])
def test_stored_mode_pass_matches_jax(gl_level, mode, steps, x0_zero):
    """The smoothing pass on bf16-stored operators reproduces the JAX
    package's `_smooth` in that mode (1e-4): factored W with f32 stencil
    fields, or bf16 stencil fields and block inverses."""
    g = gl_level
    lv = g["levels"][mode]
    factored = mode == "bf16_factored"
    want_x, want_r = lv["ref"]["zero4" if x0_zero else "x3"]
    if not factored:
        assert lv["coef"].dtype == lv["binv"].dtype == torch.bfloat16
        assert rel(tfs.block_apply(lv["binv"], g["b"], g["nt"]), lv["ref"]["block"]) <= 1e-4
    sched = tfs.chebyshev_schedule(lv["lmax"], g["ratio"], steps)
    x, r = tfs.chebyshev_smooth(g["desc"], g["nt"], lv["coef"], lv["binv"], g["b"], g["x0"],
                                sched, steps, x0_zero, factored=factored)
    assert rel(x, want_x) <= 1e-4
    assert rel(r, want_r) <= 1e-4
    xp, rp = tfs.chebyshev_smooth_plain(g["desc"], g["nt"], lv["coef"], lv["binv"], g["b"],
                                        g["x0"], lv["lmax"], g["ratio"], steps, x0_zero,
                                        factored=factored)
    assert rel(xp, want_x) <= 1e-4
    assert rel(rp, want_r) <= 1e-4
    assert rel(r, tns.stencil_apply(g["desc"], lv["coef"], x, rin=g["b"])) <= 1e-4


def test_factored_pass_matches_tpu_kernel(gl_level):
    """The port's factored pass equals the TPU kernel's own
    (`_fused_chebyshev_kernel` with factored=True, interpret mode, emitted
    residual) on W carried across from the kernel's column-major layout
    (1e-4 on sample 0, as tests/test_multigrid.py holds the kernel)."""
    g = gl_level
    lv = g["levels"]["bf16_factored"]
    w = tfs.line_blocks_from_jax(g["w_fused"], g["nt"], g["m"], "fused")
    assert torch.equal(w, lv["binv"])
    sched = tfs.chebyshev_schedule(lv["lmax"], g["ratio"], FUSED_STEPS)
    x, r = tfs.chebyshev_smooth(g["desc"], g["nt"], lv["coef"], w, g["b"], g["x0"], sched,
                                FUSED_STEPS, factored=True)
    want_x, want_r = g["pallas"]
    assert rel(x[0], want_x) <= 1e-4
    assert rel(r[0], want_r) <= 1e-4
