"""PyTorch port vs the JAX package on the dense-path workloads: the Burgers
discovery loss and its parameter gradients (with and without the ResNet
transform), the f32_ir backward solve on an ill-conditioned Burgers system,
the sine fit's loss and gradients, the Burgers and sine datasets, and the
two transport examples at a reduced window count.

Inputs and data come from numpy with fixed seeds and go through both
packages; the port runs on the CPU.  Tolerances: datasets exact (the same
numpy code and seeds); Burgers loss 1e-6 and gradients 1e-5 relative
max-abs, 1e-4 with the ResNet transform (float64 solves, but the ParamNets
and the ResNet run in float32 in both packages and sum in another order;
the solve amplifies the convolutions' rounding in the denoised field, most
in the u_xx coefficient's gradient: 2.4e-5 on this case); the f32_ir
backward as its test states; the dense transport march 1e-10 (float64
Cholesky in both); the multigrid transport march 1e-4 absolute (both FGMRES
runs stop at the 1e-5 relative residual, and the float32 preconditioners
round differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mech_nn_discovery_pde_torch.config import PDEConfig as TorchConfig
from mech_nn_discovery_pde_torch.data import datasets as tdata
from mech_nn_discovery_pde_torch.data import generate as tgen
from mech_nn_discovery_pde_torch.discovery import burgers as tbur
from mech_nn_discovery_pde_torch.examples import transport_dense as tdense
from mech_nn_discovery_pde_torch.examples import transport_multigrid as tmg
from mech_nn_discovery_pde_torch.fit import sine_fit as tsine
from mech_nn_discovery_pde_torch.models import resnet as tres
from mech_nn_discovery_pde_torch.solvers import cholesky as tchol
from mech_nn_discovery_pde_tpu.config import PDEConfig as JaxConfig
from mech_nn_discovery_pde_tpu.data import datasets as jdata
from mech_nn_discovery_pde_tpu.data import generate as jgen
from mech_nn_discovery_pde_tpu.discovery import burgers as jbur
from mech_nn_discovery_pde_tpu.fit import sine_fit as jsine
from mech_nn_discovery_pde_tpu.layers.dense import PDEDenseLayer as JaxDense
from mech_nn_discovery_pde_tpu.layers.multigrid import MultigridLayer as JaxMG
from mech_nn_discovery_pde_tpu.models import resnet as jres

torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """One Burgers field for the module, generated by the port."""
    root = tmp_path_factory.mktemp("data")
    tgen.ensure_dataset("burgers", str(root))
    return str(root)


@pytest.mark.parametrize("name", ["burgers", "sine"])
def test_datasets_match_jax(tmp_path, name):
    """The port's generators make the JAX package's arrays, and the Burgers
    dataset's noise and frame dropping draw the same numbers."""
    t = tgen.ensure_dataset(name, str(tmp_path / "torch"))["u"]
    j = jgen.ensure_dataset(name, str(tmp_path / "jax"))["u"]
    np.testing.assert_array_equal(t, j)
    if name == "burgers":
        kw = dict(solver_dim=(8, 16), noise_percent=5.0, frame_drop_prob=0.2)
        td = tdata.BurgersDataset(data_root=str(tmp_path / "torch"), **kw)
        jd = jdata.BurgersDataset(data_root=str(tmp_path / "jax"), **kw)
        np.testing.assert_array_equal(td.data, jd.data)
        np.testing.assert_array_equal(td.frame_mask, jd.frame_mask)
        assert 0 < td.frame_mask.sum() < len(td.frame_mask)
        assert len(td) == len(jd)
        for i in (0, 300, len(td) - 1):
            for a, b in zip(td[i], jd[i]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nn_transform", [False, True])
def test_burgers_loss_matches_jax(data_root, nn_transform):
    """BurgersDiscovery.loss_fn at (8, 16), bs 2, f64 solves, on the JAX
    package's parameters: the loss, its parts and every parameter gradient.
    With nn_transform both models get a width-8, depth-2 ResNet over the
    same 16 x 32 corner of the field, so the convolutions stay cheap."""
    kw = dict(solver_dim=(8, 16), batch_size=2, nn_transform=nn_transform)
    jcfg = jbur.BurgersConfig(pde=JaxConfig(precision="f64"), **kw)
    tcfg = tbur.BurgersConfig(pde=TorchConfig(precision="f64"), **kw)
    jds = jdata.BurgersDataset(solver_dim=(8, 16), data_root=data_root)
    tds = tdata.BurgersDataset(solver_dim=(8, 16), data_root=data_root)
    jm = jbur.BurgersDiscovery(jcfg, jds)
    tm = tbur.BurgersDiscovery(tcfg, tds, device="cpu")
    params = jm.init(jax.random.PRNGKey(0))
    if nn_transform:
        jm.resnet = jres.ResNet(out_channels=1, in_channels=1, width=8, depth=2)
        params["resnet"] = jm.resnet.init(jax.random.PRNGKey(5), jnp.zeros((1, 8, 8, 1)))
        jm.data_all = jm.data_all[:16, :32]
        tm.resnet = tres.ResNet(out_channels=1, in_channels=1, width=8, depth=2, device="cpu")
        tm.data_all = tm.data_all[:16, :32]
    params = jax.tree_util.tree_map(np.asarray, params)
    tm.load_state_dict(tbur.state_dict_from_flax(params))
    # two patches inside the 16 x 32 corner: (t0, x0) = (0, 3) and (8, 10)
    items = [tds[0 * tds.num_x_idx + 3], tds[1 * tds.num_x_idx + 10]]
    patch, t_idx, x_idx = (np.stack([np.asarray(it[k]) for it in items]) for k in range(3))

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        params, jnp.asarray(patch), jnp.asarray(t_idx), jnp.asarray(x_idx))
    tl, taux = tm.loss_fn(patch, t_idx, x_idx)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-6 * abs(float(jl))
    for k in ("x_loss", "var_loss"):
        assert abs(float(taux[k]) - float(jaux[k])) <= 1e-6 * abs(float(jaux[k]))
    want = tbur.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jg))
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for n, g in got.items():
        if g is None:  # no path from the loss (the unused ResNet): JAX gives 0
            assert not nn_transform and not want[n].any(), n
            continue
        assert rel(g.numpy(), want[n].numpy()) <= (1e-4 if nn_transform else 1e-5), n


def test_sine_fit_loss_matches_jax():
    """SineFit.loss_fn on an (8, 12) damped sine with f64 solves, on the JAX
    package's SineHeads parameters: the loss and every parameter gradient
    within 1e-5 (the heads' 1024-wide layers run in float32 in both packages
    and sum in another order: about 2e-6 here)."""
    kw = dict(coord_dims=(8, 12))
    jm = jsine.SineFit(jsine.SineFitConfig(pde=JaxConfig(precision="f64"), **kw))
    tm = tsine.SineFit(tsine.SineFitConfig(pde=TorchConfig(precision="f64"), **kw), device="cpu")
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm.heads.load_state_dict(tsine.heads_state_dict_from_flax(params))
    y = tgen.damped_sine(kw["coord_dims"])
    np.testing.assert_array_equal(y, jgen.damped_sine(kw["coord_dims"]))
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(params, jnp.asarray(y))
    tl, _ = tm.loss_fn(y)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    want = tsine.heads_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jg))
    got = {n: p.grad for n, p in tm.heads.named_parameters()}
    assert set(got) == set(want)
    for n, g in got.items():
        assert rel(g.numpy(), want[n].numpy()) <= 1e-5, n


def test_transport_dense_matches_jax():
    """The dense transport example marched 2 windows, against the JAX
    package's layer marched the same way (examples/transport_dense.py)."""
    u, err = tdense.main(device="cpu", windows=2)
    bs, dims = 5, (8, 64)
    layer = JaxDense(bs=bs, coord_dims=dims, order=2, n_ind_dim=1, n_iv=1,
                     init_index_mi_list=[lambda nt, nx: (0, 0, [0, 0], [0, nx - 1])],
                     solver_dbl=True)
    steps = [jnp.full((bs, dims[0] - 1), 0.005),
             jnp.full((bs, dims[1] - 1), np.clip(2 * np.pi / dims[1], 1e-3, 0.1))]
    coeffs = jnp.zeros((bs, layer.grid_size, layer.n_orders)).at[..., 1].set(1.0).at[..., 2].set(1.0)
    rhs = jnp.zeros((bs, layer.grid_size))
    x = jnp.linspace(0, 2 * np.pi, dims[1])
    iv = jnp.stack([jnp.sin((i + 1) / 2 * x) for i in range(bs)])
    solve = jax.jit(lambda c, r, i, s: layer(c, r, i, s)[0])
    us = []
    for _ in range(2):
        u0 = solve(coeffs, rhs, iv, steps).reshape(bs, *dims)
        iv = u0[:, -1]
        us.append(np.asarray(u0))
    want = np.concatenate(us, axis=1)
    assert u.shape == want.shape == (bs, 16, 64)
    assert rel(u, want) <= 1e-10
    expect = np.sin(0.5 * (np.asarray(x) - 16 * 0.005))
    assert err == pytest.approx(float(np.abs(want[0, -1] - expect).max()), rel=1e-8)


def test_transport_multigrid_matches_jax():
    """The multigrid transport example at a reduced size ((8, 64), n_grid 3,
    bs 1, 2 windows; otherwise its configuration), against the JAX package's
    layer marched the same way (examples/transport_multigrid.py)."""
    bs, dims, n_grid = 1, (8, 64), 3
    u, err = tmg.main(device="cpu", windows=2, bs=bs, coord_dims=dims, n_grid=n_grid)
    cfg = JaxConfig(mg_fgmres_restarts_forward=20, mg_fgmres_restarts_backward=20)
    layer = JaxMG(bs=bs, coord_dims=dims, order=2, n_ind_dim=1, n_iv=1,
                  init_index_mi_list=[lambda nt, nx: (0, 0, [0, 0], [0, nx - 1])],
                  solver_dbl=True, n_grid=n_grid, downsample_first=False, config=cfg)
    steps = [jnp.full((bs, dims[0] - 1), 0.005),
             jnp.full((bs, dims[1] - 1), np.clip(2 * np.pi / dims[1], 1e-3, 0.1))]
    coeffs = jnp.zeros((bs, layer.grid_size, layer.n_orders)).at[..., 1].set(1.0).at[..., 2].set(1.0)
    rhs = jnp.zeros((bs, layer.grid_size))
    x = jnp.linspace(0, 2 * np.pi, dims[1])
    iv = jnp.sin(x)[None]
    solve = jax.jit(lambda c, r, i, s: layer(c, r, i, s)[0])
    us = []
    for _ in range(2):
        u0 = solve(coeffs, rhs, iv, steps).reshape(bs, *dims)
        iv = u0[:, -1]
        us.append(np.asarray(u0))
    want = np.concatenate(us, axis=1)
    assert u.shape == want.shape
    assert float(np.abs(u - want).max()) <= 1e-4
    expect = np.sin(np.asarray(x) - 16 * 0.005)
    assert err == pytest.approx(float(np.abs(want[0, -1] - expect)[8:-8].max()), abs=1e-4)



def test_burgers_f32_ir_backward_matches_jax(data_root, monkeypatch):
    """The f32_ir backward solve where it stops far from convergence, as in
    Burgers discovery at the BurgersConfig defaults.  There the random
    width-128, depth-12 ResNet maps the field to about [-6.2, 1.6] and q(u)
    to about -287 (anti-diffusion), and six PCG steps do not resolve the
    cotangent.  Here, at (16, 16), bs 2, a width-8, depth-2 ResNet over a
    32 x 48 corner of the field gets its head scaled by 16 in both packages,
    which maps the field to about [-9.5, 6.2]; sample 1's backward solve
    stops at a relative normal residual near 1.

    Both layers take the same solver inputs (the port's forward on the JAX
    package's parameters) and the same cotangent g (the loss's gradient with
    respect to u0, w, in slot 0).  Held: (1) the two packages' float32
    factors of the equilibrated AtA agree to float32 rounding (L L^T 1e-5,
    the scale s 1e-6); (2) given the same factor (either package's), the
    backward_stats rel_rnorm (1e-6 relative, or 1e-9 absolute where the
    solve converged to 1e-7, the rounding floor) and the IFT gradients of
    sum(u0 * w) with respect to coeffs, rhs, iv_rhs and both steps (1e-6
    relative max-abs; measured <= 1e-7) agree, with the factor's triangular
    solves run in float64 in both.  Those solves are the one step the packages cannot round alike:
    in float32, each library's own, they lose every digit on this factor
    (port vs JAX on the same factor: rel_rnorm 0.92 against 1.64, the
    coefficient gradient 14 % apart), so the PCG itself is compared through
    float64 solves of the same float32 factor and float32-rounded residual."""
    dim, corner = (16, 16), (32, 48)
    kw = dict(solver_dim=dim, batch_size=2, nn_transform=True)
    jds = jdata.BurgersDataset(solver_dim=dim, data_root=data_root)
    tds = tdata.BurgersDataset(solver_dim=dim, data_root=data_root)
    jm = jbur.BurgersDiscovery(jbur.BurgersConfig(pde=JaxConfig(precision="f32_ir"), **kw), jds)
    tm = tbur.BurgersDiscovery(tbur.BurgersConfig(pde=TorchConfig(precision="f32_ir"), **kw),
                               tds, device="cpu")
    params = jm.init(jax.random.PRNGKey(0))
    params["resnet"] = jres.ResNet(out_channels=1, in_channels=1, width=8, depth=2).init(
        jax.random.PRNGKey(5), jnp.zeros((1, 8, 8, 1)))
    params = jax.tree_util.tree_map(np.asarray, params)
    head = params["resnet"]["params"]["Conv_3"]
    head["kernel"], head["bias"] = 16 * head["kernel"], 16 * head["bias"]
    tm.resnet = tres.ResNet(out_channels=1, in_channels=1, width=8, depth=2, device="cpu")
    tm.data_all = tm.data_all[: corner[0], : corner[1]]
    tm.load_state_dict(tbur.state_dict_from_flax(params))
    # two patches inside the corner: (t0, x0) = (0, 3) and (16, 10)
    items = [tds[0 * tds.num_x_idx + 3], tds[1 * tds.num_x_idx + 10]]
    patch, t_idx, x_idx = (np.stack([np.asarray(it[k]) for it in items]) for k in range(3))

    # the port's forward, with the layer's inputs and u0 caught on the way
    tl, jl = tm.layer, jm.layer
    caught = {}

    class Catch:
        n_orders, grid_size = tl.n_orders, tl.grid_size

        def __call__(self, c, r, i, s):
            caught["args"] = [a.detach() for a in (c, r, i, *s)]
            caught["u0"] = tl(c, r, i, s)[0]
            return caught["u0"], None, None

    tm.layer = Catch()
    loss, _ = tm.loss_fn(patch, t_idx, x_idx)
    (w,) = torch.autograd.grad(loss, caught["u0"])
    w = w.reshape(2, -1)
    g = torch.zeros(2, tl.grid_size, tl.n_orders, dtype=torch.float64)
    g[..., 0] = w
    g = g.reshape(2, -1)
    targs = caught["args"]
    jargs = [jnp.asarray(a.numpy()) for a in (*targs, g, w)]

    # (1) each package's float32 factor of these inputs' equilibrated AtA
    jL, js = jax.jit(lambda c, r, i, s0, s1: jl.inner.factor(jl._prepare(c, r, i, [s0, s1])[0]))(
        *jargs[:5])
    tL, ts = tl.inner.factor(tl._prepare(*targs[:3], targs[3:])[0])
    assert rel(ts.numpy(), js) <= 1e-6
    assert rel((tL @ tL.mT).numpy(), np.asarray(jL @ jnp.swapaxes(jL, -1, -2))) <= 1e-5

    # (2) the factor given, its triangular solves in float64 in both
    j_cho, t_cho = jax.scipy.linalg.cho_solve, tchol.cho_solve
    monkeypatch.setattr(jax.scipy.linalg, "cho_solve", lambda c, b, **k: j_cho(
        (c[0].astype(jnp.float64), c[1]), b.astype(jnp.float64), **k))
    monkeypatch.setattr(tchol, "cho_solve", lambda L, b: t_cho(L.double(), b.double()))

    @jax.jit
    def jax_given(c, r, i, s0, s1, g, w, L, s):
        own = jl.inner.factor
        jl.inner.factor = lambda values: (L, s)
        try:
            rn = jl.backward_stats(c, r, i, [s0, s1], g)["rel_rnorm"]
            grads = jax.grad(lambda *a: (jl(a[0], a[1], a[2], list(a[3:]))[0].reshape(2, -1)
                                         * w).sum(), argnums=range(5))(c, r, i, s0, s1)
        finally:
            jl.inner.factor = own
        return rn, grads

    def torch_given(L, s):
        monkeypatch.setattr(tl.inner, "factor", lambda values: (L, s))
        rn = tl.backward_stats(*targs[:3], targs[3:], g)["rel_rnorm"]
        a = [t.clone().requires_grad_(True) for t in targs]
        (tl(a[0], a[1], a[2], a[3:])[0].reshape(2, -1) * w).sum().backward()
        return rn.numpy(), [t.grad.numpy() for t in a]

    for L, s in ((np.asarray(jL), np.asarray(js)), (tL.numpy(), ts.numpy())):
        j_rn, j_grads = jax_given(*jargs, jnp.asarray(L), jnp.asarray(s))
        t_rn, t_grads = torch_given(torch.as_tensor(L), torch.as_tensor(s))
        # the case is in the regime: a backward solve far from convergence
        assert float(np.max(j_rn)) > 0.5, j_rn
        np.testing.assert_allclose(t_rn, np.asarray(j_rn), rtol=1e-6, atol=1e-9)
        for name, a, b in zip(("coeffs", "rhs", "iv_rhs", "t steps", "x steps"), t_grads,
                              j_grads):
            assert rel(a, b) <= 1e-6, name
