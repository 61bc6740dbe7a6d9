"""PyTorch port vs the JAX package on Kamani rheology discovery: the data
generator and `KamaniDataset`, the 1-D dense layer it runs on, the loss and
its parameter gradients in f64 and f32_ir with every deviation knob, the
optimizer's schedules against optax, the closed-loop error, and a resumed
`train()`.

Inputs come from numpy with fixed seeds; weights are the JAX package's
`init` parameters carried across by `state_dict_from_flax`; the port runs on
the CPU.  Tolerances: data exact (the same numpy/scipy code); the 1-D layer
1e-9 relative max-abs in f64 and f32_ir; the loss 1e-5 relative and its
gradients 1e-4 relative max-abs per parameter, as for Burgers with its
ResNet (the nets run in float32 in both packages and sum in another order:
the 1-D ResNet's outputs differ by 1.1e-6, which the solve carries into the
loss at 1.1e-6 and the gradients at 1.0e-5 with the head scaled by 10,
7e-8 and 1.2e-6 without); the optimizer's parameters after
each step within 4 float32 ulps (each Adam step rounds once per parameter,
in another order); the closed-loop errors to 1e-12 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mech_nn_discovery_pde_torch.config import PDEConfig as TorchConfig
from mech_nn_discovery_pde_torch.data import datasets as tdata
from mech_nn_discovery_pde_torch.data import generate as tgen
from mech_nn_discovery_pde_torch.discovery import kamani as tk
from mech_nn_discovery_pde_torch.layers.dense import PDEDenseLayer as TorchDense
from mech_nn_discovery_pde_torch.models.paramnet import torch_default_
from mech_nn_discovery_pde_tpu.config import PDEConfig as JaxConfig
from mech_nn_discovery_pde_tpu.data import datasets as jdata
from mech_nn_discovery_pde_tpu.data import generate as jgen
from mech_nn_discovery_pde_tpu.discovery import kamani as jk
from mech_nn_discovery_pde_tpu.layers.dense import PDEDenseLayer as JaxDense

torch.set_num_threads(1)

N_T, N_AMP = 96, 6


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """A small Kamani data set (96 time points, 6 amplitudes from 1e-3 to
    10), written by the port's generator."""
    root = tmp_path_factory.mktemp("data")
    tgen.ensure_dataset("kamani", str(root), n_t=N_T, n_amp=N_AMP)
    return str(root)


class _DS:
    t_step = 0.05


@pytest.fixture(scope="module")
def jax_params():
    """The JAX package's KamaniDiscovery.init parameters (numpy), one set
    for the module: none of the knobs the tests turn changes them."""
    jm = jk.KamaniDiscovery(jk.KamaniConfig(batch_size=2, plot_every=0), _DS())
    return jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))


def test_kamani_data_matches_jax(data_root, tmp_path):
    """The port's generator makes the JAX package's arrays bit for bit, in
    the same files; both datasets read them into the same items."""
    u, t = tgen.kamani(n_t=N_T, n_amp=N_AMP)
    ju, jt = jgen.kamani(n_t=N_T, n_amp=N_AMP)
    np.testing.assert_array_equal(u, ju)
    np.testing.assert_array_equal(t, jt)
    cached = tgen.ensure_dataset("kamani", data_root)
    np.testing.assert_array_equal(cached["u"], u)
    np.testing.assert_array_equal(cached["t"], t)
    td = tdata.KamaniDataset(data_root=data_root, noise_percent=2.0, seed=3)
    jd = jdata.KamaniDataset(data_root=data_root, noise_percent=2.0, seed=3)
    assert len(td) == len(jd) == (N_T // 24) * N_AMP
    assert td.t_step == jd.t_step
    for i in range(len(td)):
        for a, b in zip(td[i], jd[i]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("precision", ["f64", "f32_ir"])
def test_dense_layer_1d_matches_jax(precision):
    """PDEDenseLayer at coord_dims (24,), order 2, one initial value at
    index 0 (Kamani's system): u0 and the gradients of sum(u0 * w) with
    respect to coeffs, rhs, iv_rhs and steps, 1e-9."""
    bs, iv = 4, tk.KamaniDiscovery.IV_LIST
    rng = np.random.default_rng(0)
    c = rng.standard_normal((bs, 24, 3))
    c[..., 1] = 1.0 + rng.random((bs, 24))
    r, ivr = rng.standard_normal((bs, 24)), rng.standard_normal((bs, 1))
    st, w = np.full((bs, 23), 0.13), rng.standard_normal((bs, 24))
    kw = dict(bs=bs, coord_dims=(24,), order=2, n_ind_dim=1, n_iv=1, init_index_mi_list=iv,
              solver_dbl=True)
    jl = JaxDense(config=JaxConfig(precision=precision), **kw)
    tl = TorchDense(config=TorchConfig(precision=precision), device="cpu", **kw)

    def jf(c, r, ivr, st):
        u0 = jl(c, r, ivr, [st])[0].reshape(bs, -1)
        return (u0 * w).sum(), u0

    (_, ju0), jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2, 3), has_aux=True))(
        c, r, ivr, st)
    ta = [torch.tensor(a, requires_grad=True) for a in (c, r, ivr, st)]
    tu0 = tl(ta[0], ta[1], ta[2], [ta[3]])[0].reshape(bs, -1)
    (tu0 * torch.tensor(w)).sum().backward()
    assert rel(tu0.detach(), ju0) <= 1e-9
    for name, a, b in zip(("coeffs", "rhs", "iv_rhs", "steps"), ta, jg):
        assert rel(a.grad, b) <= 1e-9, name


# (precision, knobs, l1_w): the reference configuration in f32_ir, and in
# f64 every knob that changes the loss (the exponent prior, the head scale,
# the exponent tether and an L1 weight halfway through a warmup)
LOSS_CASES = [
    ("f32_ir", {}, None),
    ("f64", dict(exp_init_bias=-0.55, pnet_out_scale=10.0, exp_l2=0.03,
                 l1_warmup_epochs=100), 0.5),
]


@pytest.mark.parametrize("precision,knobs,frac", LOSS_CASES)
def test_kamani_loss_matches_jax(data_root, jax_params, precision, knobs, frac):
    """KamaniDiscovery.loss_fn at bs 4 on windows of the smallest and the
    largest amplitudes (|g'| down to 1e-3 cos t, where |g'|^er is large),
    on the JAX package's parameters: the loss and its parts (1e-5
    relative), the forward solve's rel_rnorm (1e-12 absolute: both solves
    reach their rounding floor), the learned rows and exponents (1e-5) and
    every parameter gradient (1e-4)."""
    kw = dict(batch_size=4, plot_every=0, **knobs)
    jcfg = jk.KamaniConfig(pde=JaxConfig(precision=precision, return_solve_stats=True), **kw)
    tcfg = tk.KamaniConfig(pde=TorchConfig(precision=precision, return_solve_stats=True), **kw)
    jds = jdata.KamaniDataset(data_root=data_root)
    tds = tdata.KamaniDataset(data_root=data_root)
    jm = jk.KamaniDiscovery(jcfg, jds)
    tm = tk.KamaniDiscovery(tcfg, tds, device="cpu")
    params = jax_params
    tm.load_state_dict(tk.state_dict_from_flax(params))
    items = [tds[i] for i in (0, 3, 4 * (N_AMP - 1), 4 * N_AMP - 1)]
    u, sd, sdd = (np.stack([it[k] for it in items]) for k in (1, 3, 4))
    l1_w = None if frac is None else tcfg.param_l1 * frac
    if "l1_warmup_epochs" in knobs:  # the train loop's weight at epoch 50
        assert tk.l1_weight(tcfg, 50) == l1_w

    args = [jnp.asarray(a) for a in (u, sd, sdd)] + ([] if l1_w is None else [l1_w])
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(params, *args)
    tl, taux = tm.loss_fn(u, sd, sdd, l1_w)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    for k in ("u_loss", "var_loss"):
        assert abs(float(taux[k]) - float(jaux[k])) <= 1e-5 * abs(float(jaux[k])), k
    assert abs(float(taux["fwd_rel_rnorm"]) - float(jaux["fwd_rel_rnorm"])) <= 1e-12
    want = tk.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jg))
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for n, g in got.items():
        assert rel(g.numpy(), want[n].numpy()) <= 1e-4, n
    jpr, jer = (np.asarray(a) for a in jm.get_params(params))
    tpr, ter = (a.detach().numpy() for a in tm.get_params())
    np.testing.assert_array_equal(tpr[3], [1.0, 0.0, 0.0])
    assert rel(tpr, jpr) <= 1e-5 and rel(ter, jer) <= 1e-5


def test_kamani_init_knobs():
    """The port's own init, from one seed: the exponent prior adds its bias
    to the raw exponents before the squash, pnet_zero_init starts every
    unpinned coefficient row at exactly 0, and torch_init draws each Linear
    and Conv layer as its own reset_parameters() does from the same seed."""

    def model(**kw):
        cfg = tk.KamaniConfig(batch_size=2, plot_every=0, **kw)
        return tk.KamaniDiscovery(cfg, _DS(), device="cpu",
                                  generator=torch.Generator().manual_seed(0))

    with torch.no_grad():
        raw, m = model().raw_exponents(), model(exp_init_bias=-0.55)
        assert torch.equal(m.raw_exponents(), raw - 0.55)
        assert torch.equal(m.get_params()[1], 2.0 * torch.tanh(raw - 0.55).reshape(4, 2))
    pr, _ = model(pnet_zero_init=True, pnet_out_scale=10.0).get_params()
    assert float(pr[:3].abs().max()) == 0.0 and pr[3].tolist() == [1.0, 0.0, 0.0]
    m = model(torch_init=True, net_dtype="f64")
    assert all(p.dtype == torch.float64 for p in m.parameters())
    for lin in (m.pnet.layers[0], m.tnet.blocks[0].conv, m.tnet.blocks[0].shortcut):
        ref = type(lin)(*lin.weight.shape[1::-1], *lin.weight.shape[2:3], dtype=torch.float64)
        g = torch.Generator().manual_seed(7)
        torch_default_(lin, g)
        torch.manual_seed(7)
        ref.reset_parameters()
        assert torch.equal(lin.weight, ref.weight) and torch.equal(lin.bias, ref.bias)


# build_optimizer cases (knobs, lr schedule steps or None): the freeze
# window, exp_lr_scale 0 and 0.1, and the cosine decay with a freeze and a
# scale together (the enet's decay restarts where its freeze ends)
OPT_CASES = [
    (dict(exp_freeze_epochs=2), None),
    (dict(exp_lr_scale=0.0), None),
    (dict(exp_lr_scale=0.1), None),
    (dict(lr_end=1e-4, exp_freeze_epochs=1, exp_lr_scale=0.5), 6),
]


@pytest.mark.parametrize("knobs,n_steps", OPT_CASES)
def test_build_optimizer_matches_optax(jax_params, knobs, n_steps):
    """Four steps of the port's Adam + LambdaLR against the JAX package's
    optax optimizer on the same parameters and the same four gradients (lr
    1e-2, one step per epoch): every parameter within 4 float32 ulps after
    each step; frozen (lr 0) parameters bit for bit unmoved."""
    cfg = tk.KamaniConfig(batch_size=2, lr=1e-2, plot_every=0, **knobs)
    jcfg = jk.KamaniConfig(**dataclasses.asdict(cfg) | {"pde": JaxConfig()})
    params = jax_params
    tm = tk.KamaniDiscovery(cfg, _DS(), device="cpu")
    tm.load_state_dict(tk.state_dict_from_flax(params))
    lr = cfg.lr
    if n_steps is not None:
        lr = optax.cosine_decay_schedule(cfg.lr, n_steps, alpha=cfg.lr_end / cfg.lr)
    jopt = jk.build_optimizer(jcfg, lr, 1)
    topt, sched = tk.build_optimizer(cfg, tm, 1, n_steps)
    jupdate = jax.jit(lambda p, s, g: jopt.update(g, s, p))
    rng = np.random.default_rng(2)
    jp, js = params, jopt.init(params)
    frozen_steps = cfg.exp_freeze_epochs if cfg.exp_lr_scale else 4
    for step in range(4):
        grads = jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(a.dtype), jp)
        upd, js = jupdate(jp, js, grads)
        jp = jax.tree_util.tree_map(np.asarray, optax.apply_updates(jp, upd))
        tg = tk.state_dict_from_flax(grads)
        for n, p in tm.named_parameters():
            p.grad = tg[n].clone()
        topt.step()
        sched.step()
        want = tk.state_dict_from_flax(jp)
        for n, p in tm.named_parameters():
            w = want[n].numpy()
            np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                       atol=0 if n.startswith("enet") and step < frozen_steps
                                       else 4 * np.spacing(np.abs(w)).max(), err_msg=n)
        moved = not torch.equal(tm.enet.layers[0].weight, tk.state_dict_from_flax(
            params)["enet.layers.0.weight"])
        assert moved == (step >= frozen_steps), step


def test_closed_loop_error_matches_jax():
    """closed_loop_error equals the JAX package's on the true model (below
    0.01 at every amplitude: it rolls the true model out against itself)
    and on a 2x-off sigma_t row (above 0.2); a degenerate learned model
    (p0 ~ 1e-9) scores inf within the integration budget."""
    pr, er = tk.true_params()
    np.testing.assert_array_equal(pr, jk.true_params()[0])
    errs = tk.closed_loop_error(pr, er)
    assert max(errs.values()) < 0.01, errs
    pr2 = pr.copy()
    pr2[1] *= 0.5
    errs2 = tk.closed_loop_error(pr2, er, amplitudes=(1, 10))
    assert min(errs2.values()) > 0.2, errs2
    for got, want in ((errs, jk.closed_loop_error(pr, er)),
                      (errs2, jk.closed_loop_error(pr2, er, amplitudes=(1, 10)))):
        assert got.keys() == want.keys()
        for a in got:
            assert got[a] == pytest.approx(want[a], rel=1e-12), a
    pr0 = pr.copy()
    pr0[0] = [1e-9, 0.0, 0.0]
    assert tk.closed_loop_error(pr0, er, amplitudes=(1,)) == {1: float("inf")}
