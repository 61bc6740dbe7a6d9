"""Kamani rheology ODE discovery (dense path, learned exponents).

Learn the constitutive ODE

    p0(g') sigma_t + p3(g') sigma = p1(g') g' + p2(g') g''

where each p_i(g') = c_{i0} + c_{i1}|g'|^{e_{i0}} + c_{i2}|g'|^{e_{i1}} with
learned coefficients AND learned exponents e = 2 tanh(.) in [-2, 2]; the
sigma row (p3) is pinned to [1, 0, 0] to fix the overall scale.  Data:
stress trajectories of the true Kamani model under oscillatory shear, in
windows of 24 time points (solver_dim (24,)), bs 2048; a 1-D ResNet denoises
each window and gives the initial value.  Closed-loop validation rolls the
learned ODE out with solve_ivp against the true model.

Port of the JAX package's discovery/kamani.py: the training loop writes a
run directory (logs/kamani/<n>) with a log, source provenance and
checkpoints of the model, the optimizer and the LR schedule, and resumes
from one (`resume_from`).

Run:  python -m mech_nn_discovery_pde_torch.discovery.kamani [--epochs N]
      [--steps-per-epoch N] [--plot-every N] [--resume-from RUN_DIR]
      [--device cuda]
"""

from __future__ import annotations

import argparse
import math
import os
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from mech_nn_discovery_pde_torch.config import PDEConfig
from mech_nn_discovery_pde_torch.data.datasets import KamaniDataset, PatchLoader
from mech_nn_discovery_pde_torch.data.generate import KAMANI_PARAMS, kamani_rhs
from mech_nn_discovery_pde_torch.discovery.common import TrainHarness, fixed_steps, make_update
from mech_nn_discovery_pde_torch.layers.dense import PDEDenseLayer
from mech_nn_discovery_pde_torch.models import resnet
from mech_nn_discovery_pde_torch.models.paramnet import ParamNet
from mech_nn_discovery_pde_torch.models.paramnet import state_dict_from_flax as paramnet_state_dict
from mech_nn_discovery_pde_torch.utils import logger as logging_util
from mech_nn_discovery_pde_torch.utils import rundir


@dataclass
class KamaniConfig:
    solver_dim: tuple = (24,)
    batch_size: int = 2048
    lr: float = 5e-6
    # optional cosine decay lr -> lr_end over the full run (basin study)
    lr_end: Optional[float] = None
    param_l1: float = 0.01
    # L1 warmup (basin study): ramp the L1 weight linearly from 0 to
    # param_l1 over the first N epochs.  Mechanism-targeted deviation from
    # the reference recipe: the lazy basin is entered when the constant L1
    # pressure exceeds the 1/|p0|-squashed data gradient on the p1 row in
    # the first ~100 epochs; delaying the L1 lets the data term shape the
    # rows first.  0 = reference behavior.
    l1_warmup_epochs: int = 0
    # Shear-thinning exponent prior (basin study): shift the exponent
    # squash to er = 2*tanh(raw + bias).  Mechanism-targeted deviation:
    # with the p1 row pinned at 0, the exponents receive NO data gradient
    # (they only enter via pr[i,1:]*|shear|^er) and freeze at their random
    # init; growing p1 against wrong exponents then raises the loss, so p1
    # stays pinned (chicken-and-egg).  A negative init bias (e.g. -0.55 ->
    # er ~= -1.0 at init, matching the true (-1, -0.584) signs) lets the
    # data term reward growing p1 immediately.  0 = reference behavior.
    exp_init_bias: float = 0.0
    # Freeze the exponent net for the first N epochs (basin study): holds
    # the exponents at their (biased) init while the coefficient rows grow
    # into the monotone-descent corridor that exists when the exponents are
    # near truth.  0 = reference behavior.
    exp_freeze_epochs: int = 0
    # Permanent lr multiplier on the exponent net (basin study): the
    # corridor run's violent early row growth drags the exponents into
    # tanh saturation (er -> -1.98 vs true (-1, -0.584)) where the data
    # gradient is ~50x attenuated (d er/d raw = 2(1-tanh^2) ~ 0.04) and the
    # fit floors at closed-loop err ~0.5.  Scaling the enet lr keeps the
    # exponents near the (biased, near-true) init while the rows grow.
    # Composes with exp_freeze_epochs.  1.0 = reference behavior.
    exp_lr_scale: float = 1.0
    # Raw-space exponent tether (basin study): adds exp_l2 * mean(raw^2) to
    # the loss, pulling er toward the biased init 2*tanh(exp_init_bias).
    # Acting on raw (pre-tanh) the pull is NOT attenuated at the squash
    # bound, so unlike the data gradient it can rescue an already-saturated
    # run.  0 = reference behavior.
    exp_l2: float = 0.0
    # Coefficient-head deviations (basin study): start the coefficient rows
    # at exactly 0 (the entrance of the monotone-descent corridor) and/or
    # scale the head output so O(1) net movement reaches the O(100) true
    # rows within the epoch budget.  Defaults = reference behavior.
    pnet_zero_init: bool = False
    pnet_out_scale: float = 1.0
    epochs: int = 5000
    steps_per_epoch: Optional[int] = None
    seed: int = 10
    data_root: str = "data"
    plot_every: int = 10
    resume_from: Optional[str] = None
    ckpt_every: int = 25
    # net init/precision controls (reference: f64 nets, torch Linear init)
    net_dtype: str = "f32"
    torch_init: bool = False
    pde: PDEConfig = field(
        default_factory=lambda: PDEConfig(
            precision="f32_ir", log_solves=True, return_solve_stats=True
        )
    )


class KamaniDiscovery(nn.Module):
    # the initial value sigma(0)
    IV_LIST = [lambda nt: (0, 0, [0], [0])]

    def __init__(self, cfg: KamaniConfig, ds: KamaniDataset, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device(device)
        self.layer = PDEDenseLayer(
            bs=cfg.batch_size, coord_dims=cfg.solver_dim, order=2, n_ind_dim=1, n_iv=1,
            init_index_mi_list=self.IV_LIST, solver_dbl=True, config=cfg.pde, device=device,
        )
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.net_dtype = torch.float64 if cfg.net_dtype == "f64" else torch.float32
        nkw = dict(dtype=self.net_dtype, torch_init=cfg.torch_init, device=device,
                   generator=generator)
        self.pnet = ParamNet(n_out=4 * 3, depth=2, zero_out_init=cfg.pnet_zero_init,
                             out_scale=cfg.pnet_out_scale, **nkw)
        self.enet = ParamNet(n_out=4 * 2, depth=2, **nkw)
        self.tnet = resnet.ResNet1D(out_channels=1, in_channels=1, **nkw)
        self.steps = [fixed_steps(ds.t_step, cfg.batch_size, cfg.solver_dim[0], device=device)]

    def raw_exponents(self) -> torch.Tensor:
        """The exponent net's output plus `exp_init_bias`, (1, 8)."""
        return self.enet() + self.cfg.exp_init_bias

    def get_params(self):
        """(pr (4, 3) coefficient rows, row 3 pinned to [1, 0, 0];
        er (4, 2) exponents in [-2, 2])."""
        pr = self.pnet().reshape(4, 3)
        er = 2.0 * torch.tanh(self.raw_exponents()).reshape(4, 2)
        pin = torch.tensor([[1.0, 0.0, 0.0]], dtype=pr.dtype, device=pr.device)
        return torch.cat([pr[:3], pin]), er

    def forward(self, u, shear_d, shear_dd):
        bs = self.cfg.batch_size
        # the network runs in the nets' dtype; the solver boundary casts back
        up = self.tnet(u.to(self.net_dtype)[..., None])[..., 0].to(u.dtype)
        iv_rhs = up[:, 0:1]

        pr, er = self.get_params()
        sa = shear_d.abs()
        p0, p1, p2, p3 = (pr[i, 0] + pr[i, 1] * sa ** er[i, 0] + pr[i, 2] * sa ** er[i, 1]
                          for i in range(4))
        cols = [torch.zeros_like(p3)] * self.layer.n_orders
        cols[0], cols[1] = p3, p0  # sigma, sigma_t
        coeffs = torch.stack(cols, dim=-1)
        rhs = p1 * shear_d + p2 * shear_dd

        u0, _, stats = self.layer(coeffs, rhs, iv_rhs, list(self.steps))
        return u0.reshape(bs, -1), up, (pr, er), stats

    def loss_fn(self, u, shear_d, shear_dd, l1_w=None):
        """|u0 - u| + |up - u0| + l1_w * L1(pr) (+ exp_l2 * mean(raw^2));
        l1_w defaults to cfg.param_l1 (the L1-warmup schedule passes its
        own)."""
        bs = self.cfg.batch_size
        u, shear_d, shear_dd = (torch.as_tensor(a, device=self.device)
                                for a in (u, shear_d, shear_dd))
        u0, up, (pr, er), stats = self(u, shear_d, shear_dd)
        target = u.reshape(bs, -1)
        u_loss = (u0 - target).abs().mean(dim=-1)
        var_loss = (up.reshape(bs, -1) - u0).abs().mean(dim=-1)
        param_loss = pr.abs().sum()
        if l1_w is None:
            l1_w = self.cfg.param_l1
        loss = u_loss.mean() + var_loss.mean() + l1_w * param_loss
        if self.cfg.exp_l2:
            loss = loss + self.cfg.exp_l2 * (self.raw_exponents() ** 2).mean()
        aux = {"u_loss": u_loss.mean().detach(), "var_loss": var_loss.mean().detach()}
        if stats is not None:
            aux["fwd_rel_rnorm"] = stats["rel_rnorm"].max()
        return loss, aux


def state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """The JAX package's `KamaniDiscovery.init` parameters (flax pytree,
    numpy arrays) as this module's state_dict."""
    sd = {f"pnet.{k}": v for k, v in paramnet_state_dict(params["pnet"]).items()}
    sd.update({f"enet.{k}": v for k, v in paramnet_state_dict(params["enet"]).items()})
    sd.update({f"tnet.{k}": v for k, v in resnet.state_dict_from_flax(params["tnet"]).items()})
    return sd


# ---------------------------------------------------------------------------
# closed-loop validation: roll out the learned ODE
# ---------------------------------------------------------------------------


def learned_rhs(t, tau, amplitude, frequency, pr, er):
    sr = amplitude * frequency * np.cos(frequency * t)
    srr = -amplitude * frequency**2 * np.sin(frequency * t)
    sa = np.abs(sr)
    p = [pr[i, 0] + pr[i, 1] * sa ** er[i, 0] + pr[i, 2] * sa ** er[i, 1] for i in range(4)]
    return (p[1] * sr + p[2] * srr - p[3] * tau) / p[0]


def _budgeted(fn, budget=200_000):
    """Wrap an ODE rhs so integration cannot grind unboundedly: a learned
    model with |p0| ~ 0 (e.g. a zero-init coefficient head early in
    training) makes learned_rhs enormous and solve_ivp's step size
    collapse."""
    n = [0]

    def wrapped(t, y, *args):
        n[0] += 1
        if n[0] > budget:
            raise RuntimeError("ODE-integration call budget exceeded")
        return fn(t, y, *args)

    return wrapped


def _integrate_learned(t_max, t_eval, a, freq, pr, er):
    """solve_ivp on the learned ODE with a call budget; returns the
    trajectory array of shape (len(t_eval),) or None on failure."""
    from scipy.integrate import solve_ivp

    try:
        with np.errstate(all="ignore"):
            sol = solve_ivp(_budgeted(learned_rhs), [0, t_max], [0.0],
                            t_eval=t_eval, args=(a, freq, pr, er))
    except (RuntimeError, FloatingPointError, ValueError):
        return None
    if sol.y.shape[1] != len(t_eval) or not np.all(np.isfinite(sol.y[0])):
        return None
    return sol.y[0]


def simulate_overlay(epoch, pr, er, log_dir, amplitudes=(0.5, 1, 5, 10, 11, 12)):
    """Roll out learned vs true ODE and save Lissajous overlays (needs
    matplotlib, imported here only)."""
    from scipy.integrate import solve_ivp
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    freq = 1.0
    t_max = 5 * 2 * np.pi
    t_eval = np.linspace(0, t_max, 1000)
    fig, ax = plt.subplots(1, 2, figsize=(14, 7))
    for a in amplitudes:
        true = solve_ivp(kamani_rhs, [0, t_max], [0.0], t_eval=t_eval, args=(a, freq))
        learned = _integrate_learned(t_max, t_eval, a, freq, pr, er)
        strain = a * np.sin(freq * t_eval)
        if true.y.shape[1] == len(t_eval):
            ax[0].plot(strain, true.y[0], label=f"$\\gamma_0$={a} true")
        if learned is not None:
            ax[1].plot(strain, learned, label=f"$\\gamma_0$={a} learned")
    for a_, title in zip(ax, ["True equation", "Learned equation"]):
        a_.set_xlabel("Strain")
        a_.set_ylabel("Stress [Pa]")
        a_.set_title(title)
        a_.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(os.path.join(log_dir, f"fig_kamani_{epoch:04d}.png"), dpi=150)
    plt.close(fig)


def closed_loop_error(pr, er, amplitudes=(0.5, 1, 5, 10, 11, 12)):
    """Roll out the learned ODE with scipy solve_ivp across the amplitude
    sweep and return {amplitude: relative L2 trajectory error vs the true
    model}.  Failed/truncated integrations score inf."""
    from scipy.integrate import solve_ivp

    freq = 1.0
    t_max = 5 * 2 * np.pi
    t_eval = np.linspace(0, t_max, 1000)
    errs = {}
    for a in amplitudes:
        true = solve_ivp(kamani_rhs, [0, t_max], [0.0], t_eval=t_eval,
                         args=(a, freq))
        learned = _integrate_learned(t_max, t_eval, a, freq, pr, er)
        if true.y.shape[1] != len(t_eval) or learned is None:
            errs[a] = float("inf")
            continue
        denom = float(np.linalg.norm(true.y[0])) or 1.0
        errs[a] = float(np.linalg.norm(learned - true.y[0]) / denom)
    return errs


def true_params():
    p = KAMANI_PARAMS
    pr = np.array(
        [
            [p["eta_s"] / p["G"], p["tau_y"] / p["G"], p["k"] / p["G"]],
            [0, p["tau_y"], p["k"]],
            [0, p["tau_y"] / p["G"] * p["eta_s"], p["k"] / p["G"] * p["eta_s"]],
            [1.0, 0, 0],
        ]
    )
    er = np.array([[-1, p["n"] - 1]] * 4)
    return pr, er


def build_optimizer(cfg: KamaniConfig, model: KamaniDiscovery, steps_per_epoch: int,
                    n_steps: Optional[int] = None):
    """(Adam, LambdaLR): two parameter groups, the exponent net ('enet') and
    the rest, each with its own LR factor.  Both decay from cfg.lr to
    cfg.lr_end over `n_steps` (cosine, optax's cosine_decay_schedule) where
    lr_end is set; the enet factor is 0 for the first exp_freeze_epochs *
    steps_per_epoch steps, then exp_lr_scale times the decay restarted at
    the freeze's end (optax.join_schedules).  The freeze is a zero LR, not
    requires_grad=False: the frozen net's Adam moments keep updating, as
    optax's do.  Step k updates at the factors' values at k."""
    if cfg.lr_end is None:
        decay = lambda k: 1.0  # noqa: E731
    else:
        alpha = cfg.lr_end / cfg.lr

        def decay(k):
            k = min(k, n_steps)
            return (1 - alpha) * 0.5 * (1 + math.cos(math.pi * k / n_steps)) + alpha

    freeze = cfg.exp_freeze_epochs * steps_per_epoch

    def enet_factor(k):
        return 0.0 if k < freeze else cfg.exp_lr_scale * decay(k - freeze)

    enet = {id(p) for p in model.enet.parameters()}
    main = [p for p in model.parameters() if id(p) not in enet]
    optimizer = torch.optim.Adam([{"params": main}, {"params": list(model.enet.parameters())}],
                                 lr=cfg.lr)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, [decay, enet_factor])
    return optimizer, scheduler


def l1_weight(cfg: KamaniConfig, epoch: int) -> float:
    """The L1 weight of an epoch: param_l1, ramped linearly from 0 over the
    first l1_warmup_epochs epochs where that is set."""
    frac = min(1.0, epoch / cfg.l1_warmup_epochs) if cfg.l1_warmup_epochs else 1.0
    return cfg.param_l1 * frac


def train(cfg: Optional[KamaniConfig] = None, log=None, device="cuda"):
    """Adam training loop in a run directory (logs/kamani/<n>, or
    `cfg.resume_from`, whose latest checkpoint it resumes, LR schedule
    included); logs the learned rows and exponents, the loss and the forward
    solve's rel_rnorm per epoch, the closed-loop error and an overlay plot
    every `plot_every` epochs, and checkpoints every `ckpt_every`.  Returns
    the model."""
    cfg = cfg or KamaniConfig()
    if cfg.resume_from:
        log_dir, run_id = cfg.resume_from, cfg.resume_from
    else:
        log_dir, run_id = rundir.create_log_dir(root="logs/kamani", reuse=False)
    rundir.write_source_files(log_dir)
    log = log or logging_util.setup(log_dir, name="kamani")
    log.info(f"Kamani rheology discovery, solver dim {cfg.solver_dim}")

    ds = KamaniDataset(solver_dim=cfg.solver_dim, data_root=cfg.data_root)
    model = KamaniDiscovery(cfg, ds, device=device)
    steps_pe = cfg.steps_per_epoch or (len(ds) // cfg.batch_size)
    optimizer, scheduler = build_optimizer(cfg, model, steps_pe, steps_pe * cfg.epochs)
    update = make_update(model.loss_fn, optimizer, scheduler)
    loader = PatchLoader(ds, cfg.batch_size, seed=cfg.seed)

    tp, te = true_params()
    harness = TrainHarness(log_dir, model, optimizer, scheduler, log=log,
                           ckpt_every=cfg.ckpt_every, device=device)
    for epoch in range(harness.start_epoch, cfg.epochs):
        losses, aux = [], {}
        l1_w = l1_weight(cfg, epoch)
        for i, (_, u, _, sd, sdd) in enumerate(loader):
            if cfg.steps_per_epoch and i >= cfg.steps_per_epoch:
                break
            with harness.timer.phase("update"):
                loss, aux = update(u, sd, sdd, l1_w)
                losses.append(float(loss))
        pr, er = (a.detach().cpu().numpy() for a in model.get_params())
        log.info(f"param {pr}\nexps {er}")
        log.info(f"True param {tp}\nTrue exp {te}")
        msg = f"run {run_id} epoch {epoch}, loss {np.mean(losses):.3E}"
        if "fwd_rel_rnorm" in aux:
            msg += f"  fwd solve rel_rnorm {float(aux['fwd_rel_rnorm']):.2e}"
        log.info(msg)
        if cfg.plot_every and (epoch + 1) % cfg.plot_every == 0:
            simulate_overlay(epoch, pr, er, log_dir)
            cle = closed_loop_error(pr, er)
            log.info("closed-loop traj rel err: "
                     + ", ".join(f"a={a}: {e:.3f}" for a, e in cle.items()))
        harness.end_epoch(epoch)
    return model


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="Kamani rheology discovery (dense path)")
    ap.add_argument("--epochs", type=int, default=KamaniConfig.epochs)
    ap.add_argument("--steps-per-epoch", type=int, default=None)
    ap.add_argument("--plot-every", type=int, default=KamaniConfig.plot_every,
                    help="closed-loop check and overlay plot every N epochs (0: never; "
                         "plots need matplotlib)")
    ap.add_argument("--resume-from", default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    train(KamaniConfig(epochs=a.epochs, steps_per_epoch=a.steps_per_epoch,
                       plot_every=a.plot_every, resume_from=a.resume_from), device=a.device)
