"""PyTorch port vs the JAX package on the training surface: the GL
discovery step with the ResNet transform (`nn_transform=True`) and its
backward-solve probe; and the port's own checkpoint/resume harness and
`utils/` (run directories, logger, checkpoints, phase timers, traces),
through a resumed `TrainHarness` and resumed Kamani and Burgers `train()`
runs.

Inputs come from numpy with fixed seeds; the port runs on the CPU.
Tolerances: GL loss 1e-6 relative and its parameter gradients 1e-4
relative max-abs (float64 solves to rel_rnorm <= 1e-6 in both packages; the
ResNets and ParamNets run in float32 in both and sum in another order); the
probe's iterations equal and its rel_rnorm 1e-4 relative at a 10-iteration
budget (measured 1.5e-5; near convergence the float32 preconditioner's
rounding, which differs between the packages, sets the residual: 7 % apart
at 4e-9 after 100 iterations); everything restored from a checkpoint bit
for bit.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mech_nn_discovery_pde_torch.config import PDEConfig as TorchConfig
from mech_nn_discovery_pde_torch.data import generate as tgen
from mech_nn_discovery_pde_torch.discovery import burgers as tbur
from mech_nn_discovery_pde_torch.discovery import ginzburg_landau as tgl
from mech_nn_discovery_pde_torch.discovery import kamani as tk
from mech_nn_discovery_pde_torch.discovery.common import TrainHarness
from mech_nn_discovery_pde_torch.models import resnet as tres
from mech_nn_discovery_pde_torch.utils import checkpoint, logger, profiling, rundir
from mech_nn_discovery_pde_tpu.config import PDEConfig as JaxConfig
from mech_nn_discovery_pde_tpu.discovery import burgers as jbur
from mech_nn_discovery_pde_tpu.discovery import ginzburg_landau as jgl
from mech_nn_discovery_pde_tpu.discovery import kamani as jk
from mech_nn_discovery_pde_tpu.models import resnet as jres

torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# fields a port config has beyond the JAX package's, with their defaults:
# GL's time coarsening, False as the JAX package's layer hard-codes it
PORT_ONLY = {"GLConfig": {"downsample_first": False}}


@pytest.mark.parametrize("port,ref,name", [(tgl, jgl, "GLConfig"), (tbur, jbur, "BurgersConfig"),
                                            (tk, jk, "KamaniConfig")])
def test_workload_config_fields_match_jax(port, ref, name):
    """Each discovery config has every field of the JAX package's, with the
    same defaults (its PDEConfig's included): resume_from and ckpt_every,
    GL's backward_probe_every, every Kamani knob; and no other field but
    those of PORT_ONLY, at their defaults."""
    got = dataclasses.asdict(getattr(port, name)())
    extra = {k: got.pop(k, None) for k in PORT_ONLY.get(name, {})}
    assert extra == PORT_ONLY.get(name, {})
    assert got == dataclasses.asdict(getattr(ref, name)())


# f64 outer FGMRES with a budget under which both packages converge (forward
# rel_rnorm 1e-7 at 80 iterations; 6e-6 at 60)
GL_SOLVE = dict(
    precision="f64", mg_solve_dtype="solver",
    mg_smoother_steps_pre=4, mg_smoother_steps_post=4,
    mg_fgmres_max_iter_forward=80, mg_fgmres_restarts_forward=20,
    mg_fgmres_max_iter_backward=80, mg_fgmres_restarts_backward=20,
    mg_fgmres_tol=1e-12, mg_smoother_residual=True, mg_fused_matvec=True,
    return_solve_stats=True,
)


class _GLDS:
    t_step_size = 0.2
    x_step_size = y_step_size = 0.3906


def test_gl_nn_transform_matches_jax():
    """GLDiscovery.loss_fn with nn_transform=True at (6, 16, 16), n_grid 2,
    bs 2, on the JAX package's parameters, with both ResNets narrowed to
    width 8, depth 2 in both packages: the loss and its parts, every
    gradient of the ParamNets and the ResNets, the forward solve's
    iterations; then backward_probe on the same batch and parameters with a
    10-iteration backward budget: per-sample iterations and rel_rnorm, all
    finite."""
    bs, dims = 2, (6, 16, 16)
    kw = dict(solver_dim=dims, n_grid=2, batch_size=bs, nn_transform=True)
    probe_solve = dict(GL_SOLVE, mg_fgmres_max_iter_backward=10, mg_fgmres_restarts_backward=10)
    jm, jprobe = (jgl.GLDiscovery(jgl.GLConfig(pde=JaxConfig(**c), **kw), _GLDS())
                  for c in (GL_SOLVE, probe_solve))
    tm, tprobe = (tgl.GLDiscovery(tgl.GLConfig(pde=TorchConfig(**c), **kw), _GLDS(),
                                  device="cpu") for c in (GL_SOLVE, probe_solve))
    for name in ("rnet1", "rnet2"):
        net = jres.ResNet(out_channels=1, in_channels=1, width=8, depth=2)
        setattr(jm, name, net)
        setattr(jprobe, name, net)
        for m in (tm, tprobe):
            setattr(m, name, tres.ResNet(out_channels=1, in_channels=1, width=8, depth=2,
                                         device="cpu"))
    params = jax.tree_util.tree_map(np.array, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    # each ParamNet's head shrunk around a well-posed equation (u_t + u -
    # 0.5 lap u = 0.5 v), as in the nn_transform=False comparison
    for p, head in zip(params["pnets"], ([1.0], [-0.5], [-0.5], [0.5])):
        dense = p["params"]["Dense_2"]
        dense["kernel"] *= 0.2
        dense["bias"][:] = 0.0
        dense["bias"][: len(head)] = head
    for m in (tm, tprobe):
        m.load_state_dict(tgl.state_dict_from_flax(params, nn_transform=True))
    rng = np.random.default_rng(0)
    u, v = (0.3 * rng.standard_normal((bs, *dims)) for _ in range(2))

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        params, jnp.asarray(u), jnp.asarray(v))
    tl, taux = tm.loss_fn(torch.tensor(u), torch.tensor(v))
    tl.backward()
    assert float(taux["fwd_rel_rnorm"]) <= 1e-6 and float(jaux["fwd_rel_rnorm"]) <= 1e-6
    assert float(taux["fwd_iters"]) == float(jaux["fwd_iters"])
    assert abs(float(tl.detach()) - float(jl)) <= 1e-6 * abs(float(jl))
    for k in ("u_loss", "var_u_loss"):
        assert abs(float(taux[k]) - float(jaux[k])) <= 1e-6 * abs(float(jaux[k])), k
    want = tgl.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jg), nn_transform=True)
    got = dict(tm.named_parameters())
    assert set(want) == set(got) and any(n.startswith("rnet2.") for n in got)
    for n, g in want.items():
        assert rel(got[n].grad, g) <= 1e-4, n

    jp = jax.jit(jprobe.backward_probe)(params, jnp.asarray(u), jnp.asarray(v))
    tp = tprobe.backward_probe(u, v)
    assert tp["iters"].tolist() == np.asarray(jp["iters"]).tolist() == [10, 10]
    np.testing.assert_allclose(tp["rel_rnorm"].numpy(), np.asarray(jp["rel_rnorm"]), rtol=1e-4)
    assert bool(tp["finite"].all()) and bool(np.asarray(jp["finite"]).all())


def test_rundir_logger_and_provenance(tmp_path, monkeypatch):
    """create_log_dir takes the first free integer directory; the logger
    writes its file; write_source_files writes git.diff and commit.txt, and
    where the tree is not a git checkout it writes git's error there and
    does not fail."""
    monkeypatch.chdir(tmp_path)
    d0, i0 = rundir.create_log_dir(root="logs/x", reuse=False)
    d1, i1 = rundir.create_log_dir(root="logs/x", reuse=False)
    assert (d0, d1) == (os.path.join("logs/x", "0"), os.path.join("logs/x", "1"))
    assert (i0, i1) == (0, 1)
    assert rundir.create_log_dir(root="logs/y") == (d1, i1)  # reused
    log = logger.setup(d0, name="t")
    log.info("hello")
    with open(os.path.join(d0, "log.txt")) as f:
        assert "hello" in f.read()
    monkeypatch.setattr(rundir, "_TREE", str(tmp_path))  # no .git here or above
    rundir.write_source_files(d1)
    for name in ("git.diff", "commit.txt"):
        assert os.path.isfile(os.path.join(d1, name))
    with open(os.path.join(d1, "commit.txt")) as f:
        assert "not a git repository" in f.read().lower()


def test_checkpointer_roundtrip_and_max_to_keep(tmp_path):
    """Each save is one <step>.pt under ckpt/, written through a temporary
    file; the 3 newest stay; restore gives the saved tensors back exactly
    (latest by default, or a given step), None where there is none."""
    ck = checkpoint.Checkpointer(str(tmp_path))
    assert ck.latest_step() is None and ck.restore() is None
    states = {s: {"w": torch.randn(4, generator=torch.Generator().manual_seed(s)),
                  "step": torch.tensor(s), "meta": {"lr": [0.1 * s], "name": None}}
              for s in range(5)}
    for s, st in states.items():
        ck.save(s, st)
    assert ck.steps() == [2, 3, 4] and ck.latest_step() == 4
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2.pt", "3.pt", "4.pt"]
    for step, want in ((None, states[4]), (3, states[3])):
        got = ck.restore(step, map_location="cpu")
        assert torch.equal(got["w"], want["w"]) and got["step"].item() == want["step"].item()
        assert got["meta"] == want["meta"]


def test_phase_timer_and_trace():
    """PhaseTimer accumulates per phase (a CPU tensor to wait on needs no
    synchronize); each phase is also a span, recorded only while a profiler
    session records."""
    from torch.profiler import ProfilerActivity, profile

    t = profiling.PhaseTimer()
    for _ in range(2):
        with t.phase("a", sync=torch.ones(3)):
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        with t.phase("b"):
            torch.ones(8).sum()
    assert t.counts == {"a": 2, "b": 1}
    assert "a" in t.report() and "x2" in t.report()
    spans, _ = profiling.spans()
    assert [(s.name, s.parent) for s in spans] == [("b", -1)] and spans[0].t1 > spans[0].t0


def _snapshot(h):
    """A deep copy of a harness's state (model, optimizer, scheduler)."""
    return _copy(h.state_dict())


def _copy(x):
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, dict):
        return {k: _copy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_copy(v) for v in x)
    return x


def _assert_same(a, b, path="state"):
    """a == b, tensors bit for bit (dtype and values)."""
    if torch.is_tensor(b):
        assert torch.is_tensor(a) and a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(b, dict):
        assert a.keys() == b.keys(), path
        for k in b:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def test_train_harness_restores_model_optimizer_and_scheduler(tmp_path):
    """A harness saves model, Adam and LambdaLR state at ckpt_every; a new
    harness over fresh objects restores all three bit for bit (Adam's step
    counts and moments, the scheduler's step and learning rates) and starts
    at the next epoch; a harness with resume=False starts at 0."""

    def objects(seed):
        torch.manual_seed(seed)
        model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
        opt = torch.optim.Adam([{"params": model[0].parameters()},
                                {"params": model[1].parameters()}], lr=1e-2)
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, [lambda k: 1.0 / (1 + k), lambda k: 0.0 if k < 2 else 0.5])
        return model, opt, sched

    model, opt, sched = objects(0)
    h = TrainHarness(str(tmp_path), model, opt, sched, ckpt_every=2, device="cpu")
    assert h.start_epoch == 0
    x = torch.randn(5, 3)
    for epoch in range(4):
        opt.zero_grad()
        model(x).square().sum().backward()
        opt.step()
        sched.step()
        h.end_epoch(epoch)
        if epoch == 1:
            saved = _snapshot(h)
    assert h.ckpt.steps() == [1, 3]
    assert "checkpoint" in h.timer.report()

    h2 = TrainHarness(str(tmp_path), *objects(1), ckpt_every=2, device="cpu")
    assert h2.start_epoch == 4
    _assert_same(h2.state_dict(), h.state_dict())
    assert h2.scheduler.last_epoch == 4 and h2.optimizer.state_dict()["state"][0]["step"] == 4
    assert h2.optimizer.param_groups[1]["lr"] == 0.5 * 1e-2
    h3 = TrainHarness(str(tmp_path), *objects(1), resume=False, ckpt_every=2, device="cpu")
    assert h3.start_epoch == 0
    h3.ckpt.save(1, saved)  # restore an older step's file: the same objects come back
    _assert_same(h3.ckpt.restore(1), saved)


class _Probe(TrainHarness):
    """A TrainHarness that keeps a copy of the state it starts from (after
    any restore, before the first step)."""

    started = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        _Probe.started.append((self.start_epoch, _snapshot(self)))


def test_kamani_train_resumes_from_checkpoint(tmp_path, monkeypatch):
    """Kamani train() for 1 epoch of 1 step, then again with resume_from
    that run dir and 2 epochs: the second run starts at epoch 1 from the
    checkpoint's model, Adam state and LR schedule bit for bit (a cosine
    decay and a one-epoch enet freeze, so the schedule's step matters), and
    its one step moves the parameters."""
    monkeypatch.chdir(tmp_path)
    tgen.ensure_dataset("kamani", str(tmp_path / "data"), n_t=96, n_amp=6)
    monkeypatch.setattr(tk, "TrainHarness", _Probe)
    _Probe.started.clear()
    kw = dict(batch_size=4, steps_per_epoch=1, ckpt_every=1, plot_every=0, lr_end=1e-7,
              exp_freeze_epochs=1, data_root=str(tmp_path / "data"),
              pde=TorchConfig(precision="f32_ir", return_solve_stats=True))
    tk.train(tk.KamaniConfig(epochs=1, **kw), device="cpu")
    run_dir = str(tmp_path / "logs" / "kamani" / "0")
    first = torch.load(os.path.join(run_dir, "ckpt", "0.pt"), weights_only=True)
    model = tk.train(tk.KamaniConfig(epochs=2, resume_from=run_dir, **kw), device="cpu")
    (s0, _), (s1, resumed) = _Probe.started
    assert (s0, s1) == (0, 1)
    _assert_same(resumed, first)
    assert resumed["scheduler"]["last_epoch"] == 1
    assert resumed["optimizer"]["param_groups"][1]["lr"] > 0  # the freeze has ended
    moved = [not torch.equal(p, first["model"][n]) for n, p in model.state_dict().items()]
    assert any(moved)
    assert os.path.isfile(os.path.join(run_dir, "ckpt", "1.pt"))
    with open(os.path.join(run_dir, "log.txt")) as f:
        assert "resumed from checkpoint at epoch 0" in f.read()


def test_burgers_train_resume_end_to_end(tmp_path, monkeypatch):
    """Burgers train() at (8, 16) for 1 epoch of 1 step in a run dir, then
    again with resume_from pointing at it: it resumes at epoch 1 with the
    checkpointed parameters (not a fresh init) and trains one more step."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tbur, "TrainHarness", _Probe)
    _Probe.started.clear()
    kw = dict(solver_dim=(8, 16), batch_size=2, nn_transform=False, steps_per_epoch=1,
              ckpt_every=1, pde=TorchConfig(precision="f64"), data_root=str(tmp_path / "data"))
    m1 = tbur.train(tbur.BurgersConfig(epochs=1, **kw), device="cpu")
    run_dir = str(tmp_path / "logs" / "burgers" / "0")
    m2 = tbur.train(tbur.BurgersConfig(epochs=2, resume_from=run_dir, **kw), device="cpu")
    (s0, _), (s1, resumed) = _Probe.started
    assert (s0, s1) == (0, 1)
    _assert_same(resumed["model"], m1.state_dict())
    diffs = [float((a - b).abs().max()) for a, b in zip(m1.parameters(), m2.parameters())]
    assert max(diffs) > 0.0
