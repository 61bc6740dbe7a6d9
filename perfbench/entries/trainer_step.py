"""Entry `trainer_step`: one Adam step of a discovery trainer of the port,
`make_update(<Model>.loss_fn, Adam)` over `PatchLoader` batches, as the
port's own `train()` runs it.  The configuration names the trainer's module,
model, config class and dataset; `inputs/<config>.py` makes the data and the
weights from the seed and `reference/<config>.py` is the plain reference.

Set-up builds one trainer and drives it through the cell's check steps
(also its warm-up: every shape the window uses), keeping what the
comparison needs: each step's loss, the first gradient as Adam holds it
(exp_avg / (1 - beta1) after step 1), the parameters after the last check
step, and, from the first step, the layer's solution u0 and the gradients
of the layer's inputs (coefficients, rhs, boundary data).  The window then
runs the same object's steps back to back, with a counter of each FGMRES
solve's iterations (multigrid layers).  With tracing, spans wrap the batch
fetch, the layer's forward, the backward and the optimizer step.  The
networks' precision is the configuration's (`networks_tf32`)."""

from __future__ import annotations

import dataclasses
import gc
import importlib
import time
from typing import Dict, List

import torch
from torch.profiler import record_function

from perfbench.lib.common import load_module, log


class Spans:
    """Host spans: with `ranges` each is a profiler range `bench.<name>`;
    with `timing` also timed, synchronized with the device at both ends,
    as lists of seconds by name (never in a profiled step, whose idle time
    the synchronizations would change)."""

    def __init__(self, device: torch.device):
        self.ranges = self.timing = False
        self.times: Dict[str, List[float]] = {}
        self.sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def run(self, name, fn, *args, **kw):
        if not self.ranges:
            return fn(*args, **kw)
        if self.timing:
            self.sync()
        t0 = time.perf_counter()
        with record_function(f"bench.{name}"):
            out = fn(*args, **kw)
            if self.timing:
                self.sync()
        if self.timing:
            self.times.setdefault(name, []).append(time.perf_counter() - t0)
        return out


class LayerProbe:
    """Stands in for the model's layer object: calls it, spanned, and on a
    captured call keeps its inputs (coefficients and rhs), u0 and hooks the
    gradients of its inputs."""

    def __init__(self, layer, spans: Spans):
        self._layer, self._spans = layer, spans
        self.capture = False
        self.layer_in = self.u0 = self.u = None
        self.grad_in: Dict[str, float] = {}

    def __getattr__(self, name):
        return getattr(self._layer, name)

    def __call__(self, coeffs, rhs, iv_rhs, steps_list):
        out = self._spans.run("layer", self._layer, coeffs, rhs, iv_rhs, steps_list)
        if self.capture:
            bs = out[0].shape[0]
            self.layer_in = torch.cat([coeffs.detach().reshape(bs, -1),
                                       rhs.detach().reshape(bs, -1)], dim=1).double().clone()
            self.u0 = out[0].detach().reshape(bs, -1).double().clone()
            self.u = out[1].detach().reshape(bs, -1, out[1].shape[-1]).double().clone()
            for name, t in (("coeffs", coeffs), ("rhs", rhs), ("iv", iv_rhs)):
                if t is not None and t.requires_grad:
                    t.register_hook(lambda g, n=name: self.grad_in.__setitem__(
                        n, float(g.detach().double().norm())))
        return out


class Trainer:
    def __init__(self, ctx):
        self.ctx = ctx
        cfg, dev = ctx.config, ctx.device
        # the networks' precision as the configuration states it
        tf32 = bool(cfg["networks_tf32"])
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        self.inputs = load_module("inputs", cfg["name"], ctx.bench)
        t0 = time.perf_counter()
        self.data = self.inputs.make_data(cfg, ctx.seed, ctx.data_root, dev)
        log(f"set-up: data {time.perf_counter() - t0:.2f} s")
        prog = cfg["program"]
        mod = importlib.import_module(prog["module"])
        from mech_nn_discovery_pde_torch.data import datasets
        from mech_nn_discovery_pde_torch.discovery.common import make_update

        log(f"set-up: program imported {time.perf_counter() - t0:.2f} s")

        cls = getattr(mod, prog["config"])
        # the configuration's sizes go to the program's config class by name
        args = {f.name: (tuple(cfg[f.name]) if isinstance(cfg[f.name], list) else cfg[f.name])
                for f in dataclasses.fields(cls) if f.name in cfg and f.name != "pde"}
        pcfg = cls(data_root=ctx.data_root, **args)
        pcfg.pde = dataclasses.replace(pcfg.pde, **{**cfg["pde"], **ctx.pde_override})
        self.bs = pcfg.batch_size
        ds = getattr(datasets, prog["dataset"])(solver_dim=tuple(cfg["solver_dim"]),
                                                data_root=ctx.data_root,
                                                **prog.get("dataset_args", {}))
        log(f"set-up: dataset {time.perf_counter() - t0:.2f} s")
        self.model = getattr(mod, prog["model"])(pcfg, ds, device=dev)
        log(f"set-up: model {time.perf_counter() - t0:.2f} s")
        self.w0 = self.inputs.make_weights(cfg, ctx.seed, dev)
        self.model.load_state_dict(self.w0, strict=True)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=pcfg.lr)
        self.update = make_update(self.model.loss_fn, self.optimizer)
        self.loader = datasets.PatchLoader(ds, self.bs, seed=ctx.stream_seed("batches"))
        self._it = iter(())
        self.spans = Spans(ctx.device)
        self.probe = LayerProbe(self.model.layer, self.spans)
        self.model.layer = self.probe
        log(f"set-up: data and trainer {time.perf_counter() - t0:.2f} s")
        self.solve_iters: List[tuple] = []
        self._counting = False

    # -- the feed and the step ---------------------------------------------
    def _next_batch(self):
        for _ in range(2):
            try:
                return next(self._it)
            except StopIteration:
                self._it = iter(self.loader)
        raise RuntimeError("the loader yields no batch")

    def step(self):
        batch = self.spans.run("batch", self._next_batch)
        loss, _ = self.update(*self.inputs.batch_args(batch))
        return batch, loss

    # -- set-up: the check steps -------------------------------------------
    def check_steps(self, n: int) -> None:
        """The first n steps, kept for the comparison."""
        self.check_losses = []
        # the reference's batches: the loader's plan, worked out again
        self.check_index = self.inputs.batch_plan(self.ctx.config, self.ctx.stream_seed("batches"), n)
        beta1 = self.optimizer.param_groups[0]["betas"][0]
        names = {id(p): k for k, p in self.model.named_parameters()}
        for k in range(n):
            t0 = time.perf_counter()
            self.probe.capture = k == 0
            batch, loss = self.step()
            self.probe.capture = False
            self.check_losses.append(float(loss))
            log(f"check step {k + 1}: loss {self.check_losses[-1]!r}, {time.perf_counter() - t0:.2f} s")
            if k == 0:
                self.grad1 = {names[id(p)]: float((s["exp_avg"].double() / (1 - beta1)).norm())
                              for p, s in self.optimizer.state.items()}
        self.dparam = {k: float((p.detach().double() - self.w0[k].double()).norm())
                       for k, p in self.model.named_parameters()}

    # -- counters and tracing -----------------------------------------------
    def count_solves(self) -> None:
        """From here on, keeps each multigrid solve's iterations as the
        solver returns them (read after the window, no synchronization)."""
        mg = getattr(self.probe._layer, "mg_solver", None)
        if mg is None or self._counting:
            return
        self._counting = True
        solve = mg.solve_normal

        def solve_normal(values, rhs_vec, hier, back=False):
            x, iters, rnorm = solve(values, rhs_vec, hier, back=back)
            self.solve_iters.append((back, iters))
            return x, iters, rnorm

        mg.solve_normal = solve_normal

    def trace_on(self) -> None:
        """Profiler ranges on every later step (spans, the hierarchy build,
        the dense factor and solves) and the solves counted;
        `spans.timing` turns the spans' timing on."""
        self.spans.ranges = True
        self.count_solves()
        layer = self.probe._layer
        mg = getattr(layer, "mg_solver", None)
        if mg is not None:
            build = mg.build_hierarchy

            def build_hierarchy(*a, **kw):
                with record_function("bench.hierarchy"):
                    return build(*a, **kw)

            mg.build_hierarchy = build_hierarchy
        inner = getattr(layer, "inner", None)
        if inner is not None and hasattr(inner, "factor"):
            factor, solve_f = inner.factor, inner._solve_factored

            def factor_w(values):
                with record_function("bench.dense_factor"):
                    return factor(values)

            def solve_w(values, rhs_n, f):
                with record_function("bench.dense_solve"):
                    return solve_f(values, rhs_n, f)

            inner.factor, inner._solve_factored = factor_w, solve_w
        opt_step = self.optimizer.step
        loss_fn = self.model.loss_fn

        # the backward is make_update's loss.backward(): from the loss's
        # return to the optimizer's step
        def timed_loss(*args):
            loss, aux = loss_fn(*args)
            if self.spans.timing:
                self.spans.sync()
            self._bwd = record_function("bench.backward")
            self._bwd.__enter__()
            self._bwd_t0 = time.perf_counter()
            return loss, aux

        def timed_step(*a, **kw):
            if self.spans.timing:
                self.spans.sync()
                self.spans.times.setdefault("backward", []).append(
                    time.perf_counter() - self._bwd_t0)
            self._bwd.__exit__(None, None, None)
            return self.spans.run("optimizer", opt_step, *a, **kw)

        from mech_nn_discovery_pde_torch.discovery.common import make_update

        self.optimizer.step = timed_step
        self.update = make_update(timed_loss, self.optimizer)

    def iterations(self) -> Dict[str, List]:
        """Iterations of each solve since counting began, as the solver ran
        them: per solve the most any sample took (the batch runs every
        window while one sample does) and the mean over samples, forward
        and backward."""
        out = {"fwd_max": [], "bwd_max": [], "fwd_mean": [], "bwd_mean": []}
        for back, it in self.solve_iters:
            side = "bwd" if back else "fwd"
            out[f"{side}_max"].append(int(it.max()))
            out[f"{side}_mean"].append(float(it.double().mean()))
        return out

    # -- after the window ----------------------------------------------------
    def program_readings(self) -> Dict:
        return {"losses": self.check_losses, "grad1": self.grad1, "dparam": self.dparam,
                "layer_in": self.probe.layer_in, "u0": self.probe.u0, "u": self.probe.u,
                "grad_in": dict(self.probe.grad_in)}

    def free(self) -> None:
        """Drop the program's objects and cached device memory."""
        for k in ("model", "optimizer", "update", "loader", "_it", "probe"):
            self.__dict__.pop(k, None)
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, device):
        ref_mod = load_module("reference", self.ctx.config["name"], self.ctx.bench)
        return ref_mod.Reference(self.ctx.config, self.data, device)


def build(ctx) -> Trainer:
    return Trainer(ctx)
