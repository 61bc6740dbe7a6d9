"""One run of one cell: set-up and check steps, the measured window, the
traced metrics, the reference and the comparison.  Driven by the files that
`BENCHMARK.json` and the cell's workload file name (common.py)."""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from perfbench.lib import compare
from perfbench.lib.common import (BENCH, ROOT, benchmark_spec, config, load_module, log,
                                  metrics_for, power_limit, workload)
from perfbench.lib.seeds import stream_seed


def load_cell(cell: str, bench: Path = BENCH) -> Dict[str, Any]:
    """The cell's workload file, checked to resolve: its configuration, its
    entry and its inputs and reference files exist."""
    wl = workload(cell, bench)
    cfg = config(wl["config"], bench)
    for kind, name in (("entries", wl["entry"]), ("inputs", cfg["name"]),
                       ("reference", cfg["name"])):
        if not (bench / kind / f"{name}.py").exists():
            raise FileNotFoundError(f"cell {cell}: no {kind}/{name}.py")
    return wl


@dataclass
class Context:
    """What an entry is given: the configuration, the cell, the device, the
    seed and where the data goes."""
    config: Dict[str, Any]
    workload: Dict[str, Any]
    seed: int
    device: torch.device
    data_root: str
    bench: Path
    pde_override: Dict[str, Any] = field(default_factory=dict)

    def stream_seed(self, name: str) -> int:
        return stream_seed(self.seed, name)


@dataclass
class Observed:
    """What the per-layer metrics read (metrics/<name>.py)."""
    config: Dict[str, Any]
    spans: Dict[str, List[float]]
    iters: Dict[str, List]
    traced: Dict[str, List[int]]
    trace: Any
    bench: Path


def base_name(metric: str) -> str:
    """A metric split by cell (`solves_per_s.gl`) is its quantity's name
    before the first dot (`solves_per_s`)."""
    return metric.split(".")[0]


def metric_reader(name: str, bench: Path = BENCH):
    """metrics/<name>.py, else the reader of its quantity, metrics/<base>.py."""
    if (bench / "metrics" / f"{name}.py").exists():
        return load_module("metrics", name, bench)
    return load_module("metrics", base_name(name), bench)


def data_root(root: Path = ROOT) -> str:
    """Where a run writes its data: the run's TMPDIR, else inside the
    checkout (a fixed path either way)."""
    base = os.environ.get("TMPDIR") or str(root / ".perfbench_tmp")
    return os.path.join(base, "perfbench_data")


def build(cell: str, seed: int, device="cuda", bench: Path = BENCH, root: Path = ROOT,
          pde_override: Optional[Dict[str, Any]] = None):
    """The cell's entry object, built, before its check steps."""
    wl = load_cell(cell, bench)
    cfg = config(wl["config"], bench)
    ctx = Context(cfg, wl, seed, torch.device(device), data_root(root), bench,
                  dict(pde_override or {}))
    return load_module("entries", wl["entry"], bench).build(ctx)


def reference_readings(trainer, device) -> Dict[str, float]:
    """Frees the program, runs the reference over the check steps and
    returns the numbers compared."""
    prog = trainer.program_readings()
    trainer.free()
    ref = trainer.reference(device)
    rres = ref.run(trainer.w0, trainer.check_index, trainer.ctx.config["lr"], judge=prog["u"])
    del ref
    values = compare.readings(prog, rres)
    log(f"readings: {values}")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return values


def run_cell(cell: str, seed: int, seconds: float, trace: bool, t_start: float,
             device="cuda", bench: Path = BENCH, root: Path = ROOT) -> Dict[str, Any]:
    spec = benchmark_spec(root)
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    trainer = build(cell, seed, device, bench, root)
    wl, cfg = trainer.ctx.workload, trainer.ctx.config
    trainer.check_steps(wl["check_steps"])
    trainer.count_solves()
    sync()
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    prof, n_traced = None, wl.get("trace_steps", 1)
    if trace:
        trainer.trace_on()
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.start()
    losses, ends, n = [], [], 0
    t0 = time.perf_counter()
    while True:
        if prof is not None and n < n_traced:
            with record_function("bench.step"):
                _, loss = trainer.step()
                sync()
        else:
            _, loss = trainer.step()
        losses.append(loss)
        ends.append(time.perf_counter())
        n += 1
        if prof is not None and n == n_traced:
            prof.stop()
            traced_solves = list(trainer.solve_iters)
            trainer.spans.timing = True
        if time.perf_counter() - t0 >= seconds and (prof is None or n >= n_traced):
            break
    sync()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed = sum(1 for l in losses if not math.isfinite(float(l)))

    metrics: Dict[str, Dict[str, Any]] = {}
    dev_info: Dict[str, Any] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": wl["chips"], "memory_peak_bytes": max(peak, setup_peak)}
    breakdown = None
    its = trainer.iterations()
    steps_ms = [round(1e3 * (b - a), 1) for a, b in zip([t0] + ends, ends)]
    log(f"window steps, host ms: {steps_ms}")
    if its["fwd_mean"]:
        log(f"window solves, mean iterations: forward {[round(i, 2) for i in its['fwd_mean']]}; "
            f"backward {[round(i, 2) for i in its['bwd_mean']]}")
    if trace:
        from torch.autograd import DeviceType

        from perfbench.lib.trace import Trace

        tr = Trace(prof, DeviceType.CUDA if cuda else DeviceType.CPU)
        del prof
        traced = {"fwd_max": [int(i.max()) for b, i in traced_solves if not b],
                  "bwd_max": [int(i.max()) for b, i in traced_solves if b]}
        obs = Observed(cfg, trainer.spans.times, its, traced, tr, bench)
        for m in metrics_for(spec, cell, "per_layer"):
            v = metric_reader(m["name"], bench).read(obs)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
        log(f"trace: {len(tr.kernels)} device activities, {tr.matched} matched to a launch; "
            f"{tr.n_steps} steps in {tr.window_s:.4f} s, busy {tr.busy_s:.4f} s")
        del tr
    else:
        bs = cfg["batch_size"]
        e2e = {"solves_per_s": n * bs / window_s, "peak_mem_gib": peak / 2**30,
               "setup_s": setup_s}
        for m in metrics_for(spec, cell, "end_to_end"):
            metrics[m["name"]] = {"value": float(e2e[base_name(m["name"])]), "unit": m["unit"]}
    log(f"window: {n} steps in {window_s:.4f} s; set-up {setup_s:.4f} s; "
        f"card {power_limit() if cuda else 'none'}")

    values = reference_readings(trainer, device)
    chk = compare.checks(values, wl["limits"])
    result = {"correct": compare.passed(chk) and failed == 0, "attempted": n,
              "failed": failed, "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = chk
    return result
