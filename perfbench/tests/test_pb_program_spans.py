"""lib/program_spans.py and the metrics that read it: exact device and idle
milliseconds on a synthetic trace; numbers from a real CPU-profiled tiny
multigrid step and a tiny dense step (the host's aten operations standing
for the device's work); None where the spans are absent (the dense path for
the GL metrics, a program without the recorder)."""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench.lib import program_spans
from perfbench.lib.common import BENCH, config, load_module
from perfbench.lib.harness import Observed
from perfbench.lib.trace import Trace

GL_METRICS = ("hier_block_factor_ms", "hier_coarse_factor_ms", "krylov_idle_ms",
              "vcycle_idle_ms", "fgmres_rel_resid_bwd")
MS = 1_000_000  # ns


def read(name, obs):
    return load_module("metrics", name).read(obs)


class _SyntheticTrace:
    """One step of 10 ms: three kernels, launched in `fgmres.ortho`,
    `vcycle.smooth_pre` and `hierarchy.block_factor`."""
    t0, t1, n_steps = 0, 10 * MS, 1
    kernels = [(2.6 * MS, 3.6 * MS, "a", 2.5 * MS), (4.6 * MS, 7.6 * MS, "b", 4.5 * MS),
               (9.7 * MS, 9.9 * MS, "c", 9.6 * MS)]
    busy = [(2.6 * MS, 3.6 * MS), (4.6 * MS, 7.6 * MS), (9.7 * MS, 9.9 * MS)]


def _span(name, parent, t0, t1, **attrs):
    from mech_nn_discovery_pde_torch.utils.profiling import Span

    return Span(name, parent, 0, t0 * MS, t1 * MS, attrs)


def test_synthetic_trace_gives_exact_device_and_idle_ms():
    spans = [_span("step", -1, 0, 10), _span("fgmres", 0, 1, 9),
             _span("fgmres.ortho", 1, 2, 3), _span("vcycle.smooth_pre", 1, 4, 6, level=0),
             _span("hierarchy.block_factor", 0, 9.5, 9.8)]
    counters = {"fgmres.rel_resid.bwd": [(0, torch.tensor([1e-3, 3e-3])),
                                         (1, torch.tensor([2e-3, 1e-3]))]}
    red = program_spans.reduce_trace(spans, 0.0, counters, _SyntheticTrace())
    by = red.by_innermost()
    # idle: step 0-1, 9-9.5, 9.9-10; fgmres 1-2, 3.6-4, 7.6-9; ortho 2-2.6;
    # smooth_pre 4-4.6; block_factor 9.5-9.7
    want = {"step": (0.0, 1.6), "fgmres": (0.0, 2.8), "fgmres.ortho": (1.0, 0.6),
            "vcycle.smooth_pre": (3.0, 0.6), "hierarchy.block_factor": (0.2, 0.2)}
    assert by.keys() == want.keys()
    for n, (d, i) in want.items():
        assert by[n] == pytest.approx((d, i), abs=1e-9), n
    assert red.device_ms({"fgmres"}) == pytest.approx(4.0)
    assert red.device_ms({"dense.precond"}) is None
    obs = Observed(config("gl"), {}, {}, {}, _SyntheticTrace(), BENCH)
    vars(obs)["_program_spans"] = red
    got = {m: read(m, obs) for m in GL_METRICS + ("dense_precond_ms",)}
    assert got == pytest.approx({
        "hier_block_factor_ms": 0.2, "hier_coarse_factor_ms": None, "krylov_idle_ms": 0.6,
        "vcycle_idle_ms": 0.6, "fgmres_rel_resid_bwd": 2.5e-3, "dense_precond_ms": None})


def _mg_model():
    from mech_nn_discovery_pde_torch.config import PDEConfig
    from mech_nn_discovery_pde_torch.discovery.ginzburg_landau import GLDiscovery
    from mech_nn_discovery_pde_torch.layers.multigrid import MultigridLayer

    dims, bs = (6, 12, 12), 2
    cfg = PDEConfig(mg_smoother_steps_pre=2, mg_smoother_steps_post=2,
                    mg_fgmres_max_iter_forward=4, mg_fgmres_restarts_forward=2,
                    mg_fgmres_max_iter_backward=4, mg_fgmres_restarts_backward=2)
    layer = MultigridLayer(bs=bs, coord_dims=dims, order=2, n_iv=1,
                           init_index_mi_list=GLDiscovery.IV_LIST, n_grid=2,
                           downsample_first=False, config=cfg, device="cpu")
    rng = np.random.default_rng(0)
    coeffs = np.zeros((bs, layer.grid_size, 7))
    coeffs[..., 0] = 1.0 + 0.2 * rng.standard_normal(coeffs.shape[:2])
    coeffs[..., 1] = 1.0
    coeffs[..., 5] = coeffs[..., 6] = -0.5
    steps = [np.full((bs, d - 1), h) for d, h in zip(dims, (0.2, 0.3906, 0.3906))]
    return layer, coeffs, rng.standard_normal((bs, layer.grid_size)), \
        rng.standard_normal((bs, layer.system.n_init_rows)), steps


def _dense_model():
    from mech_nn_discovery_pde_torch.config import PDEConfig
    from mech_nn_discovery_pde_torch.layers.dense import PDEDenseLayer

    dims, bs = (6, 8), 2
    layer = PDEDenseLayer(bs=bs, coord_dims=dims, order=2, n_iv=1,
                          init_index_mi_list=[lambda nt, nx: (0, 0, [0, 0], [0, nx - 1])],
                          config=PDEConfig(precision="f32_ir", ir_steps=2), device="cpu")
    rng = np.random.default_rng(1)
    coeffs = 0.3 * rng.standard_normal((bs, layer.grid_size, layer.n_orders))
    coeffs[..., 1] += 1.0
    steps = [0.05 + 0.02 * rng.random((bs, d - 1)) for d in dims]
    return layer, coeffs, 0.1 * rng.standard_normal((bs, layer.grid_size)), \
        rng.standard_normal((bs, dims[1])), steps


def _traced_obs(layer, coeffs, rhs, iv, steps, n_steps=2):
    """n_steps `make_update` steps of sum(u0^2) profiled on the CPU, each a
    `bench.step` range, as the harness traces them."""
    from mech_nn_discovery_pde_torch.discovery.common import make_update

    c = torch.nn.Parameter(torch.tensor(coeffs))
    args = (torch.tensor(rhs), torch.tensor(iv), [torch.tensor(s) for s in steps])

    def loss():
        return (layer(c, *args)[0] ** 2).sum(), None

    update = make_update(loss, torch.optim.SGD([c], lr=0.0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n_steps):
            with record_function("bench.step"):
                update()
    return Observed(config("gl"), {}, {}, {}, Trace(prof, DeviceType.CPU), BENCH)


@pytest.fixture(scope="module")
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_a_cpu_profiled_multigrid_step_reads_every_gl_metric(torch_threads):
    obs = _traced_obs(*_mg_model())
    got = {m: read(m, obs) for m in GL_METRICS}
    assert all(isinstance(v, float) and v >= 0 for v in got.values()), got
    assert got["hier_block_factor_ms"] > 0 and got["hier_coarse_factor_ms"] > 0
    red = program_spans.reduce(obs)
    assert red.spread_ns is not None and red.n_steps == 2
    # every idle moment of the window is split, none twice
    idle = sum(i for _, i in red.by_innermost().values())
    tr = obs.trace
    assert idle == pytest.approx(1e3 * (tr.window_s - tr.busy_s) / 2, rel=1e-9)
    assert read("dense_precond_ms", obs) is None


def test_the_dense_path_reads_none_of_the_gl_metrics(torch_threads):
    obs = _traced_obs(*_dense_model(), n_steps=1)
    assert read("dense_precond_ms", obs) > 0
    assert {m: read(m, obs) for m in GL_METRICS} == dict.fromkeys(GL_METRICS)


def test_a_program_without_the_recorder_reads_none(torch_threads, monkeypatch):
    from mech_nn_discovery_pde_torch.utils import profiling

    layer = _dense_model()
    obs = _traced_obs(*layer, n_steps=1)
    monkeypatch.delattr(profiling, "spans")
    assert read("dense_precond_ms", obs) is None
    monkeypatch.undo()
    profiling.spans(), profiling.counters()  # leave the recorder empty
