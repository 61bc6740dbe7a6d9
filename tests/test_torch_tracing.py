"""The port's span and counter recorder (utils/profiling) on the CPU: a
multigrid layer step on the (6, 12, 12) case at bs 2, n_grid 2, and a dense
f32_ir layer step on a (6, 8) case, each through `make_update` once with no
profiler and twice under `torch.profiler.profile(activities=[CPU])`.

Checked: with no profiler nothing is recorded and every number equals the
profiled run's bit for bit; under the profiler, the spans' tree (each
FGMRES preconditioner call holds one V-cycle: the four level spans of every
smoothed level and one coarse solve; one `fgmres.ortho` a FGMRES iteration;
each hierarchy build both factor sites), the counters against the solver's
own stats, the backward stats record's iterations, and the spans mapped
onto the profiler's clock holding their own aten ops.  Imports nothing of
JAX; small budgets (FGMRES 4 iterations in windows of 2, Chebyshev 2 + 2)
keep the module to a few seconds."""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mech_nn_discovery_pde_torch.config import PDEConfig
from mech_nn_discovery_pde_torch.data.datasets import PatchLoader
from mech_nn_discovery_pde_torch.discovery.common import make_update
from mech_nn_discovery_pde_torch.discovery.ginzburg_landau import GLDiscovery
from mech_nn_discovery_pde_torch.layers.dense import PDEDenseLayer
from mech_nn_discovery_pde_torch.layers.multigrid import MultigridLayer
from mech_nn_discovery_pde_torch.ops.normal_solve import make_lstsq_solve
from mech_nn_discovery_pde_torch.utils import profiling

torch.set_num_threads(1)

MG_CFG = PDEConfig(
    return_solve_stats=True, mg_smoother_steps_pre=2, mg_smoother_steps_post=2,
    mg_fgmres_max_iter_forward=4, mg_fgmres_restarts_forward=2,
    mg_fgmres_max_iter_backward=4, mg_fgmres_restarts_backward=2, mg_fgmres_tol=1e-12)
DIMS, BS, N_GRID = (6, 12, 12), 2, 2
VCYCLE = ("vcycle.smooth_pre", "vcycle.restrict", "vcycle.prolong", "vcycle.smooth_post")


class _Step(torch.nn.Module):
    """sum(u0^2) of the layer, the coefficients the parameter; the layer's
    solve records every stats_fn call."""

    def __init__(self, layer, coeffs, rhs, iv, steps):
        super().__init__()
        self.layer, self.records = layer, []
        layer._solve = make_lstsq_solve(layer.system, layer.inner, return_stats=True,
                                        stats_fn=lambda ph, st: self.records.append((ph, st)))
        self.coeffs = torch.nn.Parameter(torch.tensor(coeffs))
        self.args = (torch.tensor(rhs), torch.tensor(iv), [torch.tensor(s) for s in steps])

    def loss(self):
        u0, _, stats = self.layer(self.coeffs, *self.args)
        return (u0**2).sum(), stats


def _events(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def _run(model, traced: bool, steps: int):
    """`steps` updates (SGD at lr 0: the same step each time): per step the
    loss, the coefficients' gradient and the forward stats; then the spans
    (mapped onto the profiler's clock where traced), their spread, the
    counters and the profiler's events."""
    update = make_update(model.loss, torch.optim.SGD(model.parameters(), lr=0.0))
    out = []
    prof = profile(activities=[ProfilerActivity.CPU]) if traced else None
    if prof is not None:
        prof.start()
    for _ in range(steps):
        loss, stats = update()
        out.append((loss, model.coeffs.grad.clone(), stats))
    if prof is None:
        return out, profiling.spans(), profiling.counters(), []
    prof.stop()
    ev = _events(prof)
    anchors = [(s, t) for n, s, t in ev if n == profiling.CLOCK_RANGE]
    return out, profiling.spans(anchors), profiling.counters(), ev


@pytest.fixture(scope="module")
def mg():
    rng = np.random.default_rng(0)
    gs = int(np.prod(DIMS))
    coeffs = np.zeros((BS, gs, 7))
    coeffs[..., 0] = 1.0 + 0.2 * rng.standard_normal((BS, gs))
    coeffs[..., 1] = 1.0
    coeffs[..., 5] = coeffs[..., 6] = -0.5
    rhs = 0.1 * rng.standard_normal((BS, gs))
    steps = [np.full((BS, d - 1), h) for d, h in zip(DIMS, (0.2, 0.3906, 0.3906))]
    layer = MultigridLayer(bs=BS, coord_dims=DIMS, order=2, n_iv=1,
                           init_index_mi_list=GLDiscovery.IV_LIST, n_grid=N_GRID,
                           downsample_first=False, config=MG_CFG, device="cpu")
    iv = 0.1 * rng.standard_normal((BS, layer.system.n_init_rows))
    model = _Step(layer, coeffs, rhs, iv, steps)
    plain = _run(model, traced=False, steps=1)
    n_plain = len(model.records)
    traced = _run(model, traced=True, steps=2)
    return dict(model=model, plain=plain, traced=traced, records=model.records[n_plain:])


def _children(spans, i):
    return [s for s in spans if s.parent == i]


def _descendants(spans, i):
    out, frontier = [], {i}
    for j, s in enumerate(spans):  # parents come before their children
        if s.parent in frontier:
            frontier.add(j)
            out.append(s)
    return out


def test_untraced_steps_record_nothing_and_match_traced(mg):
    out, (spans, spread), counters, _ = mg["plain"]
    assert spans == [] and spread is None and counters == {}
    (loss, grad, stats), = out
    tloss, tgrad, tstats = mg["traced"][0][0]
    assert torch.equal(loss, tloss) and torch.equal(grad, tgrad)
    for k, v in stats.items():
        assert torch.equal(v, tstats[k]), k


def test_each_precond_call_holds_one_vcycle(mg):
    spans = mg["traced"][1][0]
    pcs = [i for i, s in enumerate(spans) if s.name == "fgmres.precond"]
    assert pcs
    for i in pcs:
        kids = Counter((s.name, s.attrs.get("level")) for s in _children(spans, i))
        want = {(n, k): 1 for n in VCYCLE for k in range(N_GRID - 1)}
        want[("vcycle.coarse", N_GRID - 1)] = 1
        assert kids == want


def test_ortho_spans_count_the_iterations(mg):
    spans, _ = mg["traced"][1]
    counters = mg["traced"][2]
    solves = [i for i, s in enumerate(spans) if s.name == "fgmres"]
    recs = mg["records"]
    assert len(solves) == len(recs) == 4  # forward and backward, 2 steps
    for i, (phase, st) in zip(solves, recs):
        assert spans[i].attrs == {"back": phase == "backward"}
        n = sum(s.name == "fgmres.ortho" for s in _descendants(spans, i))
        assert n == int(st["iters"].max()) > 0
    for side, phase in (("fwd", "forward"), ("bwd", "backward")):
        its = [st["iters"] for ph, st in recs if ph == phase]
        got = counters[f"fgmres.iters.{side}"]
        assert [s for s, _ in got] == [0, 1]
        assert all(torch.equal(a, b) for (_, a), b in zip(got, its))
        # FGMRES's own residual over its rhs: the layer's f64 residual of
        # the same solution, as the stats give it
        rel = [r for _, r in counters[f"fgmres.rel_resid.{side}"]]
        want = [st["rel_rnorm"] for ph, st in recs if ph == phase]
        assert all(torch.allclose(r, w, rtol=1e-6, atol=0) for r, w in zip(rel, want))


def test_backward_stats_record_has_the_solves_iterations(mg):
    recs = mg["records"]
    back = [st for ph, st in recs if ph == "backward"]
    assert back and all({"iters", "fgmres_rnorm", "rnorm", "rel_rnorm", "finite"} <= set(st)
                        for st in back)
    got = [t for _, t in mg["traced"][2]["fgmres.iters.bwd"]]
    assert all(torch.equal(st["iters"], t) for st, t in zip(back, got))


def test_each_hierarchy_build_has_both_factor_sites(mg):
    spans = mg["traced"][1][0]
    builds = [i for i, s in enumerate(spans) if s.name == "hierarchy"]
    assert len(builds) == 2
    for i in builds:
        sub = _descendants(spans, i)
        assert sum(s.name == "hierarchy.coarse_factor" for s in sub) == 1
        blocks = [s for s in sub if s.name == "hierarchy.block_factor"]
        assert sorted(spans[s.parent].attrs["level"] for s in blocks) == list(range(N_GRID - 1))
        assert all(spans[s.parent].name == "hierarchy.level" for s in blocks)


def test_mapped_spans_hold_their_aten_ops(mg):
    (spans, spread), ev = mg["traced"][1], mg["traced"][3]
    assert spread is not None and spread >= 0
    sites = [s for s in spans if s.name.startswith("hierarchy.") and s.name.endswith("_factor")]
    chol = [(s, t) for n, s, t in ev if n == "aten::linalg_cholesky_ex"]
    assert len(chol) == len(sites) == 4
    for s0, s1 in chol:
        assert sum(sp.t0 <= s0 and s1 <= sp.t1 for sp in sites) == 1
    # every step's work lies inside its step span
    steps = [s for s in spans if s.name == "step"]
    bmm = [(s, t) for n, s, t in ev if n == "aten::bmm"]
    assert len(steps) == 2 and bmm
    assert all(any(st.t0 <= s and t <= st.t1 for st in steps) for s, t in bmm)
    assert all(s.step in (0, 1) for s in spans)


def test_dense_layer_spans():
    """f32_ir, 2 refinement steps: one factor a step, a solve forward and
    backward, each with 3 preconditioner applications; nothing of the
    multigrid path and no counter."""
    rng = np.random.default_rng(1)
    dims = (6, 8)
    cfg = PDEConfig(precision="f32_ir", ir_steps=2, return_solve_stats=True)
    layer = PDEDenseLayer(bs=BS, coord_dims=dims, order=2, n_iv=1, config=cfg, device="cpu",
                          init_index_mi_list=[lambda nt, nx: (0, 0, [0, 0], [0, nx - 1])])
    coeffs = 0.3 * rng.standard_normal((BS, layer.grid_size, layer.n_orders))
    coeffs[..., 1] += 1.0
    rhs = 0.1 * rng.standard_normal((BS, layer.grid_size))
    model = _Step(layer, coeffs, rhs, rng.standard_normal((BS, dims[1])),
                  [0.05 + 0.02 * rng.random((BS, d - 1)) for d in dims])
    plain = _run(model, traced=False, steps=1)
    assert plain[1] == ([], None) and plain[2] == {}
    out, (spans, _), counters, _ = _run(model, traced=True, steps=1)
    assert torch.equal(out[0][1], plain[0][0][1])
    names = Counter(s.name for s in spans)
    assert names["dense.factor"] == 1 and names["dense.solve"] == 2
    for i, s in enumerate(spans):
        if s.name == "dense.solve":
            assert [c.name for c in _children(spans, i)] == ["dense.precond"] * 3
    assert not [n for n in names if n.startswith(("fgmres", "vcycle", "hierarchy"))]
    assert counters == {}
    assert [st for ph, st in model.records if ph == "backward"][-1].keys() == {
        "rnorm", "rel_rnorm", "finite"}


def test_loader_batches_are_spans():
    loader = PatchLoader(np.arange(10.0)[:, None], 3, seed=0)
    with profile(activities=[ProfilerActivity.CPU]):
        batches = list(loader)
    spans, _ = profiling.spans()
    assert len(batches) == 3 and [s.name for s in spans] == ["batch"] * 3
    assert all(s.parent == -1 and s.t0 < s.t1 for s in spans)


def test_block_apply_spans_and_launches(mg):
    """One `vcycle.block_apply` span per block apply of a smoothing pass,
    inside it (Chebyshev 2 + 2: two a pass), and one `block_apply.launches`
    count per block apply: the spans' and the lmax power iteration's 21 a
    smoothed level per hierarchy, one hierarchy a step; each with the
    level, the route ('plain' on the CPU), the storage and W's layout.
    Untraced, none (test_untraced_steps_record_nothing_and_match_traced)."""
    spans, counters = mg["traced"][1][0], mg["traced"][2]
    attrs = {"level": 0, "route": "plain", "storage": "f32",
             "layout": "dense"}  # n_grid 2: level 0 smoothed
    blocks = [s for s in spans if s.name == "vcycle.block_apply"]
    assert blocks and all(s.attrs == attrs for s in blocks)
    n_pass = 0
    for i, s in enumerate(spans):
        if s.name in ("vcycle.smooth_pre", "vcycle.smooth_post"):
            n_pass += 1
            kids = _children(spans, i)
            assert [c.name for c in kids] == ["vcycle.block_apply"] * 2
            assert all(c.attrs["level"] == s.attrs["level"] for c in kids)
    assert len(blocks) == 2 * n_pass
    launches = counters["block_apply.launches"]
    assert all(n == 1 and a == attrs for _, n, a in launches)
    for step in (0, 1):
        n_spans = sum(s.step == step for s in blocks)
        assert sum(st == step for st, _, _ in launches) == n_spans + 21
