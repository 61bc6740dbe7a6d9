"""The `gl_long` configuration's pieces on the CPU: its reference solve
(reference/gl_long.py) against banded.py's exact one where both fit; the
port's trainer at a tiny gl_long-shaped configuration against the
reference, sound and with the control in its place; the K3 count of
work/multigrid_factored.py by hand; the new metrics' readers;
inputs/gl_long.py refusing a program whose config class lacks
`downsample_first`; and (marker `chip`) the control and bfloat16 networks
not correct at the cell's own size on the card."""

import dataclasses
import json
import shutil
import sys
import types

import numpy as np
import pytest
import torch

from perfbench import calibrate
from perfbench.lib import compare, harness, roofline
from perfbench.lib.common import BENCH, config, load_module
from perfbench.reference import gl as gl_ref
from perfbench.work import multigrid, multigrid_factored

CELL = "gl-long-bf16f"
GL_LONG = config("gl_long")
# gl_long cut to a size the CPU holds: (12, 12, 12) patches, n_grid 2 (the
# time axis halved: (6, 6, 6)), bs 2, from a field of 24 frames of 24 x 24
TINY = ({"solver_dim": [12, 12, 12], "n_grid": 2, "batch_size": 2},
        {"nt": 48, "nx": 24, "ny": 24}, 5)


def _system(dims, seed=5):
    """A gl-shaped least-squares system of both references at `dims`: the
    field, weights and problem of gl.py, 2 samples; (exact, new, vals, b)."""
    cfg = dict(GL_LONG, solver_dim=list(dims))
    cfg["field"] = dict(cfg["field"], nt=48, nx=32, ny=32)
    gl_in, gl_long = load_module("inputs", "gl"), load_module("reference", "gl_long")
    A = gl_in._field(cfg["field"], seed, "cpu", graph=False)
    data = {"u": A.real.numpy()[::2], "v": A.imag.numpy()[::2]}
    w = {k: v.double() for k, v in gl_in.make_weights(cfg, seed, "cpu").items()}
    exact, new = gl_ref.Reference(cfg, data, "cpu"), gl_long.Reference(cfg, data, "cpu")
    p = new.parts(w, np.array([[0, 0, 0], [4, 8, 12]]), False)
    bs = 2
    vals = torch.cat([p["coeffs"][:, new.eq_points, :].reshape(bs, -1),
                      new.static_vals.expand(bs, -1)], dim=1).detach()
    b = vals.new_zeros((bs, new.sys.n_rows))
    b[:, new.eq_rows] = p["rhs"][:, new.eq_points].detach()
    b[:, new.bnd_rows] = p["iv"].detach()
    return exact.solver, new.solver, vals, b


@pytest.mark.parametrize("dims", [(6, 8, 8), (10, 12, 8)])
def test_the_reference_solve_is_the_exact_one(dims):
    exact, new, vals, b = _system(dims)
    rel = lambda a, r: float(((a - r).norm(dim=1) / r.norm(dim=1)).max())
    g = torch.randn(vals.shape[0], exact.n_vars, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    got = new.solve(vals, b, lambda x, sl: g[sl])
    want = exact.solve(vals, b, lambda x, sl: g[sl])
    for a, r in zip(got, want):  # x, dL/dvals, dL/db = A dz
        assert rel(a, r) < 1e-9
    # dz itself, against the exact factor
    d = vals.new_zeros((2, exact.n_vars)).index_add_(1, exact.cols, vals * vals)
    s = torch.rsqrt(d)
    D, C = exact._factor(vals * s[:, exact.cols])
    dz_exact = s * exact._solve(D, C, s * g)
    dz = new._cg(vals, s, new._factor(vals * s[:, new.cols]), g=g, side="backward")
    assert rel(dz, dz_exact) < 1e-9


def test_a_solve_short_of_its_tolerance_is_nan(monkeypatch):
    _, new, vals, b = _system((6, 8, 8))
    gl_long = load_module("reference", "gl_long")
    monkeypatch.setattr(gl_long, "TOL", 1e-30)
    x, _, _ = new.solve(vals, b, lambda x, sl: torch.ones_like(x))
    assert torch.isnan(x).all()


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    dst = tmp_path_factory.mktemp("pb") / "perfbench"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((dst / "configs" / "gl_long.json").read_text())
    cfg.update(TINY[0])
    cfg["field"].update(TINY[1])
    (dst / "configs" / "gl_long.json").write_text(json.dumps(cfg))
    return dst


def test_the_tiny_cell_is_correct_and_its_control_is_not(bench, monkeypatch, tmp_path):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    limits = harness.load_cell(CELL)["limits"]
    torch.manual_seed(0)
    tr = harness.build(CELL, TINY[2], "cpu", bench=bench)
    assert tr.model.layer.mg_solver.dim_list == [(12, 12, 12), (6, 6, 6)]
    tr.check_steps(tr.ctx.workload["check_steps"])
    values = harness.reference_readings(tr, torch.device("cpu"))
    assert compare.passed(compare.checks(values, limits)), values
    lower = calibrate.readings(CELL, TINY[2], "reference-lower", torch.device("cpu"), bench)
    assert not compare.passed(compare.checks(lower, limits)), lower


def test_k3_count_by_hand():
    cfg = {"solver_dim": [24, 12, 12], "n_grid": 3, "downsample_first": True, "batch_size": 2,
           "pde": dict(GL_LONG["pde"], mg_smoother_steps_pre=2, mg_smoother_steps_post=3,
                       mg_fgmres_restarts_forward=2, mg_fgmres_restarts_backward=2)}
    solves = {"fwd_max": [4], "bwd_max": [2]}
    ops = {o.name: o for o in multigrid_factored.ops(cfg, solves, 1)}
    plain = {o.name: o for o in multigrid.ops(cfg, solves, 1)}
    assert not [n for n in ops if n.startswith("k2.")]
    # level 1: (12, 6, 6), time lines of 12 points, bw 84, 36 lines a sample
    bw, lines, n_vec = 12 * 7, 36, 12 * 36 * 7
    k3 = ops["k3.level1"]
    assert k3.count == plain["k2.level1"].count == 21 + (2 * 2 + 1 * 2) * (2 + 3)
    entries = 2 * lines * bw * (bw + 1) // 2  # W's upper triangle, 2 samples
    assert k3.flops == 4 * entries and k3.bytes == 2 * entries + 4 * 2 * 2 * n_vec
    assert k3.least_s == pytest.approx(k3.count * roofline.least_s(k3.bytes, k3.flops))
    assert ops["factor.level1"].flops == 2 * bw**3 / 3
    assert ops["factor.level1"].bytes == 6 * bw * bw
    assert ops["factor.level1"].count == 2 * lines
    for name in ("k1.level0", "k1.level1", "coarse_factor", "coarse_apply", "orth.fwd"):
        assert (ops[name].count, ops[name].flops, ops[name].bytes) == (
            plain[name].count, plain[name].flops, plain[name].bytes)
    assert multigrid.levels(cfg) == [(24, 12, 12), (12, 6, 6), (6, 3, 3)]


def test_inputs_refuse_a_program_without_downsample_first(monkeypatch, tmp_path):
    from mech_nn_discovery_pde_torch.discovery.ginzburg_landau import GLConfig

    old = types.ModuleType("pb_old_gl")
    old.GLConfig = dataclasses.make_dataclass(
        "GLConfig", [(f.name, f.type, dataclasses.field(default=None))
                     for f in dataclasses.fields(GLConfig) if f.name != "downsample_first"])
    monkeypatch.setitem(sys.modules, "pb_old_gl", old)
    cfg = dict(GL_LONG, program=dict(GL_LONG["program"], module="pb_old_gl"))
    inputs = load_module("inputs", "gl_long")
    with pytest.raises(ValueError, match="downsample_first"):
        inputs.make_data(cfg, 1, str(tmp_path), "cpu")
    assert not any(tmp_path.iterdir())  # nothing made before the check
    inputs.check_program(GL_LONG)  # today's program takes every key


def test_the_new_metrics_read_their_level_and_kernels():
    from perfbench.lib import program_spans
    from perfbench.lib.harness import Observed
    from perfbench.tests.test_pb_program_spans import _span, _SyntheticTrace

    # kernels a (1 ms, launched at 2.5) and b (3 ms, at 4.5) inside the
    # block applies of levels 0 and 1; c (0.2 ms, at 9.6) outside them
    at = dict(route="cluster", storage="bf16_factored")
    spans = [_span("step", -1, 0, 10), _span("vcycle.smooth_pre", 0, 2, 8, level=0),
             _span("vcycle.block_apply", 1, 2.4, 3.7, level=0, **at),
             _span("vcycle.block_apply", 1, 4.4, 7.7, level=1, **at)]
    obs = Observed(GL_LONG, {}, {}, {}, _SyntheticTrace(), BENCH)
    vars(obs)["_program_spans"] = program_spans.reduce_trace(spans, 0.0, {}, _SyntheticTrace())
    read = lambda m, o: load_module("metrics", m).read(o)
    assert read("block_apply_l0_ms", obs) == pytest.approx(1.0)
    assert read("block_apply_l1_ms", obs) == pytest.approx(3.0)
    # a program without the span (the parent) gives nothing to read
    bare = Observed(GL_LONG, {}, {}, {}, _SyntheticTrace(), BENCH)
    vars(bare)["_program_spans"] = program_spans.reduce_trace(spans[:2], 0.0, {},
                                                             _SyntheticTrace())
    assert read("block_apply_l0_ms", bare) is None and read("block_apply_l1_ms", bare) is None

    class K3Trace:
        n_steps = 1

        def device_s(self, names=(), patterns=(), launched_in=None):
            return 0.5 if "k3_factored_line_block_apply_cluster" in names else 0.0

    solves = {"fwd_max": [40], "bwd_max": [40]}
    k3 = sum(o.least_s for o in multigrid_factored.ops(GL_LONG, solves, 1)
             if o.name.startswith("k3."))
    obs = Observed(GL_LONG, {}, {}, solves, K3Trace(), BENCH)
    assert read("k3_roofline_pct", obs) == pytest.approx(100 * k3 / 0.5)
    assert read("k3_roofline_pct", Observed(config("gl"), {}, {}, solves, K3Trace(), BENCH)) is None


@pytest.mark.chip
@pytest.mark.parametrize("variant", ["reference-lower", "lower:bf16_networks"])
@pytest.mark.parametrize("seed", [2147483713, 2147483719])
def test_below_the_stated_precision_is_not_correct_on_the_card(cuda, variant, seed):
    # the control (the reference one step below each stated precision, in
    # the program's place) and the program's networks in bfloat16, at the
    # cell's own size
    limits = harness.load_cell(CELL)["limits"]
    values = calibrate.readings(CELL, seed, variant, cuda)
    print(variant, seed, values)
    assert not compare.passed(compare.checks(values, limits))
