"""A run with its timed path broken underneath, or its networks computed
below the configuration's precision, comes out not correct, for each fault
a training cell can have (tests/faults.py), at a size the CPU
holds: the cells' configurations cut to a few patches of a small grid, with
limits for that size (a sound run of the same seed passes them).  The look
for a chip is skipped; the rest of a run is driven as run.py drives it."""

import json
import shutil

import pytest
import torch

from perfbench.lib import compare, harness
from perfbench.lib.common import BENCH
from perfbench.tests.faults import FAULTS, LOWER

# the cells' configurations cut to a size the CPU holds: sizes, field, the
# numbers compared with their limits at that size, and the seed
TINY = {
    "gl-train": ({"solver_dim": [6, 12, 12], "n_grid": 2, "batch_size": 2},
                 {"nt": 24, "nx": 24, "ny": 24},
                 {"layer_in": 1e-5, "resid": 0.03, "dparam": 0.3}, 5),
    "burgers-train": ({"solver_dim": [8, 8], "batch_size": 2, "steps": [0.025, 0.5]},
                      {"nt": 16, "nx": 32},
                      {"layer_in": 3e-4, "resid": 0.01, "u0": 0.25, "dparam_all": 0.3}, 8),
}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = tmp_path_factory.mktemp("pb")
    dst = root / "perfbench"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns("__pycache__"))
    for cell, (sizes, field, limits, _) in TINY.items():
        wl = json.loads((dst / "workloads" / f"{cell}.json").read_text())
        wl["limits"] = limits
        (dst / "workloads" / f"{cell}.json").write_text(json.dumps(wl))
        cfg = json.loads((dst / "configs" / f"{wl['config']}.json").read_text())
        cfg.update(sizes)
        cfg["field"].update(field)
        (dst / "configs" / f"{wl['config']}.json").write_text(json.dumps(cfg))
    return dst


def _correct(bench, cell, monkeypatch, tmp_path):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    torch.manual_seed(0)
    tr = harness.build(cell, TINY[cell][3], "cpu", bench=bench)
    tr.check_steps(tr.ctx.workload["check_steps"])
    values = harness.reference_readings(tr, torch.device("cpu"))
    return compare.passed(compare.checks(values, tr.ctx.workload["limits"]))


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_sound_run_is_correct(bench, cell, monkeypatch, tmp_path):
    assert _correct(bench, cell, monkeypatch, tmp_path)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_fault_is_not_correct(bench, cell, fault, monkeypatch, tmp_path):
    with FAULTS[fault]():
        assert not _correct(bench, cell, monkeypatch, tmp_path)


@pytest.mark.parametrize("lower", sorted(LOWER))
@pytest.mark.parametrize("cell", sorted(TINY))
def test_networks_below_the_stated_precision_are_not_correct(bench, cell, lower, monkeypatch,
                                                             tmp_path):
    with LOWER[lower]():
        assert not _correct(bench, cell, monkeypatch, tmp_path)
