"""The harness is driven by files: every cell resolves to its configuration,
entry, inputs, reference and metric readers, and a cell, a configuration or
a metric added as new files alone is found.  BENCHMARK.json keeps to the
benchmark's format."""

import json
import re
import shutil

import pytest

from perfbench.lib import harness
from perfbench.lib.compare import NUMBERS
from perfbench.lib.common import BENCH, ROOT, benchmark_spec, load_module, metrics_for

SPEC = benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves(cell):
    wl = harness.load_cell(cell)
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert wl["config"] == entry["config"] and wl["chips"] == entry["chips"]
    assert wl["why"] == entry["why"]
    assert wl["limits"] and set(wl["limits"]) <= set(NUMBERS)
    for group in ("end_to_end", "per_layer"):
        for m in metrics_for(SPEC, cell, group):
            if group == "per_layer":
                assert hasattr(harness.metric_reader(m["name"]), "read")
    cfg = json.loads((BENCH / "configs" / f"{wl['config']}.json").read_text())
    for kind in cfg["work"]:
        assert hasattr(load_module("work", kind), "ops")


def test_benchmark_json_format():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for w in SPEC["workloads"]:
        # every cell reports setup_s, another end-to-end metric and a per-layer
        # one, and every per-layer metric it reports moves one it reports
        mine = {m["name"] for m in metrics_for(SPEC, w["name"], "end_to_end")}
        assert "setup_s" in mine and len(mine) >= 2
        layer = metrics_for(SPEC, w["name"], "per_layer")
        assert layer and all(m["moves"] in mine for m in layer)
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    bench = tmp_path / "perfbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    wl = json.loads((bench / "workloads" / "gl-train.json").read_text())
    wl.update(name="gl-new", why="a new cell, added as a file")
    (bench / "workloads" / "gl-new.json").write_text(json.dumps(wl))
    (bench / "metrics" / "new_metric.py").write_text("def read(obs):\n    return 1.5\n")
    spec = dict(SPEC)
    spec["workloads"] = SPEC["workloads"] + [{"name": "gl-new", "config": "gl",
                                              "traffic": "train", "chips": 1, "why": "new"}]
    spec["per_layer"] = SPEC["per_layer"] + [{"name": "new_metric", "unit": "ms",
                                              "better": "lower", "source": "program_span",
                                              "layer": "trainer", "moves": "solves_per_s.gl",
                                              "workloads": ["gl-new"]}]
    assert harness.load_cell("gl-new", bench)["why"] == "a new cell, added as a file"
    names = [m["name"] for m in metrics_for(spec, "gl-new", "per_layer")]
    assert "new_metric" in names and "dense_factor_ms" not in names
    assert "new_metric" not in [m["name"] for m in metrics_for(spec, "gl-train", "per_layer")]
    assert load_module("metrics", "new_metric", bench).read(None) == 1.5
    # a quantity split by cell is read by its quantity's reader
    assert harness.metric_reader("bwd_ms.gl-new", bench).__name__.endswith("bwd_ms")
    with pytest.raises(FileNotFoundError):
        harness.load_cell("no-such-cell", bench)


@pytest.mark.parametrize("total,bs", [(256, 32), (900, 10)])
def test_the_reference_batch_plan_is_the_loaders(total, bs):
    # the reference works out the batches again: the port's PatchLoader's
    # order over three epochs
    import numpy as np

    from mech_nn_discovery_pde_torch.data.datasets import PatchLoader
    from perfbench.lib.seeds import loader_plan

    class Items:
        def __len__(self):
            return total

        def __getitem__(self, i):
            return np.array(i)

    loader = PatchLoader(Items(), bs, seed=2147483659)
    got = [b for _ in range(3) for b in loader]
    assert all((a == b).all() for a, b in zip(got, loader_plan(total, bs, 2147483659, len(got))))
