"""What every part of the harness shares: where its files are, how they are
found by name, the check that no JAX module was loaded, and the card's
description.

Files are found by the names `BENCHMARK.json` gives:
  configs/<config>.json      a problem as it is run, its source, `assumed`, `reduced`
  workloads/<cell>.json      the configuration, the entry, the traffic parameters
  entries/<entry>.py         what runs one entry point of the program
  metrics/<metric>.py        the reader of one per-layer metric
  inputs/<config>.py         the data and weights of a configuration, from a seed
  reference/<config>.py      the plain reference of a configuration
  work/<kind>.py             operation and byte counts of one kind of work
so a cell, a configuration or a metric is added by adding files.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

# top-level module names that no benchmark run may load: JAX and the JAX
# package the port was made from (compared as whole names, so the port,
# whose name begins with the JAX package's, passes)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "mech_nn_discovery_pde_tpu"})


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names in `modules` (default sys.modules) that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


def workload(name: str, bench: Path = BENCH) -> Dict[str, Any]:
    return load_json(bench / "workloads" / f"{name}.json")


def config(name: str, bench: Path = BENCH) -> Dict[str, Any]:
    return load_json(bench / "configs" / f"{name}.json")


def load_module(kind: str, name: str, bench: Path = BENCH):
    """perfbench/<kind>/<name>.py as a module (names may hold '-' or '.')."""
    path = bench / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod_name = f"perfbench_{kind}_{name}".replace("-", "_").replace(".", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def metrics_for(spec: Dict[str, Any], cell: str, group: str) -> List[Dict[str, Any]]:
    """The entries of `group` ('end_to_end' or 'per_layer') that `cell`
    reports: those without a `workloads` list, and those that name it."""
    return [m for m in spec[group] if "workloads" not in m or cell in m["workloads"]]


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi prints them (None where
    it does not run)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
