"""No benchmark run loads JAX or the JAX package: the check compares whole
top-level names (the port's name begins with the JAX package's), the modules
a run imports load none of them, and run.py refuses to print a result
without a CUDA device or outside a checkout."""

import subprocess
import sys

from perfbench.lib.common import BENCH, ROOT, forbidden_modules


def test_whole_names_are_compared():
    assert forbidden_modules(["mech_nn_discovery_pde_torch.layers.dense", "jaxtyping",
                              "numpy", "flaxen"]) == []
    assert forbidden_modules(["jax.numpy", "optax", "mech_nn_discovery_pde_tpu.ops",
                              "mech_nn_discovery_pde_torch"]) == [
        "jax", "mech_nn_discovery_pde_tpu", "optax"]


def test_a_run_imports_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from perfbench.lib import harness, trace, compare\n"
        "from perfbench.lib.common import load_module, forbidden_modules\n"
        "for k, n in [('entries', 'trainer_step'), ('inputs', 'gl'), ('inputs', 'burgers'),\n"
        "             ('reference', 'gl'), ('reference', 'burgers'), ('work', 'multigrid'),\n"
        "             ('work', 'dense'), ('metrics', 'step_mfu')]:\n"
        "    load_module(k, n)\n"
        "import mech_nn_discovery_pde_torch.discovery.ginzburg_landau\n"
        "import mech_nn_discovery_pde_torch.discovery.burgers\n"
        "print(forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_result_without_cuda_or_outside_a_checkout(tmp_path):
    import torch

    cmd = [sys.executable, "perfbench/run.py", "--workload", "gl-train", "--seed",
           "2147483659", "--seconds", "1", "--trace", "0"]
    if not torch.cuda.is_available():
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT)
        assert out.returncode != 0 and out.stdout == ""
    # only BENCHMARK.json and the benchmark's files: no program to run
    import shutil

    shutil.copytree(BENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
