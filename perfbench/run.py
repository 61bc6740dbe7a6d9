"""Run one cell of the port's benchmark and print its result as the last
line of standard output.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's workload file (perfbench/workloads/<cell>.json) names its
configuration (configs/), its entry (entries/) and its traffic parameters.
A run makes its data and weights from the seed, builds the port's objects
through their public entry points, runs the cell's check steps (its warm-up:
every shape the window uses), then the entry back to back for `--seconds`;
then it frees the program's state, runs the plain reference over the check
steps and compares.  With --trace 0 it reports the cell's end-to-end
metrics, with --trace 1 its per-layer metrics (metrics/<name>.py) from spans,
counters and a profiler trace of the window's first steps.

It exits nonzero, printing no result, without a CUDA device (or with fewer
than the cell asks for), outside a checkout of the repository, or if a JAX
module was loaded."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# kernel caches live in the checkout, at fixed paths (the port builds its own
# kernels into mech_nn_discovery_pde_torch/_build/, also in the checkout)
for _var, _sub in (("CUDA_CACHE_PATH", "nv"), ("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(_var, str(ROOT / ".perfbench_cache" / _sub))
# one host thread for the CPU math libraries: the host's part of a step is
# launching kernels, and idle worker threads spinning on a shared host's
# cores make it noisy
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int = 2):
    print(msg, file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        import torch

        from perfbench.lib import harness
        from perfbench.lib.common import forbidden_modules
    except ImportError as e:
        fail(f"cannot import the benchmark's or the program's modules: {e}")
    try:
        import mech_nn_discovery_pde_torch  # noqa: F401
    except ImportError as e:
        fail(f"the program is not in this directory: {e}")
    wl = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        fail(f"cell {args.workload} needs {wl['chips']} CUDA device(s); {n} available")
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              t_start=T_START)
    bad = forbidden_modules()
    if bad:
        fail(f"modules of JAX or of the JAX package were loaded: {', '.join(bad)}", 3)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
