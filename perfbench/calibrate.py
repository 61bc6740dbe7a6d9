"""Readings of the numbers compared (lib/compare.py) over many seeds in one
process, to set a cell's limits: the program as configured ('program'), the
program with a changed solver setting ('pde:<key>=<value>', e.g. its own
lower-precision storage), the program's networks in TF32 where float32 is
stated ('tf32'), the program's networks below float32 ('lower:<name>',
tests/faults.LOWER), the control: the reference computed one step below
each stated precision, put in the program's place ('reference-lower'), or
the program with a planted fault ('fault:<name>', tests/faults.FAULTS).  No measured
window: set-up, the check steps, the reference.

    python3 perfbench/calibrate.py --workload gl-train --seeds 1 2 3 \
        --variant program --variant reference-lower

Prints one JSON line per seed and variant."""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from perfbench.lib import compare, harness  # noqa: E402
from perfbench.lib.common import load_module  # noqa: E402
from perfbench.reference.discovery import tf32  # noqa: E402


def _value(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return {"true": True, "false": False}.get(v, v)


def readings(cell: str, seed: int, variant: str, device, bench: Path = harness.BENCH):
    """The numbers compared for one seed and variant."""
    override, fault = {}, contextlib.nullcontext()
    if variant.startswith("pde:"):
        k, v = variant[4:].split("=", 1)
        override[k] = _value(v)
    elif variant.startswith(("fault:", "lower:")):
        from perfbench.tests.faults import FAULTS, LOWER

        kind, name = variant.split(":", 1)
        fault = (FAULTS if kind == "fault" else LOWER)[name]()
    with fault:
        tr = harness.build(cell, seed, device, bench, pde_override=override)
        with tf32(variant == "tf32"):
            tr.check_steps(tr.ctx.workload["check_steps"])
        if variant != "reference-lower":
            return harness.reference_readings(tr, device)
    tr.free()
    cfg, lr = tr.ctx.config, tr.ctx.config["lr"]
    ref_mod = load_module("reference", cfg["name"], tr.ctx.bench)
    lo = ref_mod.Reference(cfg, tr.data, device, lower=True)
    rl = lo.run(tr.w0, tr.check_index, lr)
    del lo
    hi = ref_mod.Reference(cfg, tr.data, device)
    rh = hi.run(tr.w0, tr.check_index, lr, judge=rl["u"])
    return compare.readings(rl, rh)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bench", default=None, help="the benchmark's directory (default: this one)")
    a = ap.parse_args()
    dev = torch.device(a.device)
    bench = Path(a.bench) if a.bench else harness.BENCH
    for seed in a.seeds:
        for var in a.variant or ["program"]:
            t0 = time.perf_counter()
            try:
                out = {"seed": seed, "variant": var,
                       "readings": readings(a.workload, seed, var, dev, bench)}
            except Exception as e:  # a control that crashes has failed, with no number
                out = {"seed": seed, "variant": var, "error": f"{type(e).__name__}: {e}"}
            out["seconds"] = time.perf_counter() - t0
            print(json.dumps(out), flush=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
