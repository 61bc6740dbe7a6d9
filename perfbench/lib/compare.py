"""The comparison that decides `correct` for a training cell: the program's
readings from its check steps against the plain reference's steps from the
same weights over the same batches.

Numbers compared (each with its limit in the cell's workload file):
  loss     max over the check steps of |L_prog - L_ref| / |L_ref|
  layer_in the first step's layer inputs as the networks gave them, the
           coefficients and the rhs together: max over samples of
           ||in_prog - in_ref|| / ||in_ref|| (the networks' precision)
  resid    the first step's layer solution (all its unknowns) judged by
           the reference's own system: max over samples of the normal
           equations' relative residual ||A^T (b - A x)|| / ||A^T b||
  u0       the first step's layer solution: max over samples of
           ||u0_prog - u0_ref|| / ||u0_ref||
  grad_in  the first step's gradients of the layer's inputs (coefficients,
           rhs, boundary data), by the worst of the three
  grad1    the first gradient as Adam holds it, by the worst leaf
  dparam   each leaf's change after the check steps, by the worst leaf
  dparam_all  the change of all leaves together: |‖Δ_prog‖ - ‖Δ_ref‖| / ‖Δ_ref‖
"By the worst leaf" is the gap between the program's norm and the
reference's, over the larger of the reference's norm of that leaf and that
of the median leaf.  dparam leaves out leaves whose reference first gradient
is under a thousandth of the median leaf's: Adam moves those by round-off
alone.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional

NUMBERS = ("loss", "layer_in", "resid", "u0", "grad_in", "grad1", "dparam", "dparam_all")


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: Optional[Iterable[str]] = None) -> float:
    names = list(ref) if keep is None else list(keep)
    if not names:
        return 0.0
    med = statistics.median(ref[n] for n in names)
    gaps = []
    for n in names:
        p = prog.get(n, float("nan"))
        gaps.append(abs(p - ref[n]) / max(ref[n], med, 1e-300))
    return max(gaps) if all(math.isfinite(g) for g in gaps) else float("nan")


def readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    out = {}
    out["loss"] = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    out["resid"] = ref.get("resid", float("nan"))
    rel = lambda p, r: float(((p.to(r.device) - r).norm(dim=1) / r.norm(dim=1)).max())
    out["layer_in"] = rel(prog["layer_in"], ref["layer_in"])
    out["u0"] = rel(prog["u0"], ref["u0"])
    # the inputs that carry a gradient in the program (boundary data taken
    # straight from the batch carries none)
    out["grad_in"] = leaf_gap(prog["grad_in"], ref["grad_in"], list(prog["grad_in"]))
    out["grad1"] = leaf_gap(prog["grad1"], ref["grad1"])
    g = ref["grad1"]
    med = statistics.median(g.values())
    moved = [n for n in ref["dparam"] if g[n] >= 1e-3 * med]
    out["dparam"] = leaf_gap(prog["dparam"], ref["dparam"], moved)
    p = [prog["dparam"].get(n, float("nan")) for n in moved]
    r = [ref["dparam"][n] for n in moved]
    total = lambda v: math.sqrt(sum(x * x for x in v))
    out["dparam_all"] = abs(total(p) - total(r)) / total(r)
    return {k: float(v) for k, v in out.items()}


def checks(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """{name: {"value", "limit"}} for every number that has a limit."""
    return {k: {"value": values.get(k, float("nan")), "limit": limits[k]} for k in limits}


def passed(chk: Dict[str, Dict[str, float]]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in chk.values())

