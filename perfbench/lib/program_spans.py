"""Reduction of the port's own spans and counters (its `utils/profiling`:
`spans()` and `counters()`, recorded while the profiler traced the window's
first steps) together with the trace (lib/trace.py): the device's time by
the program span its kernels were launched in, and its idle time by the
program span the host was in while the device waited.

The spans are mapped onto the profiler's clock through the empty
`mgpde.clock` ranges the program opens (they launch nothing: no device
event).  A kernel counts for the innermost span open at the start of the
runtime call that launched it (the trace's `launch` time), and so for that
span's ancestors.  Idle time is every gap between the device's busy
intervals inside the traced window (the same intervals as idle_share's),
split over the innermost spans open on the host along it; where no span is
open, it counts for none.

Where the program records no spans (a checkout without the recorder) or the
trace holds no clock range, `reduce(obs)` gives None, and so does every
metric that reads it."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from perfbench.lib.common import log

CLOCK_RANGE = "mgpde.clock"
NONE = -1  # no span open


def innermost(spans: Sequence) -> List[Tuple[float, float, int]]:
    """(start, end, index) pieces of the spans' extent, each piece under the
    innermost span open there (NONE between top-level spans).  The spans
    are in the order they were entered, parents before children, and nest
    in time."""
    pieces: List[Tuple[float, float, int]] = []
    stack: List[int] = []
    cur = None

    def emit(end, idx):
        nonlocal cur
        if cur is not None and end > cur:
            pieces.append((cur, end, idx))
            cur = end

    for i, sp in enumerate(spans):
        while stack and spans[stack[-1]].t1 <= sp.t0:
            j = stack.pop()
            emit(spans[j].t1, j)
        if cur is None:
            cur = sp.t0
        emit(sp.t0, stack[-1] if stack else NONE)
        cur = max(cur, sp.t0)
        stack.append(i)
    while stack:
        j = stack.pop()
        emit(spans[j].t1, j)
    return pieces


class Reduced:
    """The spans (on the profiler's clock), the anchors' spread (ns), the
    counters, and per kernel of the trace the innermost span at its launch;
    idle seconds by innermost span."""

    def __init__(self, spans, spread_ns, counters, kernels, busy, t0, t1, n_steps):
        self.spans, self.spread_ns, self.counters = spans, spread_ns, counters
        self.n_steps = n_steps
        # on the trace's float clock, so that gaps split exactly
        pieces = [(float(s), float(e), i) for s, e, i in innermost(spans)]
        starts = [p[0] for p in pieces]

        def at(ts):
            i = bisect.bisect_right(starts, ts) - 1
            return pieces[i][2] if i >= 0 and ts < pieces[i][1] else NONE

        # kernels as (device s, innermost span at launch)
        self.kernels = [((t - s) * 1e-9, n, at(lt)) for s, t, n, lt in kernels]
        self.idle_s: Dict[int, float] = defaultdict(float)
        edges = [t0] + [x for b in busy for x in b] + [t1]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 > g0:
                self._split_gap(g0, g1, pieces, starts)

    def _split_gap(self, g0, g1, pieces, starts):
        pos = g0
        for k in range(max(bisect.bisect_right(starts, g0) - 1, 0), len(pieces)):
            s, e, idx = pieces[k]
            if s >= g1:
                break
            if e <= pos:
                continue
            if s > pos:
                self.idle_s[NONE] += (s - pos) * 1e-9
                pos = s
            end = min(e, g1)
            self.idle_s[idx] += (end - pos) * 1e-9
            pos = end
        if pos < g1:
            self.idle_s[NONE] += (g1 - pos) * 1e-9

    def within(self, names: Iterable[str]) -> set:
        """Indexes of the spans named in `names` and of their descendants."""
        names = set(names)
        inside = set()
        for i, sp in enumerate(self.spans):  # parents before children
            if sp.name in names or sp.parent in inside:
                inside.add(i)
        return inside

    def device_ms(self, names: Iterable[str]) -> Optional[float]:
        """Device ms a traced step of the kernels launched inside a span
        named in `names`; None where there is no such span."""
        inside = self.within(names)
        if not inside:
            return None
        return 1e3 * sum(d for d, _, i in self.kernels if i in inside) / self.n_steps

    def idle_ms(self, match: Callable[[str], bool]) -> Optional[float]:
        """Device-idle ms a traced step whose innermost span's name matches;
        None where no span's does."""
        idx = [i for i, sp in enumerate(self.spans) if match(sp.name)]
        if not idx:
            return None
        return 1e3 * sum(self.idle_s.get(i, 0.0) for i in idx) / self.n_steps

    def by_innermost(self) -> Dict[str, Tuple[float, float]]:
        """(device ms, idle ms) a traced step by innermost span name ('-':
        no span open)."""
        dev: Dict[str, float] = defaultdict(float)
        idle: Dict[str, float] = defaultdict(float)
        name = lambda i: self.spans[i].name if i != NONE else "-"
        for d, _, i in self.kernels:
            dev[name(i)] += d
        for i, v in self.idle_s.items():
            idle[name(i)] += v
        k = 1e3 / self.n_steps
        return {n: (k * dev[n], k * idle[n]) for n in sorted(set(dev) | set(idle))}


def reduce_trace(spans, spread_ns, counters, trace) -> Reduced:
    return Reduced(spans, spread_ns, counters, trace.kernels, trace.busy, trace.t0, trace.t1,
                   trace.n_steps)


def _read(obs) -> Optional[Reduced]:
    tr = obs.trace
    if tr is None:
        return None
    try:
        from mech_nn_discovery_pde_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans"):
        return None
    anchors = [(s, t) for s, t, n in tr.cpu if n == CLOCK_RANGE]
    if not anchors:
        return None
    spans, spread = profiling.spans(anchors)
    counters = profiling.counters()
    if not spans:
        return None
    red = reduce_trace(spans, spread, counters, tr)
    table = sorted(red.by_innermost().items(), key=lambda kv: -kv[1][1])
    log(f"program spans: {len(spans)} spans, {len(anchors)} clock anchors, spread "
        f"{spread:.0f} ns; device ms / idle ms a step by innermost span: "
        + ", ".join(f"{n} {d:.3f}/{i:.3f}" for n, (d, i) in table))
    return red


def reduce(obs) -> Optional[Reduced]:
    """The reduction of this run's program spans (read once a run: reading
    them clears the program's recorder), kept on `obs`."""
    if "_program_spans" not in vars(obs):
        vars(obs)["_program_spans"] = _read(obs)
    return vars(obs)["_program_spans"]
