"""Reduction of one `torch.profiler` trace (CPU and CUDA activities) of the
traced window to what the per-layer metrics read: the device's work by
kernel name and by the benchmark span that launched it, its busy time (the
union of the work's intervals), the window's length, and the idle gaps named
by what the host was doing.

The traced window is the union of the `bench.step` ranges.  A kernel is
attributed to the CUDA runtime call that launched it (same correlation id);
that call's start says in which `bench.<span>` range it was launched."""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Tuple

from torch.autograd import DeviceType

# CUPTI overhead records, not work of the card
PROFILER_OVERHEAD = ("Command Buffer Full", "Buffer Flush")


def _ns(e, what: str) -> float:
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return float(f())
    return float(getattr(e, f"{what}_us")()) * 1e3


def is_kernel(name: str, event_name: str) -> bool:
    """Whether a trace event is a launch of the kernel `name` (the name is a
    whole word of the event's: k2_line_block_apply is not
    k2_line_block_apply_panels)."""
    return re.search(rf"(?<!\w){name}(?!\w)", event_name) is not None


class Trace:
    def __init__(self, prof, work: DeviceType = DeviceType.CUDA):
        """`work`: the device whose activities are the work (CPU only where
        a run has no CUDA device: then the host's aten operations are)."""
        dev, cpu = [], []
        for e in prof.profiler.kineto_results.events():
            start = _ns(e, "start")
            dur = _ns(e, "duration")
            name = e.name()
            if e.device_type() == DeviceType.CPU:
                cpu.append((start, start + dur, name, e.correlation_id()))
                if work == DeviceType.CUDA:
                    continue
            # the benchmark's own ranges also show on the device's timeline
            # (user annotations): no work
            if name.startswith("bench."):
                continue
            if e.device_type() == work and not any(o in name for o in PROFILER_OVERHEAD):
                if work == DeviceType.CUDA or name.startswith("aten::"):
                    dev.append((start, start + dur, name, e.correlation_id()))
        launch = {c: s for s, _, n, c in cpu if n.startswith("cu")}
        self.matched = sum(1 for d in dev if d[3] in launch)
        self.kernels = [(s, t, n, launch.get(c, s)) for s, t, n, c in dev]
        self.ranges: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        for s, t, n, _ in cpu:
            if n.startswith("bench."):
                self.ranges[n[len("bench."):]].append((s, t))
        for v in self.ranges.values():
            v.sort()
        self._starts = {k: [r[0] for r in v] for k, v in self.ranges.items()}
        steps = self.ranges.get("step", [])
        if not steps or not self.kernels:
            raise RuntimeError("the trace holds no bench.step range or no device work")
        self.t0, self.t1 = steps[0][0], steps[-1][1]
        self.n_steps = len(steps)
        self.cpu = sorted((s, t, n) for s, t, n, _ in cpu if not n.startswith("bench.step"))
        self._cpu_starts = [c[0] for c in self.cpu]
        self.busy = self._merge()

    def _merge(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for s, t, _, _ in sorted(self.kernels):
            s, t = max(s, self.t0), min(t, self.t1)
            if t <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return [tuple(i) for i in out]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy) * 1e-9

    def device_s_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for s, t, n, _ in self.kernels:
            out[n] += (t - s) * 1e-9
        return dict(out)

    def device_s(self, names=(), patterns=(), launched_in: str = None) -> float:
        """Device seconds of the kernels that are one of `names` (whole-word
        match) or match one of the regular expressions `patterns`, launched
        inside a `bench.<launched_in>` range where given."""
        rng = self.ranges.get(launched_in, []) if launched_in else None
        starts = self._starts.get(launched_in, [])
        total = 0.0
        for s, t, n, lt in self.kernels:
            if not (any(is_kernel(k, n) for k in names) or any(re.search(p, n) for p in patterns)):
                continue
            if rng is not None:
                i = bisect.bisect_right(starts, lt) - 1
                if i < 0 or lt > rng[i][1]:
                    continue
            total += (t - s) * 1e-9
        return total

    def _span_at(self, ts: float) -> str:
        best = None
        for name, rng in self.ranges.items():
            if name == "step":
                continue
            i = bisect.bisect_right(self._starts[name], ts) - 1
            if i >= 0 and ts <= rng[i][1] and (best is None or rng[i][0] > best[0]):
                best = (rng[i][0], name)
        return best[1] if best else "step"

    def _host_at(self, ts: float) -> str:
        i = bisect.bisect_right(self._cpu_starts, ts) - 1
        for j in range(i, max(-1, i - 5000), -1):
            s, t, n = self.cpu[j]
            if t >= ts and not n.startswith("bench."):
                return n
        return "?"

    def idle_gaps(self, top: int = 10, named: int = 2000) -> List[List]:
        """Idle time between device work in the window, summed by what the
        host was doing at each gap's middle (`bench` span / innermost host
        event), the `named` longest gaps named; the largest `top`."""
        edges = [self.t0] + [x for b in self.busy for x in b] + [self.t1]
        gaps = [(edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        out: Dict[str, float] = defaultdict(float)
        for k, (g, s) in enumerate(gaps):
            mid = s + g / 2
            name = f"{self._span_at(mid)} / {self._host_at(mid)}" if k < named else "other"
            out[name] += g * 1e-9
        return [[n, v] for n, v in sorted(out.items(), key=lambda kv: -kv[1])[:top]]

    def device_ops(self, top: int = 10) -> List[List]:
        by = self.device_s_by_name()
        return [[n[:200], v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
