"""Profiling: the port's in-memory span and counter recorder, and phase
timing (port of the JAX package's utils/profiling.py).

`span(name, **attrs)` records `Span(name, parent, step, t0, t1, attrs)` of
the block it wraps, and `count(name, value, **attrs)` keeps a number or a
detached tensor (no synchronization), both only while a torch profiler
session is recording (`torch.profiler.profile`: a traced benchmark run or
an operator's own session).  Otherwise `span` returns one shared no-op
context after a single flag read and `count` keeps nothing; there is no
other switch.

Span times are host times (`time.perf_counter_ns`); the parent is the span
open around the block.  There is one stack for all threads: the autograd
engine runs a CUDA backward on its device thread while the thread that
called backward() waits, so spans nest in time across the two.  `step` is
the index of the latest `step` span entered since the last read (-1 before
the first).

The spans are not profiler ranges: a `record_function` range also shows on
the device's timeline (a user annotation over the kernels launched inside
it), where it would read as device work.  Instead, at the first span after
a read and on entry to every `step` span, an empty `record_function` range
`mgpde.clock` (its two ops, as `record_function` calls them) is opened and
closed twice in a row, with a host-clock read before, between and after
each.  It launches nothing, so nothing of it reaches the device timeline.
The profiler's own start and end of a range lie between those reads, which
bounds the offset between the two clocks; `spans(anchors)`, given the
times the profiler recorded for those ranges, maps the spans onto the
profiler's clock by the middle of the offsets every anchor allows.  A
thread coming back cold takes tens of microseconds to enter and leave the
first range (and more to enter than to leave, so that the midpoints of
range and bracket differ); the second, warm, keeps the bounds to a few.

`PhaseTimer` accumulates wall-clock time per named phase and records each
phase as a span; given a CUDA tensor to wait on, a phase ends with
`torch.cuda.synchronize` of that tensor's device, so its time includes the
device work it queued."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

# True while a torch profiler session records (torch.profiler.profile turns
# it on and off)
_profiler_enabled = torch._C._autograd._profiler_enabled

CLOCK_RANGE = "mgpde.clock"


class Span(NamedTuple):
    name: str
    parent: int  # index of the enclosing span in the list, -1 at the top
    step: int
    t0: int  # ns, on the profiler's clock once mapped
    t1: int
    attrs: Dict[str, Any]


class _Log:
    """What was recorded since the last `spans()`: closed spans as
    (id, name, parent id, step, t0, t1, attrs), ids in the order the spans
    were entered; the ids of the open spans; the clock anchors as host
    times (before, between, after) of their range's two ops."""

    def __init__(self):
        self.records: List[tuple] = []
        self.stack: List[int] = []
        self.anchors: List[Tuple[int, int, int]] = []
        self.next_id = 0
        self.step = -1


_LOG = _Log()
_COUNTS: Dict[str, List[tuple]] = {}
_NOOP = contextlib.nullcontext()


def _anchor(log: _Log) -> None:
    enter = torch.ops.profiler._record_function_enter_new
    leave = torch.ops.profiler._record_function_exit._RecordFunction
    for _ in range(2):
        a = time.perf_counter_ns()
        handle = enter(CLOCK_RANGE, None)
        b = time.perf_counter_ns()
        leave(handle)
        log.anchors.append((a, b, time.perf_counter_ns()))


class _Span:
    __slots__ = ("name", "attrs", "log", "id", "parent", "step", "t0")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        log = self.log = _LOG
        if self.name == "step":
            log.step += 1
        if self.name == "step" or not log.anchors:
            _anchor(log)
        self.id = log.next_id
        log.next_id += 1
        self.parent = log.stack[-1] if log.stack else -1
        self.step = log.step
        log.stack.append(self.id)
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        log = self.log
        log.stack.remove(self.id)
        log.records.append((self.id, self.name, self.parent, self.step, self.t0, t1, self.attrs))
        return False


def recording() -> bool:
    """Whether spans and counters are being recorded (a profiler session is)."""
    return _profiler_enabled()


def span(name: str, **attrs):
    """Context recording the block as a span while a profiler session
    records; `attrs` small (e.g. level=k, back=True)."""
    if not _profiler_enabled():
        return _NOOP
    return _Span(name, attrs)


def count(name: str, value, **attrs) -> None:
    """Keep `value` (a tensor: detached, not copied, no synchronization; or
    a number) under `name` with the current step while a profiler session
    records: as (step, value), or as (step, value, attrs) where `attrs` are
    given (small, e.g. level=k; a counter's every site gives them or none)."""
    if _profiler_enabled():
        if isinstance(value, torch.Tensor):
            value = value.detach()
        _COUNTS.setdefault(name, []).append((_LOG.step, value, attrs) if attrs
                                            else (_LOG.step, value))


def spans(anchors: Sequence[Tuple[float, float]] = ()) -> Tuple[List[Span], Optional[float]]:
    """The spans recorded since the last call, in the order they were
    entered, and clears them.  `anchors`: the (start, end) times, in ns, that
    the profiler recorded for the `mgpde.clock` ranges, in order.  An
    anchor's range starts between its first two host reads and ends
    between its last two, so it allows the offsets (profiler minus host)
    from max(start - between, end - after) to min(start - before,
    end - between); the spans are then on the profiler's clock, at the
    middle of the offsets every anchor allows, and the second value is the
    anchors' spread: the width of those offsets, ns (the mapping is off by
    at most half of it; negative where the anchors contradict one another,
    as clocks drifting apart would).  Without anchors: host times and None.
    Spans still open are left out (call it outside every span)."""
    global _LOG
    log, _LOG = _LOG, _Log()
    offset, spread = 0, None
    if anchors:
        if len(anchors) != len(log.anchors):
            raise ValueError(f"{len(anchors)} {CLOCK_RANGE} ranges given for "
                             f"{len(log.anchors)} recorded")
        pairs = list(zip(anchors, log.anchors))
        lo = max(max(s - b, t - c) for (s, t), (a, b, c) in pairs)
        hi = min(min(s - a, t - b) for (s, t), (a, b, c) in pairs)
        offset, spread = round((lo + hi) / 2), hi - lo
    records = sorted(log.records, key=lambda r: r[0])
    index = {r[0]: i for i, r in enumerate(records)}
    out = [Span(name, index.get(parent, -1), step, t0 + offset, t1 + offset, attrs)
           for _, name, parent, step, t0, t1, attrs in records]
    return out, spread


def counters() -> Dict[str, List[tuple]]:
    """The counters kept since the last call, by name: (step, value) or
    (step, value, attrs) in the order kept; and clears them."""
    global _COUNTS
    out, _COUNTS = _COUNTS, {}
    return out


class PhaseTimer:
    """Accumulating wall-clock timers per phase, each phase also a span.
    Usage:

        timer = PhaseTimer()
        with timer.phase("update", sync=loss):
            ...
        print(timer.report())
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync: Optional[torch.Tensor] = None):
        with span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if sync is not None and sync.is_cuda:
                    torch.cuda.synchronize(sync.device)
                self.totals[name] += time.perf_counter() - t0
                self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name:24s} {tot:9.3f}s  x{n:<5d} {tot / n * 1e3:9.2f} ms/call")
        return "\n".join(lines)
