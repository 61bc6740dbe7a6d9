"""Profiling & phase timing (port of the JAX package's utils/profiling.py).

`PhaseTimer` accumulates wall-clock time per named phase; given a CUDA
tensor to wait on, a phase ends with `torch.cuda.synchronize` of that
tensor's device, so its time includes the device work it queued.  `trace`
records a torch.profiler trace (host, and the card where there is one) and
writes it into the run directory as a Chrome trace."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class PhaseTimer:
    """Accumulating wall-clock timers per phase.  Usage:

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
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None and sync.is_cuda:
                torch.cuda.synchronize(sync.device)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name:24s} {tot:9.3f}s  x{n:<5d} {tot / n * 1e3:9.2f} ms/call")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """torch.profiler trace of the block, written to <log_dir>/trace.json
    (open in chrome://tracing or Perfetto).  No-op if log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
