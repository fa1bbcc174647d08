"""Tracing and stage timing.

The port of the JAX package's `utils/profiling.py` (`trace` :21,
`StageTimer` :40):

* `trace(path)` runs a block under `torch.profiler` (the host, and the
  card's kernels where there is one) and writes its Chrome trace to
  `path/trace.json` (Perfetto or chrome://tracing read it).  A profiler
  that fails to start raises; the JAX package's version went on without
  a trace.
* `StageTimer` collects named wall-clock stages and renders a report, as
  the reference reports HM's "Total Time".
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(path_to_trace_dir: str):
    """Profiles the block and writes `path_to_trace_dir/trace.json`;
    yields the `torch.profiler.profile`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(path_to_trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(path_to_trace_dir,
                                              "trace.json"))


class StageTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["stage                          total_s     calls   "
                 "per_call_ms"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            c = self.counts[name]
            lines.append(f"{name:<30} {t:9.3f} {c:9d} {1000 * t / c:12.3f}")
        return "\n".join(lines)
