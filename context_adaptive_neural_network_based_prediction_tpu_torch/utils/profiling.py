"""Tracing and stage timing.

The port of the JAX package's `utils/profiling.py` (`trace` :21,
`StageTimer` :40), and the port's own spans and counters:

* `trace(path)` runs a block under `torch.profiler` (the host, and the
  card's kernels where there is one) and writes its Chrome trace to
  `path/trace.json` (Perfetto or chrome://tracing read it).  A profiler
  that fails to start raises; the JAX package's version went on without
  a trace.  The port's spans show in it over the kernels.
* `StageTimer` collects named wall-clock stages and renders a report, as
  the reference reports HM's "Total Time".
* `span(name, attrs=None, batch=False)` marks a stage of the encode
  paths (a context manager; `traced(name, ...)` is its decorator),
  `count(name, n)` counts at the same places.  They record while tracing
  is active: while `enable()` is in force, or while any `torch.profiler`
  session records (PyTorch's own flag, the one its `record_function`
  reads).  Inactive, a span is one boolean test that hands back a shared
  do-nothing object: it allocates nothing and enters no
  `record_function`.  Active, a span records its name, start and end on
  the profiler's clock (Unix-epoch nanoseconds, `time.time_ns`, the
  stamps the profiler's own events carry), the span it opened under, the
  batch it belongs to and its attrs, and opens
  `torch.profiler.record_function(name)`.  A root span opened with
  `batch=True` (an encode call) opens a new batch; every other span
  belongs to the batch open when it starts, so the spans of one encode
  call, and the packs of its frames that follow it, share one id.
  `setup_span` records always: work done once per configuration (a plan
  build) costs nothing per call.
* `spans()`, `counters()`, `self_times()` and `report()` read what was
  recorded; `reset()` empties it.  The kernels count their launches in
  their own `launches` dicts (`ops/{unit_fused,merger_int,merger,
  fc_forward}.py`), which the tracer leaves alone.

The tracer follows one thread: spans nest by the order they open and
close.  A span taken in a `spawn` worker process is recorded in that
process and lost with it.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _autograd_profiler


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


class Tracer:
    """The spans and counters of this process (one thread)."""

    def __init__(self):
        self.enabled = False
        self.reset()

    def reset(self):
        # Spans in the order they opened: [name, start_ns, end_ns (None
        # while open), parent index, batch, attrs].
        self.records = []
        self.open = []
        self.counts = defaultdict(int)
        self.batch = 0
        self.timer = StageTimer()


_TRACER = Tracer()


class _Span:
    """An active span: records itself into `_TRACER` and opens the
    profiler's `record_function` of its name."""

    __slots__ = ("name", "attrs", "batch", "rec", "records", "rf")

    def __init__(self, name, attrs, batch):
        self.name, self.attrs, self.batch = name, attrs, batch

    def __enter__(self):
        tr = _TRACER
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        parent = tr.open[-1] if tr.open else None
        if parent is None and self.batch:
            tr.batch += 1
        batch = tr.batch if parent is None else tr.records[parent][4]
        self.records = tr.records
        tr.open.append(len(tr.records))
        self.rec = [self.name, time.time_ns(), None, parent, batch,
                    self.attrs]
        tr.records.append(self.rec)
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        tr = _TRACER
        self.rec[2] = end
        # A `reset()` while the span was open keeps it out of the new
        # records.
        if tr.records is self.records:
            tr.open.pop()
            tr.timer.totals[self.name] += (end - self.rec[1]) * 1e-9
            tr.timer.counts[self.name] += 1
        self.rf.__exit__(*exc)
        return False


class _Off:
    """The span handed out while tracing is inactive."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def active() -> bool:
    """True while spans and counters record."""
    return _TRACER.enabled or _autograd_profiler._is_profiler_enabled


def span(name: str, attrs: dict | None = None, batch: bool = False):
    """A span of the encode paths, recorded only while tracing is active;
    `batch` opens a new batch when the span is a root."""
    if _TRACER.enabled or _autograd_profiler._is_profiler_enabled:
        return _Span(name, attrs, batch)
    return _OFF


def traced(name: str, attrs: dict | None = None, batch: bool = False):
    """Decorator: the function runs inside `span(name, attrs, batch)`,
    tracing tested at each call."""
    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name, attrs, batch):
                return fn(*args, **kwargs)
        return wrapper
    return decorate


def setup_span(name: str, attrs: dict | None = None):
    """A span recorded whether tracing is active or not, for work done
    once per configuration."""
    return _Span(name, attrs, False)


def count(name: str, n: int = 1):
    """Adds `n` to counter `name` while tracing is active."""
    if _TRACER.enabled or _autograd_profiler._is_profiler_enabled:
        _TRACER.counts[name] += n


def enable():
    _TRACER.enabled = True


def disable():
    _TRACER.enabled = False


def reset():
    """Empties the recorded spans and counters."""
    _TRACER.reset()


def spans() -> list:
    """The recorded spans in the order they opened: (name, start_ns,
    end_ns, parent, batch, attrs), `parent` the index of the enclosing
    span in this list (None at a root), `end_ns` None while open, `attrs`
    a dict ({} where the span was given none)."""
    return [(*r[:5], r[5] or {}) for r in _TRACER.records]


def self_times() -> dict:
    """{name: seconds} of the finished spans' self time: each span's
    duration less its finished children's."""
    recs = _TRACER.records
    child_ns = [0] * len(recs)
    for name, s0, s1, parent, _, _ in recs:
        if parent is not None and s1 is not None:
            child_ns[parent] += s1 - s0
    out = defaultdict(float)
    for (name, s0, s1, _, _, _), c in zip(recs, child_ns):
        if s1 is not None:
            out[name] += (s1 - s0 - c) * 1e-9
    return dict(out)


def counters() -> dict:
    """{name: count} of the spans' counters."""
    return dict(_TRACER.counts)


def report() -> str:
    """The spans' totals and counts by name, in `StageTimer`'s report."""
    return _TRACER.timer.report()
