"""Host half, the pack's share of the call: the share of the profiled
call's wall time (`trace.window_s`) spent in the port's `pack.grid`
spans, host time alone.  Whether the card is idle under those spans is
not read here: that takes the trace's CUDA intervals, which the harness
does not keep."""

from benchmark.metrics import _spans


def read(rec):
    s = _spans.span_s(rec, "pack.grid")
    window = rec["trace"]["window_s"] if rec.get("trace") else 0
    return None if s is None or window <= 0 else 100.0 * s / window
