"""Shared by the readers of the port's own spans and counters
(`utils/profiling.py` of the port): the tracer as the traced run left it,
taken from `sys.modules` (the encode path loaded it; nothing is imported
here).  Spans and counters are taken while a profiler session records,
so in the traced run they are those of the profiled call, and the
set-up spans (plan builds) recorded before it.  A reader finds nothing
without the profiled call's trace, or in a port that has no tracer."""

import sys

PORT = "context_adaptive_neural_network_based_prediction_tpu_torch"


def tracer(rec):
    if rec.get("trace") is None:
        return None
    mod = sys.modules.get(f"{PORT}.utils.profiling")
    return mod if hasattr(mod, "spans") else None


def span_s(rec, name):
    """Seconds of the finished spans named `name`, summed; None where there
    is none."""
    tr = tracer(rec)
    if tr is None:
        return None
    ns = [s[2] - s[1] for s in tr.spans()
          if s[0] == name and s[2] is not None]
    return sum(ns) * 1e-9 if ns else None


def per_frame_ms(rec, name):
    s = span_s(rec, name)
    return None if s is None else s * 1e3 / rec["counters"]["frames"]


def counter(rec, name):
    tr = tracer(rec)
    return None if tr is None else tr.counters().get(name)
