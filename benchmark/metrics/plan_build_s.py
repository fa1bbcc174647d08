"""Plan (set-up): seconds of the port's v1 plan builds (`v1.plan_build`:
the host tables of `wavefront._build_plan` and their upload), summed over
the run's set-up."""

from benchmark.metrics import _spans


def read(rec):
    return _spans.span_s(rec, "v1.plan_build")
