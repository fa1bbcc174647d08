"""Kernels: the unit trial's share of its roofline in the profiled call,
the least card time of the call's trials (`roofline.trial_least_s` over
the valid units of each launch) over the profiler's device time of the
trial kernels (`ops/csrc/unit_trial.cu`)."""

from benchmark.metrics import _kernels

KERNELS = ("trial_small_kernel", "trial_large_kernel")


def read(rec):
    return _kernels.roofline_pct(rec, "trial", KERNELS)
