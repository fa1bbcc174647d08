"""Kernels: the integer merger's share of its roofline in the profiled
call, the least card time of the call's mergers (`roofline.
merger_int_least_s` over the valid units of each launch) over the
profiler's device time of `ops/csrc/merger_int.cu`'s kernel."""

from benchmark.metrics import _kernels

KERNELS = ("merger_int",)


def read(rec):
    return _kernels.roofline_pct(rec, "merger_int", KERNELS)
