"""Device: the share of the profiled call's wall time in which no device
activity (kernel, copy or set) ran, from the profiler's timeline."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
