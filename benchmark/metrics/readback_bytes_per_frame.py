"""Entry, device half, readback: bytes copied to the host in the profiled
call (`v1.readback_bytes`: numel x itemsize of what crosses), a frame."""

from benchmark.metrics import _spans


def read(rec):
    n = _spans.counter(rec, "v1.readback_bytes")
    return None if n is None else n / rec["counters"]["frames"]
