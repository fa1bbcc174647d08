"""Entry, device half, readback: milliseconds of the profiled call's
`v1.readback` span (the decided reconstructions, modes and levels copied
to the host after the drain), a frame."""

from benchmark.metrics import _spans


def read(rec):
    return _spans.per_frame_ms(rec, "v1.readback")
