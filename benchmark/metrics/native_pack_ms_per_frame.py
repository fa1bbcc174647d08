"""Host half, native CABAC: milliseconds of the profiled call's
`pack.native` spans (the native packer's call alone, without the Python
glue around it in `pack.grid`), a frame."""

from benchmark.metrics import _spans


def read(rec):
    return _spans.per_frame_ms(rec, "pack.native")
