"""Step loop, host issue: milliseconds of the profiled call's `v1.steps`
span (the host issuing the wavefront steps' ops), a frame.  The span is
host time, and the host waits inside it whenever the card's launch queue
is full: at the cell's batch the queue fills, so this reads card time
and the split from `step_drain_ms_per_frame` follows the queue's depth,
not host against card."""

from benchmark.metrics import _spans


def read(rec):
    return _spans.per_frame_ms(rec, "v1.steps")
