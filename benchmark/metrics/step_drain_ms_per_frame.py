"""Step loop, the card finishing: milliseconds of the profiled call's
`v1.drain` span (the host waiting for what is still queued on the card
after the last step is issued, before the readback), a frame.  At the
cell's batch the launch queue is full through the loop, so the most of
the card's time falls in `step_issue_ms_per_frame` and this reads only
the queue's tail."""

from benchmark.metrics import _spans


def read(rec):
    return _spans.per_frame_ms(rec, "v1.drain")
