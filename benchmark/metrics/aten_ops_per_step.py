"""Step loop: aten ops one timed call dispatches (views included; an exact
count by a TorchDispatchMode), over the wavefront steps of the call."""


def read(rec):
    c = rec["counters"]
    if "aten_ops" not in c or not c.get("steps"):
        return None
    return c["aten_ops"] / c["steps"]
