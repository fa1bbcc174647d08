"""Whole step: the share of the card's peak that a call reaches, the
least card time of all of its useful work (the trials, the integer
mergers and every other contraction of the PNN forwards, each at its
fastest exact route, `benchmark/roofline.py`) over the wall time of an
unprofiled call (device half and host pack)."""


def read(rec):
    least = rec["least_s"].get("all")
    wall = rec["spans"].get("call_s")
    if least is None or not wall:
        return None
    return 100.0 * least / wall
