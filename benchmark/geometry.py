"""The wavefront schedule's shape, as the benchmark counts work: blocks run
along the anti-diagonals t = bx + 2 by of an nby x nbx grid (CTBs of
wavefront2, blocks of v1), one slot a block of the diagonal."""

from __future__ import annotations

import numpy as np


def schedule(nby: int, nbx: int):
    """(steps, slots a step, valid slots of each step (steps,) int)."""
    n_steps = (nbx - 1) + 2 * (nby - 1) + 1
    b_max = min(nby, (nbx + 1) // 2 + 1)
    ts = np.arange(n_steps)
    by = np.maximum(0, -((nbx - 1 - ts) // 2))[:, None] + np.arange(b_max)
    bx = ts[:, None] - 2 * by
    valid = (by < nby) & (bx >= 0) & (bx < nbx)
    return n_steps, b_max, valid.sum(axis=1)
