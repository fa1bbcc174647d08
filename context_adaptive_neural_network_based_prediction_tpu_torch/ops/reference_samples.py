"""Intra reference-sample availability and fill (numpy, host side).

The port's copy of the JAX package's `ops/reference_samples.py` fill rules
(HM-16.15 `TComPattern.cpp` fillReferenceSamples:325-540): a 4x4 unit is
available iff it lies inside the picture and precedes the block in coding
order; with no available unit the border is the DC value 128; a first gap
back-fills from the first valid unit and later gaps replicate the last
sample of the unit before.  `neighbor_unit_flags` gives HM's flags of
every block position at once; the wavefront encoder runs the fill once per
availability pattern at table-build time.  `FILTER_THRESHOLD` is
`m_aucIntraFilter` for luma (`TComPrediction.cpp:43-56`).
"""

from __future__ import annotations

import numpy as np

DC_FILL = 128
UNIT = 4  # availability granularity in samples
# m_aucIntraFilter (luma): threshold per size index log2(w)-2.
FILTER_THRESHOLD = {4: 10, 8: 7, 16: 1, 32: 0, 64: 10}


def neighbor_unit_flags(order4: np.ndarray, y, x, n: int, height: int,
                        width: int, unit: int = UNIT) -> np.ndarray:
    """Availability flags in HM line order of n x n blocks at (y, x).

    The port's vectorised copy of the JAX package's `neighbor_unit_flags`
    (`ops/reference_samples.py:38`): `y`, `x` are integer arrays of block
    origins and `order4` the coding order of every 4x4 unit; a unit is
    available iff it lies inside the picture and precedes the block in
    coding order.  Returns bool (*y.shape, 2 * 2n/unit + 1) in the order
    [left + below-left units bottom -> top, corner, above + above-right
    units left -> right]."""
    mine = order4[y // 4, x // 4]

    def ok(py, px):
        inside = (px >= 0) & (py >= 0) & (px < width) & (py < height)
        o = order4[np.clip(py, 0, height - 1) // 4,
                   np.clip(px, 0, width - 1) // 4]
        return inside & (o < mine)

    n_units = (2 * n) // unit
    flags = [ok(y + 2 * n - unit - j * unit, x - 1) for j in range(n_units)]
    flags.append(ok(y - 1, x - 1))
    flags += [ok(y - 1, x + j * unit) for j in range(n_units)]
    return np.stack(flags, axis=-1)


def fill_reference_samples(recon: np.ndarray, x: int, y: int, n: int,
                           flags: np.ndarray, unit: int = UNIT):
    """Builds (ref_top (2n+1,), ref_left (2n+1,)) int32 per HM fill rules.

    `recon` is the (H, W) reconstruction buffer; (x, y) the TB top-left;
    `unit` the availability granularity (4 luma, 2 chroma 4:2:0).
    """
    height, width = recon.shape
    UNIT = unit
    n_units = (2 * n) // UNIT
    total_units = 2 * n_units + 1
    num_avail = int(flags.sum())

    ref_top = np.full(2 * n + 1, DC_FILL, dtype=np.int32)
    ref_left = np.full(2 * n + 1, DC_FILL, dtype=np.int32)
    if num_avail == 0:
        return ref_top, ref_left

    # Line buffer: [left col bottom->top (2n), corner unit (4), above (2n)].
    line = np.full(2 * n + UNIT + 2 * n, DC_FILL, dtype=np.int32)
    filled = np.zeros(total_units, dtype=bool)

    def unit_samples(j):
        """(line_start, length) of unit j in line coordinates."""
        if j < n_units:                      # left units (bottom to top)
            return j * UNIT, UNIT
        if j == n_units:                     # corner unit
            return 2 * n, UNIT
        return 2 * n + UNIT + (j - n_units - 1) * UNIT, UNIT

    # Copy available samples.
    for j in range(total_units):
        if not flags[j]:
            continue
        start, length = unit_samples(j)
        if j < n_units:
            # Left column, bottom to top: line[start + i] is row
            # y + 2n - 1 - (start + i) in column x-1.
            for i in range(length):
                py = y + 2 * n - 1 - (start + i)
                line[start + i] = recon[py, x - 1] if py < height else 0
        elif j == n_units:
            line[start:start + length] = recon[y - 1, x - 1]
        else:
            px0 = x + (j - n_units - 1) * UNIT
            for i in range(length):
                px = px0 + i
                line[start + i] = recon[y - 1, px] if px < width else 0
        filled[j] = True

    # Padding: first gap back-fills from the first valid unit's first sample.
    if not flags[0]:
        nxt = 1
        while nxt < total_units and not flags[nxt]:
            nxt += 1
        ref_sample = line[unit_samples(nxt)[0]]
        j = 0
        while j < nxt:
            start, length = unit_samples(j)
            line[start:start + length] = ref_sample
            filled[j] = True
            j += 1
    # Later gaps replicate the last sample of the previous unit.
    for j in range(1, total_units):
        if not flags[j] and not filled[j]:
            start, length = unit_samples(j)
            line[start:start + length] = line[start - 1]
            filled[j] = True

    # Unpack: corner = last sample of corner unit; above row follows.
    ref_top[0] = line[2 * n + UNIT - 1]
    ref_top[1:] = line[2 * n + UNIT: 2 * n + UNIT + 2 * n]
    ref_left[0] = ref_top[0]
    # line[j] = left_col[2n - 1 - j]  ->  ref_left[1 + i] = line[2n - 1 - i].
    ref_left[1:] = line[2 * n - 1:: -1][: 2 * n]
    return ref_top, ref_left
