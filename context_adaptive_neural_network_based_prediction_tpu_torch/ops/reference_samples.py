"""Intra reference-sample availability and fill (numpy, host side).

The port's copy of the JAX package's `ops/reference_samples.py` fill rules
(HM-16.15 `TComPattern.cpp` fillReferenceSamples:325-540): a 4x4 unit is
available iff it lies inside the picture and precedes the block in coding
order; with no available unit the border is the DC value 128; a first gap
back-fills from the first valid unit and later gaps replicate the last
sample of the unit before.  `neighbor_unit_flags` gives HM's flags of
every block position at once; the wavefront encoder runs the fill once per
availability pattern at table-build time.  `coded_unit_flags` is the
decoder's form: one block, from a grid of the 4x4 units reconstructed so
far.  `filter_reference_samples` is the [1 2 1] / strong smoothing
(`TComPattern.cpp:196-330`) and `use_filtered_for_mode` its per-mode
choice, with `FILTER_THRESHOLD` `m_aucIntraFilter` for luma
(`TComPrediction.cpp:43-56`).  `build_reference_samples` runs the whole
chain for one TB (availability, fill, filter), and `unit_grid_shape`
gives the shape of its `unit_coded` grid.
"""

from __future__ import annotations

import numpy as np

DC_FILL = 128
UNIT = 4  # availability granularity in samples
# m_aucIntraFilter (luma): threshold per size index log2(w)-2.
FILTER_THRESHOLD = {4: 10, 8: 7, 16: 1, 32: 0, 64: 10}


def unit_grid_shape(height: int, width: int):
    """(rows, columns) of the 4x4-unit availability grid of a picture (the
    JAX package's :34)."""
    return (height + UNIT - 1) // UNIT, (width + UNIT - 1) // UNIT


def neighbor_unit_flags(order4: np.ndarray, y, x, n: int, height: int,
                        width: int, unit: int = UNIT) -> np.ndarray:
    """Availability flags in HM line order of n x n blocks at (y, x).

    The encoder's vectorised form of the JAX package's
    `neighbor_unit_flags` (`ops/reference_samples.py:38`), with another
    signature: `y`, `x` are integer arrays of block origins and `order4`
    the coding order of every 4x4 unit; a unit is available iff it lies
    inside the picture and precedes the block in coding order.  The
    counterpart with the JAX function's signature (one block, a grid of
    the units coded so far) is `coded_unit_flags`.  Returns bool (*y.shape, 2 * 2n/unit + 1) in the order
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


def coded_unit_flags(unit_coded: np.ndarray, x: int, y: int, n: int,
                     height: int, width: int, unit: int = UNIT) -> np.ndarray:
    """Availability flags in HM line order for one n x n TB at (x, y), from
    `unit_coded`, the bool grid of the 4x4 units reconstructed so far (the
    JAX package's decoder form of `neighbor_unit_flags`,
    `ops/reference_samples.py:38-64`).

    Order: [below-left + left bottom..top (2n/unit units), corner, above +
    above-right left..right (2n/unit units)].
    """
    n_units = (2 * n) // unit
    flags = np.zeros(2 * n_units + 1, dtype=bool)

    def unit_ok(px: int, py: int) -> bool:
        if px < 0 or py < 0 or px >= width or py >= height:
            return False
        return bool(unit_coded[py // unit, px // unit])

    for j in range(n_units):
        flags[j] = unit_ok(x - 1, y + 2 * n - unit - j * unit)
    flags[n_units] = unit_ok(x - 1, y - 1)
    for j in range(n_units):
        flags[n_units + 1 + j] = unit_ok(x + j * unit, y - 1)
    return flags


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


def filter_reference_samples(ref_top: np.ndarray, ref_left: np.ndarray, n: int,
                             *, strong_intra_smoothing: bool = True,
                             bit_depth: int = 8):
    """[1 2 1]/4 smoothing (or bilinear strong smoothing at 32x32)."""
    corner = int(ref_top[0])
    top = ref_top[1:].astype(np.int64)
    left = ref_left[1:].astype(np.int64)

    use_strong = False
    if strong_intra_smoothing and n == 32:
        threshold = 1 << (bit_depth - 5)
        bottom_left = int(left[2 * n - 1])
        top_right = int(top[2 * n - 1])
        bilinear_left = abs((bottom_left + corner) - 2 * int(left[n - 1])) < threshold
        bilinear_above = abs((corner + top_right) - 2 * int(top[n - 1])) < threshold
        use_strong = bilinear_left and bilinear_above

    f_top = np.empty_like(ref_top)
    f_left = np.empty_like(ref_left)
    if use_strong:
        shift = int(np.log2(2 * n))
        i = np.arange(1, 2 * n)
        bottom_left = int(left[2 * n - 1])
        top_right = int(top[2 * n - 1])
        f_left[1:2 * n] = ((2 * n - i) * corner + i * bottom_left + n) >> shift
        f_left[2 * n] = bottom_left
        f_top[1:2 * n] = ((2 * n - i) * corner + i * top_right + n) >> shift
        f_top[2 * n] = top_right
        f_top[0] = f_left[0] = corner
    else:
        # Interior [1 2 1], endpoints copied; the corner filters with its two
        # neighbours (top[0] and left[0]).
        ext = np.concatenate(([left[0]], [corner], top))      # left[0], c, top...
        f_top_vals = (ext[:-2] + 2 * ext[1:-1] + ext[2:] + 2) >> 2  # filters c..top[2n-2]
        f_top[0] = f_top_vals[0]
        f_top[1:2 * n] = f_top_vals[1:2 * n]
        f_top[2 * n] = top[2 * n - 1]
        ext_l = np.concatenate(([top[0]], [corner], left))
        f_left_vals = (ext_l[:-2] + 2 * ext_l[1:-1] + ext_l[2:] + 2) >> 2
        f_left[0] = f_top[0]
        f_left[1:2 * n] = f_left_vals[1:2 * n]
        f_left[2 * n] = left[2 * n - 1]
    return f_top.astype(np.int32), f_left.astype(np.int32)


def use_filtered_for_mode(mode: int, n: int) -> bool:
    """HM filteringIntraReferenceSamples decision for luma."""
    if mode == 1:  # DC
        return False
    diff = min(abs(mode - 10), abs(mode - 26))
    return diff > FILTER_THRESHOLD[n]


def build_reference_samples(recon: np.ndarray, x: int, y: int, n: int,
                            unit_coded: np.ndarray,
                            *, strong_intra_smoothing: bool = True):
    """The whole chain for one n x n luma TB at (x, y) (the JAX package's
    :198): availability from `unit_coded` (the bool `unit_grid_shape` grid
    of the 4x4 units reconstructed so far, `coded_unit_flags`), HM's fill
    from `recon` (H, W), then the [1 2 1] or strong smoothing.

    Returns (ref_top, ref_left, ref_top_filtered, ref_left_filtered),
    (2n+1,) int32 each."""
    height, width = recon.shape
    flags = coded_unit_flags(unit_coded, x, y, n, height, width)
    ref_top, ref_left = fill_reference_samples(recon, x, y, n, flags)
    f_top, f_left = filter_reference_samples(
        ref_top, ref_left, n, strong_intra_smoothing=strong_intra_smoothing)
    return ref_top, ref_left, f_top, f_left
