"""HEVC in-loop deblocking filter (luma and 4:2:0 chroma, All-Intra).

The port's copy of the JAX package's `codec/deblock.py` (:103-212), HM-16.15
`TComLoopFilter.cpp` (sm_betaTable/sm_tcTable:59-67,
xEdgeFilterLuma:600-700, xPelFilterLuma:830-892, xUseStrongFiltering:
933-944) for the intra-only case: every 8x8-grid edge that coincides with
a TU/PU boundary has boundary strength 2, tc index = QP + 2
(DEFAULT_INTRA_TC_OFFSET), beta index = QP.  Vertical edges filter first
across the whole picture, then horizontal edges (on the vertically
filtered samples), as in HM.  Intra prediction uses the unfiltered
reconstruction, so the filter is a normative post-pass shared by the
encoder and the decoder.

`deblock_luma` and `deblock_chroma` run the native filters
(`native/hm_parse.cpp`, bound in `native.py`) on the host, where the JAX
package runs them; a build or call failure raises.  `deblock_luma_plain`
and `deblock_chroma_plain` are their numpy twins, for the tests.
"""

from __future__ import annotations

import numpy as np

from . import native

TC_TABLE = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11,
     13, 14, 16, 18, 20, 22, 24], dtype=np.int32)
BETA_TABLE = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8, 9, 10, 11, 12,
     13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38, 40, 42,
     44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64], dtype=np.int32)
DEFAULT_INTRA_TC_OFFSET = 2


def _filter_segment(get, put, tc, beta, bit_depth=8):
    """Filters one 4-line edge segment.  `get(i, k)` returns sample k (-4..3
    relative to the edge) of line i; `put(i, k, v)` writes it."""
    side_threshold = (beta + (beta >> 1)) >> 3
    thr_cut = tc * 10
    max_val = (1 << bit_depth) - 1

    def dp(i):
        return abs(get(i, -3) - 2 * get(i, -2) + get(i, -1))

    def dq(i):
        return abs(get(i, 0) - 2 * get(i, 1) + get(i, 2))

    dp0, dq0, dp3, dq3 = dp(0), dq(0), dp(3), dq(3)
    d0 = dp0 + dq0
    d3 = dp3 + dq3
    if d0 + d3 >= beta:
        return
    filter_p = (dp0 + dp3) < side_threshold
    filter_q = (dq0 + dq3) < side_threshold

    def strong(i, d):
        d_strong = abs(get(i, -4) - get(i, -1)) + abs(get(i, 3) - get(i, 0))
        return (d_strong < (beta >> 3) and d < (beta >> 2)
                and abs(get(i, -1) - get(i, 0)) < ((tc * 5 + 1) >> 1))

    sw = strong(0, 2 * d0) and strong(3, 2 * d3)
    for i in range(4):
        m0, m1, m2, m3 = get(i, -4), get(i, -3), get(i, -2), get(i, -1)
        m4, m5, m6, m7 = get(i, 0), get(i, 1), get(i, 2), get(i, 3)
        if sw:
            put(i, -1, np.clip((m1 + 2 * m2 + 2 * m3 + 2 * m4 + m5 + 4) >> 3,
                               m3 - 2 * tc, m3 + 2 * tc))
            put(i, 0, np.clip((m2 + 2 * m3 + 2 * m4 + 2 * m5 + m6 + 4) >> 3,
                              m4 - 2 * tc, m4 + 2 * tc))
            put(i, -2, np.clip((m1 + m2 + m3 + m4 + 2) >> 2,
                               m2 - 2 * tc, m2 + 2 * tc))
            put(i, 1, np.clip((m3 + m4 + m5 + m6 + 2) >> 2,
                              m5 - 2 * tc, m5 + 2 * tc))
            put(i, -3, np.clip((2 * m0 + 3 * m1 + m2 + m3 + m4 + 4) >> 3,
                               m1 - 2 * tc, m1 + 2 * tc))
            put(i, 2, np.clip((m3 + m4 + m5 + 3 * m6 + 2 * m7 + 4) >> 3,
                              m6 - 2 * tc, m6 + 2 * tc))
        else:
            delta = (9 * (m4 - m3) - 3 * (m5 - m2) + 8) >> 4
            if abs(delta) < thr_cut:
                delta = int(np.clip(delta, -tc, tc))
                put(i, -1, np.clip(m3 + delta, 0, max_val))
                put(i, 0, np.clip(m4 - delta, 0, max_val))
                tc2 = tc >> 1
                if filter_p:
                    d1 = int(np.clip((((m1 + m3 + 1) >> 1) - m2 + delta) >> 1,
                                     -tc2, tc2))
                    put(i, -2, np.clip(m2 + d1, 0, max_val))
                if filter_q:
                    d2 = int(np.clip((((m6 + m4 + 1) >> 1) - m5 - delta) >> 1,
                                     -tc2, tc2))
                    put(i, 1, np.clip(m5 + d2, 0, max_val))


def deblock_luma(recon: np.ndarray, tu_map: np.ndarray,
                 qp: int) -> np.ndarray:
    """Deblocks a reconstructed 8-bit luma picture (returns a new array).

    `tu_map` is a per-4x4-unit int array where distinct values mark
    distinct TUs/PUs (edges between differing ids on the 8-grid get
    BS = 2)."""
    return native.deblock_luma(recon, tu_map, qp)


def deblock_luma_plain(recon: np.ndarray, tu_map: np.ndarray, qp: int,
                       bit_depth: int = 8) -> np.ndarray:
    """`deblock_luma` in numpy, a segment at a time."""
    h, w = recon.shape
    out = recon.astype(np.int32).copy()
    idx_tc = int(np.clip(qp + DEFAULT_INTRA_TC_OFFSET, 0, 53))
    idx_b = int(np.clip(qp, 0, 51))
    tc = int(TC_TABLE[idx_tc])
    beta = int(BETA_TABLE[idx_b])
    if beta == 0:
        return recon.copy()

    # --- vertical edges (filter across columns), whole picture first ---
    for x in range(8, w, 8):
        ux = x // 4
        for y0 in range(0, h, 4):
            uy = y0 // 4
            if tu_map[uy, ux - 1] == tu_map[uy, ux]:
                continue  # not a TU/PU boundary: BS 0

            def get(i, k, y0=y0, x=x):
                return int(out[y0 + i, x + k])

            def put(i, k, v, y0=y0, x=x):
                out[y0 + i, x + k] = int(v)

            _filter_segment(get, put, tc, beta, bit_depth)

    # --- horizontal edges ---
    for y in range(8, h, 8):
        uy = y // 4
        for x0 in range(0, w, 4):
            ux = x0 // 4
            if tu_map[uy - 1, ux] == tu_map[uy, ux]:
                continue

            def get(i, k, y=y, x0=x0):
                return int(out[y + k, x0 + i])

            def put(i, k, v, y=y, x0=x0):
                out[y + k, x0 + i] = int(v)

            _filter_segment(get, put, tc, beta, bit_depth)

    return np.clip(out, 0, (1 << bit_depth) - 1).astype(recon.dtype)


def deblock_chroma(plane: np.ndarray, tu_map_luma: np.ndarray,
                   qp_c: int) -> np.ndarray:
    """Deblocks one 8-bit 4:2:0 chroma plane (HM `xEdgeFilterChroma` +
    `xPelFilterChroma`, All-Intra): a new array.  `tu_map_luma` is the
    luma-resolution 4x4-unit TU id map."""
    return native.deblock_chroma(plane, tu_map_luma, qp_c)


def deblock_chroma_plain(plane: np.ndarray, tu_map_luma: np.ndarray,
                         qp_c: int, bit_depth: int = 8) -> np.ndarray:
    """`deblock_chroma` in numpy (JAX package :159-212).  Chroma edges lie
    on the 8-chroma-sample grid; every intra TU/PU boundary has BS 2 and
    filters in 2-sample segments, adjusting p0 / q0 only, with tc from the
    chroma QP plus the intra offset."""
    hc, wc = plane.shape
    out = plane.astype(np.int32).copy()
    tc = int(TC_TABLE[int(np.clip(qp_c + DEFAULT_INTRA_TC_OFFSET, 0, 53))])
    if tc == 0:
        return plane.copy()
    max_val = (1 << bit_depth) - 1

    def filter_pair(p1, p0, q0, q1):
        delta = max(-tc, min(tc, (((q0 - p0) << 2) + p1 - q1 + 4) >> 3))
        return (max(0, min(max_val, p0 + delta)),
                max(0, min(max_val, q0 - delta)))

    for xc in range(8, wc, 8):
        ux = (2 * xc) // 4
        for y0 in range(0, hc, 2):
            uy = (2 * y0) // 4
            if tu_map_luma[uy, ux - 1] == tu_map_luma[uy, ux]:
                continue
            for i in range(2):
                r = out[y0 + i]
                r[xc - 1], r[xc] = filter_pair(int(r[xc - 2]), int(r[xc - 1]),
                                               int(r[xc]), int(r[xc + 1]))
    for yc in range(8, hc, 8):
        uy = (2 * yc) // 4
        for x0 in range(0, wc, 2):
            ux = (2 * x0) // 4
            if tu_map_luma[uy - 1, ux] == tu_map_luma[uy, ux]:
                continue
            for i in range(2):
                c = out[:, x0 + i]
                c[yc - 1], c[yc] = filter_pair(int(c[yc - 2]), int(c[yc - 1]),
                                               int(c[yc]), int(c[yc + 1]))
    return np.clip(out, 0, max_val).astype(plane.dtype)
