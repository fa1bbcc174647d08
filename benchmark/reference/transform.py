"""HEVC integer transform matrices and quantiser scales (numpy).

A frozen copy of the port's `ops/transform.py` as the benchmark's plain
reference uses it (only the parts it needs; nothing of the port is
imported).
"""

from __future__ import annotations

import functools

import numpy as np


BIT_DEPTH = 8


MAX_TR_DYNAMIC_RANGE = 15


QUANT_SHIFT = 14


IQUANT_SHIFT = 6


TRANSFORM_MATRIX_SHIFT = 6


QUANT_SCALES = (26214, 23302, 20560, 18396, 16384, 14564)


INV_QUANT_SCALES = (40, 45, 51, 57, 64, 72)


# Forward-transform matrix shift of the high-precision matrices
# (HM TComRom.h g_transformMatrixShift[TRANSFORM_FORWARD] under
# RExt__HIGH_BIT_DEPTH_SUPPORT; the inverse stays at 6).
FWD_MATRIX_SHIFT = 14


# Hand-tuned odd-row constants of the HEVC spec integer DCT, per size.
_ODD_CONSTS = {
    4: (83, 36),
    8: (89, 75, 50, 18),
    16: (90, 87, 80, 70, 57, 43, 25, 9),
    32: (90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4),
}


# 14-bit high-precision forward-transform constants (TComRom.cpp:441-462).
_ODD_CONSTS_HP = {
    4: (21266, 9224),
    8: (22813, 19244, 12769, 4563),
    16: (23120, 22063, 20450, 17972, 14642, 11109, 6446, 2316),
    32: (23106, 22852, 22445, 21848, 20995, 19810, 18601, 17143,
         15718, 13853, 11749, 9846, 7908, 5573, 3281, 946),
}


# HEVC DST-VII 4x4 (luma intra 4x4 TUs), 6-bit (inverse/normative) and the
# 14-bit forward pair (g_as_DST_MAT_4, TComRom.cpp:464-468).
DST4 = np.array([
    [29, 55, 74, 84],
    [74, 74, 0, -74],
    [84, -29, -74, 55],
    [55, -84, 74, -29],
], dtype=np.int32)


DST4_FWD = np.array([
    [7424, 14081, 18893, 21505],
    [18893, 18893, 0, -18893],
    [21505, -7424, -18893, 14081],
    [14081, -21505, 18893, -7424],
], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int, high_precision: bool = False) -> np.ndarray:
    """The HEVC integer DCT-II matrix of size n (4, 8, 16 or 32)."""
    if n == 2:
        base = 16384 if high_precision else 64
        return np.array([[base, base], [base, -base]], dtype=np.int64)
    half = dct_matrix(n // 2, high_precision)
    t = np.zeros((n, n), dtype=np.int64)
    # Even rows: half-size rows mirrored (T[2m][N-1-n] = T[2m][n]).
    for m in range(n // 2):
        t[2 * m, : n // 2] = half[m]
        t[2 * m, n // 2:] = half[m][::-1]
    # Odd rows: cosine phase folding over the odd-constant list.
    odd = (_ODD_CONSTS_HP if high_precision else _ODD_CONSTS)[n]
    for k in range(1, n, 2):
        for col in range(n):
            p = (k * (2 * col + 1)) % (4 * n)
            q = min(p, 4 * n - p)          # fold to [0, 2n]
            if q <= n:
                t[k, col] = odd[(q - 1) // 2]
            else:
                t[k, col] = -odd[(2 * n - q - 1) // 2]
    return t


def transform_shift(log2_n: int, bit_depth: int = BIT_DEPTH) -> int:
    return MAX_TR_DYNAMIC_RANGE - bit_depth - log2_n

