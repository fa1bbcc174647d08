"""HEVC coefficient scan orders (HM `g_scanOrder`, spec 6.5.3).

A frozen copy of the port's `codec/scans.py` as the benchmark's plain
reference uses it (only the parts it needs; nothing of the port is
imported).
"""

from __future__ import annotations

import functools

import numpy as np


SCAN_DIAG, SCAN_HOR, SCAN_VER = 0, 1, 2


MDCS_ANGLE_LIMIT = 4        # TComRom.h; scan swaps within +-4 of HOR/VER


MDCS_MAXIMUM_WIDTH = 8      # mode-dependent scan only for luma TUs <= 8x8


# g_uiGroupIdx / g_uiMinInGroup for last-position coding.
GROUP_IDX = np.array([0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7,
                      8, 8, 8, 8, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9, 9, 9], dtype=np.int32)


MIN_IN_GROUP = np.array([0, 1, 2, 3, 4, 6, 8, 12, 16, 24], dtype=np.int32)


def _pattern(n_cols: int, n_rows: int, scan_type: int):
    """(x, y) visit order over an n_cols x n_rows grid."""
    order = []
    if scan_type == SCAN_DIAG:
        for d in range(n_cols + n_rows - 1):
            # Up-right diagonal: start at x=0 (bottom of the diagonal).
            for x in range(0, d + 1):
                y = d - x
                if x < n_cols and y < n_rows:
                    order.append((x, y))
    elif scan_type == SCAN_HOR:
        for y in range(n_rows):
            for x in range(n_cols):
                order.append((x, y))
    else:  # SCAN_VER
        for x in range(n_cols):
            for y in range(n_rows):
                order.append((x, y))
    return order


@functools.lru_cache(maxsize=None)
def scan_order(width: int, height: int, scan_type: int) -> np.ndarray:
    """Grouped scan: scanPos -> raster position, int32 array of width*height."""
    if width <= 4 and height <= 4:
        return np.array([x + y * width for x, y in _pattern(width, height, scan_type)],
                        dtype=np.int32)
    cg_cols, cg_rows = width // 4, height // 4
    out = []
    inner = _pattern(4, 4, scan_type)
    for cgx, cgy in _pattern(cg_cols, cg_rows, scan_type):
        for x, y in inner:
            out.append((cgx * 4 + x) + (cgy * 4 + y) * width)
    return np.array(out, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def cg_scan_order(width: int, height: int, scan_type: int) -> np.ndarray:
    """Ungrouped scan over the coefficient-group grid: scanPos -> CG raster."""
    cg_cols, cg_rows = max(width // 4, 1), max(height // 4, 1)
    return np.array([x + y * cg_cols for x, y in _pattern(cg_cols, cg_rows, scan_type)],
                    dtype=np.int32)


def select_scan(mode: int, n: int, is_intra: bool = True) -> int:
    """Mode-dependent coefficient scan (TComDataCU::getCoefScanIdx, luma)."""
    if not is_intra or n > MDCS_MAXIMUM_WIDTH:
        return SCAN_DIAG
    if abs(mode - 26) <= MDCS_ANGLE_LIMIT:
        return SCAN_HOR
    if abs(mode - 10) <= MDCS_ANGLE_LIMIT:
        return SCAN_VER
    return SCAN_DIAG

