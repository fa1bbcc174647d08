"""HEVC intra prediction: the angular tables (HM-16.15 `TComPrediction.cpp`)
and the 35 modes of a batch of blocks in plain PyTorch.

A frozen copy of the port's `ops/intra.py` as the benchmark's plain
reference uses it (only the parts it needs; nothing of the port is
imported).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


PLANAR_IDX = 0


DC_IDX = 1


HOR_IDX = 10


VER_IDX = 26


NB_MODES = 35


# HM: MAXIMUM_INTRA_FILTERED_{WIDTH,HEIGHT} = 16.
MAX_INTRA_FILTERED = 16


# HM-16.15 angular tables (TComPrediction.cpp); index = |angle mode|.
ANG_TABLE = (0, 2, 5, 9, 13, 17, 21, 26, 32)


INV_ANG_TABLE = (0, 4096, 1638, 910, 630, 482, 390, 315, 256)


def _mode_angle(mode: int) -> int:
    """intraPredAngle for an angular mode (2..34, excluding DC/planar)."""
    is_ver = mode >= 18
    ang_mode = mode - VER_IDX if is_ver else -(mode - HOR_IDX)
    return (1 if ang_mode >= 0 else -1) * ANG_TABLE[abs(ang_mode)]


def _mode_inv_angle(mode: int) -> int:
    is_ver = mode >= 18
    ang_mode = mode - VER_IDX if is_ver else -(mode - HOR_IDX)
    return INV_ANG_TABLE[abs(ang_mode)]


@functools.lru_cache(maxsize=None)
def _angular_tables(width: int):
    """Static gather/weight tables for the 33 angular modes at a given width.

    Returns (g0, g1, frac, modes) with shapes (33, w, w) int32; g0/g1 index the
    combined reference vector comb = concat(ref_top(2w+1), ref_left(2w+1)).
    """
    w = width
    n_ext = 4 * w + 2  # length of comb
    TOP = 0            # comb[TOP + i]  == ref_top[i]
    LEFT = 2 * w + 1   # comb[LEFT + i] == ref_left[i]
    modes = list(range(2, NB_MODES))  # 2..34 inclusive (33 modes; DC/planar separate)

    g0 = np.zeros((len(modes), w, w), dtype=np.int32)
    g1 = np.zeros_like(g0)
    frac = np.zeros_like(g0)

    for mi, mode in enumerate(modes):
        is_ver = mode >= 18
        angle = _mode_angle(mode)
        inv_angle = _mode_inv_angle(mode)
        main = TOP if is_ver else LEFT
        side = LEFT if is_ver else TOP

        # refMain[k] as an index into comb, for k in [-w .. 2w].
        ref_main_idx = np.zeros(3 * w + 1, dtype=np.int64)  # slot j holds k = j - w
        for k in range(0, 2 * w + 1):
            ref_main_idx[k + w] = main + k
        if angle < 0:
            # HM projects side references onto the negative main axis:
            # refMain[-j] = refSide[(128 + j*invAngle) >> 8].
            for j in range(1, w + 1):
                ref_main_idx[w - j] = side + ((128 + j * inv_angle) >> 8)

        for y in range(w):
            for x in range(w):
                # Horizontal modes are the transpose of the vertical computation.
                yy, xx = (y, x) if is_ver else (x, y)
                delta_pos = (yy + 1) * angle
                delta_int = delta_pos >> 5
                f = delta_pos & 31
                k0 = xx + delta_int + 1
                k1 = min(k0 + 1, 2 * w)  # clamp; weight is 0 when f == 0 at the edge
                g0[mi, y, x] = ref_main_idx[k0 + w]
                g1[mi, y, x] = ref_main_idx[k1 + w]
                frac[mi, y, x] = f
    assert g0.max() < n_ext and g0.min() >= 0
    return g0, g1, frac, tuple(modes)


@functools.lru_cache(maxsize=None)
def _tables_on(width: int, device: str):
    g0, g1, frac, _ = _angular_tables(width)
    return tuple(torch.from_numpy(a).to(device) for a in
                 (g0.astype(np.int64), g1.astype(np.int64), frac))


def predict_all_modes(ref_top, ref_left, *, filtered_edges: bool = True):
    """All 35 HEVC intra modes of a batch of square blocks.

    ref_top, ref_left: (N, 2w+1) integer tensors (module convention), on
    the device that computes.  `filtered_edges` applies HM's luma DC
    filtering and H/V edge filters (w <= 16).  Returns (N, 35, w, w) int32
    in [0, 255]; index m is HM mode m (0 planar, 1 DC, 2-34 angular)."""
    w = (ref_top.shape[1] - 1) // 2
    if tuple(ref_top.shape) != tuple(ref_left.shape) \
            or ref_top.shape[1] != 2 * w + 1:
        raise ValueError("ref_top/ref_left must be (N, 2w+1).")
    ref_top = ref_top.to(torch.int32)
    ref_left = ref_left.to(torch.int32)
    n = ref_top.shape[0]
    s = int(np.log2(w))
    g0, g1, f = _tables_on(w, str(ref_top.device))
    comb = torch.cat([ref_top, ref_left], dim=1)              # (N, 4w+2)
    ang = ((32 - f) * comb[:, g0] + f * comb[:, g1] + 16) >> 5  # (N, 33, w, w)
    filt = filtered_edges and w <= MAX_INTRA_FILTERED
    if filt:
        # Mode 26: first column += (left[y] - corner) >> 1; mode 10: first
        # row += (top[x] - corner) >> 1; both clipped to [0, 255].
        col_adj = (ref_left[:, 1:w + 1] - ref_left[:, 0:1]) >> 1
        ang[:, VER_IDX - 2, :, 0] = torch.clamp(
            ang[:, VER_IDX - 2, :, 0] + col_adj, 0, 255)
        row_adj = (ref_top[:, 1:w + 1] - ref_top[:, 0:1]) >> 1
        ang[:, HOR_IDX - 2, 0, :] = torch.clamp(
            ang[:, HOR_IDX - 2, 0, :] + row_adj, 0, 255)

    top_w = ref_top[:, 1:w + 1]
    left_w = ref_left[:, 1:w + 1]
    dc = ((top_w.sum(1) + left_w.sum(1) + w) // (2 * w)).to(torch.int32)
    dc_blk = dc[:, None, None].expand(n, w, w).clone()
    if filt:
        dc_blk[:, 0, :] = (top_w + 3 * dc[:, None] + 2) >> 2
        dc_blk[:, :, 0] = (left_w + 3 * dc[:, None] + 2) >> 2
        dc_blk[:, 0, 0] = (top_w[:, 0] + left_w[:, 0] + 2 * dc + 2) >> 2

    t = top_w[:, None, :]
    lft = left_w[:, :, None]
    tr = ref_top[:, w + 1][:, None, None]
    bl = ref_left[:, w + 1][:, None, None]
    xs = torch.arange(w, dtype=torch.int32, device=ref_top.device)
    hor = (lft << s) + w + (xs[None, None, :] + 1) * (tr - lft)
    ver = (t << s) + (xs[None, :, None] + 1) * (bl - t)
    planar = (hor + ver) >> (s + 1)
    return torch.cat([planar[:, None], dc_blk[:, None], ang],
                     dim=1).to(torch.int32)

