"""HEVC intra prediction: the angular tables (numpy) and the 35 modes of
a batch of blocks (PyTorch, on the blocks' device).

The port's copy of `_angular_tables` of the JAX package's `ops/intra.py`
(HM-16.15 `TComPrediction.cpp` angle and inverse-angle tables): for every
angular mode 2..34 and pixel, the two reference indices and the 1/32
fraction of the interpolation.  The fused unit trial predicts from them.

`predict_all_modes` (JAX package :265, body `_jitted_predict` :109-169)
predicts all 35 modes of N blocks from their references with one gather
and exact int32 arithmetic, bit for bit the JAX package's;
`predict_best_mode` (:323) keeps the max-PSNR mode of each block.
`predict_one_mode_np` (:217) predicts one mode of one block in numpy, the
decoders' per-TU form, and `predict_all_modes_np` (:172) all 35 of N
blocks in numpy, the host RDO encoder's per-PU sweep.
`pad_intra_pattern` (:286) and `predict_via_hevc_mode` (:310) are the
reference simulator's single-block, single-mode prediction from a partial
L-pattern.
Reference layout: ref_top[n] = [corner, top_0, ..., top_{2w-1}] and
ref_left[n] = [corner, left_0, ..., left_{2w-1}] (length 2w + 1 each).
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


def predict_all_modes_np(ref_top, ref_left, *,
                         filtered_edges: bool = True) -> np.ndarray:
    """All 35 modes of N blocks in numpy (JAX package :172): the host RDO
    encoder's per-PU sweep, the same integer semantics as
    `predict_all_modes`.  ref_top/ref_left (N, 2w+1) -> (N, 35, w, w)
    int32."""
    ref_top = np.asarray(ref_top, dtype=np.int32)
    ref_left = np.asarray(ref_left, dtype=np.int32)
    w = (ref_top.shape[1] - 1) // 2
    n = ref_top.shape[0]
    s = int(np.log2(w))
    g0, g1, frac, _ = _angular_tables(w)
    comb = np.concatenate([ref_top, ref_left], axis=1)
    ang = ((32 - frac) * comb[:, g0] + frac * comb[:, g1] + 16) >> 5

    if filtered_edges and w <= MAX_INTRA_FILTERED:
        col_adj = (ref_left[:, 1:w + 1] - ref_left[:, 0:1]) >> 1
        ang[:, VER_IDX - 2, :, 0] = np.clip(
            ang[:, VER_IDX - 2, :, 0] + col_adj, 0, 255)
        row_adj = (ref_top[:, 1:w + 1] - ref_top[:, 0:1]) >> 1
        ang[:, HOR_IDX - 2, 0, :] = np.clip(
            ang[:, HOR_IDX - 2, 0, :] + row_adj, 0, 255)

    top_w = ref_top[:, 1:w + 1]
    left_w = ref_left[:, 1:w + 1]
    dc = (np.sum(top_w, axis=1) + np.sum(left_w, axis=1) + w) // (2 * w)
    dc_blk = np.broadcast_to(dc[:, None, None], (n, w, w)).copy()
    if filtered_edges and w <= MAX_INTRA_FILTERED:
        dc_blk[:, 0, :] = (top_w + 3 * dc[:, None] + 2) >> 2
        dc_blk[:, 1:, 0] = (left_w[:, 1:] + 3 * dc[:, None] + 2) >> 2
        dc_blk[:, 0, 0] = (top_w[:, 0] + left_w[:, 0] + 2 * dc + 2) >> 2

    T = top_w[:, None, :]
    L = left_w[:, :, None]
    TR = ref_top[:, w + 1][:, None, None]
    BL = ref_left[:, w + 1][:, None, None]
    xs = np.arange(w)[None, None, :]
    ys = np.arange(w)[None, :, None]
    planar = (((L << s) + w + (xs + 1) * (TR - L))
              + ((T << s) + (ys + 1) * (BL - T))) >> (s + 1)
    return np.concatenate([planar[:, None], dc_blk[:, None], ang],
                          axis=1).astype(np.int32)


def predict_one_mode_np(ref_top: np.ndarray, ref_left: np.ndarray, mode: int,
                        *, filtered_edges: bool = True) -> np.ndarray:
    """Single-block single-mode prediction (numpy), same semantics as the
    batched kernel but ~35x cheaper for the codec's per-TU reconstructions.

    ref_top/ref_left are (2w+1,) int arrays; returns (w, w) int32.
    """
    ref_top = np.asarray(ref_top, dtype=np.int32)
    ref_left = np.asarray(ref_left, dtype=np.int32)
    w = (ref_top.shape[0] - 1) // 2
    top_w = ref_top[1:w + 1]
    left_w = ref_left[1:w + 1]
    filt = filtered_edges and w <= MAX_INTRA_FILTERED

    if mode == PLANAR_IDX:
        s = int(np.log2(w))
        T = top_w[None, :]
        L = left_w[:, None]
        TR = int(ref_top[w + 1])
        BL = int(ref_left[w + 1])
        xs = np.arange(w)[None, :]
        ys = np.arange(w)[:, None]
        return (((L << s) + w + (xs + 1) * (TR - L))
                + ((T << s) + (ys + 1) * (BL - T))) >> (s + 1)

    if mode == DC_IDX:
        dc = (int(top_w.sum()) + int(left_w.sum()) + w) // (2 * w)
        blk = np.full((w, w), dc, np.int32)
        if filt:
            blk[0, :] = (top_w + 3 * dc + 2) >> 2
            blk[1:, 0] = (left_w[1:] + 3 * dc + 2) >> 2
            blk[0, 0] = (int(top_w[0]) + int(left_w[0]) + 2 * dc + 2) >> 2
        return blk

    g0, g1, frac, _ = _angular_tables(w)
    mi = mode - 2
    comb = np.concatenate([ref_top, ref_left])
    r0 = comb[g0[mi]]
    r1 = comb[g1[mi]]
    f = frac[mi]
    blk = ((32 - f) * r0 + f * r1 + 16) >> 5
    if filt and mode == VER_IDX:
        blk[:, 0] = np.clip(blk[:, 0] + ((left_w - ref_left[0]) >> 1), 0, 255)
    elif filt and mode == HOR_IDX:
        blk[0, :] = np.clip(blk[0, :] + ((top_w - ref_top[0]) >> 1), 0, 255)
    return blk.astype(np.int32)


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


def pad_intra_pattern(intra_pattern_uint8: np.ndarray, size_block: int):
    """Expands a partial L-pattern to full (ref_top, ref_left) (2w+1,)
    int32 numpy arrays by edge replication (the JAX package's :286;
    `extracted_hevc_intraprediction.cpp:30-84`).

    `intra_pattern_uint8` is (h_ip, w_ip, 1) or (h_ip, w_ip), the L stored
    as in the reference simulator: row 0 the above references (corner
    first), column 0 the left ones, with h_ip and w_ip in [w+1, 2w+1].  The
    last pixel of each arm replicates outward to length 2w+1."""
    w = size_block
    h_ip, w_ip = intra_pattern_uint8.shape[:2]
    if not (w + 1 <= h_ip <= 2 * w + 1) or not (w + 1 <= w_ip <= 2 * w + 1):
        raise ValueError("intra pattern dims must lie in [w+1, 2w+1].")
    pat = intra_pattern_uint8[..., 0] if intra_pattern_uint8.ndim == 3 \
        else intra_pattern_uint8
    ref_top = np.full(2 * w + 1, pat[0, w_ip - 1], dtype=np.int32)
    ref_top[:w_ip] = pat[0, :]
    ref_left = np.full(2 * w + 1, pat[h_ip - 1, 0], dtype=np.int32)
    ref_left[:h_ip] = pat[:, 0]
    return ref_top, ref_left


def predict_via_hevc_mode(intra_pattern_uint8: np.ndarray, width_target: int,
                          mode: int, device="cuda") -> np.ndarray:
    """Single-block, single-mode prediction from a partial L-pattern (the
    JAX package's :310, reference `interface.pyx` parity): the pattern is
    padded (`pad_intra_pattern`) and predicted by `predict_all_modes` on
    `device`.  Returns a (w, w, 1) uint8 numpy block."""
    if mode < 0 or mode > 34:
        raise ValueError("mode must be in [0, 34].")
    ref_top, ref_left = pad_intra_pattern(intra_pattern_uint8, width_target)
    dev = torch.device(device)
    preds = predict_all_modes(torch.from_numpy(ref_top[None]).to(dev),
                              torch.from_numpy(ref_left[None]).to(dev))
    return preds[0, mode].cpu().numpy().astype(np.uint8)[..., None]


def predict_best_mode(ref_top, ref_left, targets):
    """Sweeps all 35 modes and keeps the max-PSNR mode of each block; ties
    go to the lowest mode.  targets (N, w, w) integer tensor on the
    references' device.  Returns (best predictions (N, w, w) int32, best
    modes (N,) int64, their PSNRs (N,) float32).

    PSNR = 10 log10(255^2 / (MSE + 1e-6)) in float32, as the JAX package
    computes it; the MSE's sum of squared errors is exact (int64) and then
    divided in float32.  The JAX package sums in float32, which is exact
    below 2^24 (every w <= 16); at w = 32 its sum can round, and a
    near-tied mode can differ."""
    preds = predict_all_modes(ref_top, ref_left)          # (N, 35, w, w)
    n, _, w, _ = preds.shape
    err = preds - targets.to(torch.int32)[:, None]
    sse = (err * err).to(torch.int64).sum(dim=(2, 3)).to(torch.float32)
    mse = sse / torch.full_like(sse, float(w * w))
    psnr = 10.0 * torch.log10(torch.full_like(mse, 255.0 ** 2)
                              / (mse + 1.0e-6))
    best = torch.argmax(psnr, dim=1)
    rows = torch.arange(n, device=preds.device)
    return preds[rows, best], best, psnr[rows, best]
