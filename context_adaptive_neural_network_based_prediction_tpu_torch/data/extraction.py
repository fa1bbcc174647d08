"""Context/target extraction from image channels (numpy, on the host).

The port's copy of the JAX package's `data/extraction.py` (`_check_channel`
:26, `extract_context_portions_target_from_channel` :34,
`extract_context_portions_targets_from_channel` :53,
`extract_context_portions_targets_from_channels` :88).  A target block
of width w is predicted from an L-shaped causal context: an above portion
(w x 3w) and a left portion (2w x w).  With (row_1st, col_1st) the top-left
pixel of the above portion:

    above  = channel[row_1st     : row_1st + w,  col_1st     : col_1st + 3w]
    left   = channel[row_1st + w : row_1st + 3w, col_1st     : col_1st + w]
    target = channel[row_1st + w : row_1st + 2w, col_1st + w : col_1st + 2w]

"pair" channels carry a second plane (the same image with HEVC
compression artifacts); contexts are then read from it while the target
stays clean.
"""

from __future__ import annotations

import numpy as np


def _check_channel(channel: np.ndarray) -> int:
    if channel.dtype != np.uint8:
        raise TypeError("channel dtype is not uint8.")
    if channel.ndim != 3 or channel.shape[2] not in (1, 2):
        raise ValueError("channel must be (H, W, 1) or (H, W, 2).")
    return channel.shape[2] - 1  # context plane index


def extract_context_portions_target_from_channel(
        channel_single_or_pair_uint8: np.ndarray, width_target: int,
        row_1st: int, col_1st: int):
    """Extracts one (above, left, target) triplet (views of the channel):
    above (w, 3w, 1), left (2w, w, 1), target (w, w, 1)."""
    ctx_plane = _check_channel(channel_single_or_pair_uint8)
    h, w_ch = channel_single_or_pair_uint8.shape[:2]
    w = width_target
    if w < 0 or row_1st < 0 or col_1st < 0:
        raise ValueError("negative geometry.")
    if row_1st + 3 * w > h or col_1st + 3 * w > w_ch:
        raise ValueError("extraction exceeds channel bounds.")
    ch = channel_single_or_pair_uint8
    above = ch[row_1st:row_1st + w, col_1st:col_1st + 3 * w,
               ctx_plane:ctx_plane + 1]
    left = ch[row_1st + w:row_1st + 3 * w, col_1st:col_1st + w,
              ctx_plane:ctx_plane + 1]
    target = ch[row_1st + w:row_1st + 2 * w, col_1st + w:col_1st + 2 * w,
                0:1]
    return above, left, target


def extract_context_portions_targets_from_channel(
        channel_single_or_pair_uint8: np.ndarray, width_target: int,
        row_1sts: np.ndarray, col_1sts: np.ndarray):
    """Vectorized batched extraction at N positions from one channel.

    Returns (above (N, w, 3w, 1), left (N, 2w, w, 1), target (N, w, w, 1))
    uint8."""
    ctx_plane = _check_channel(channel_single_or_pair_uint8)
    row_1sts = np.asarray(row_1sts)
    col_1sts = np.asarray(col_1sts)
    if not np.issubdtype(row_1sts.dtype, np.integer) \
            or not np.issubdtype(col_1sts.dtype, np.integer):
        raise TypeError("positions must be integer arrays.")
    if row_1sts.shape != col_1sts.shape or row_1sts.ndim != 1:
        raise ValueError("row/col position arrays must be identical 1D "
                         "shapes.")
    h, w_ch = channel_single_or_pair_uint8.shape[:2]
    w = width_target
    if np.any(row_1sts < 0) or np.any(col_1sts < 0) or \
       np.any(row_1sts + 3 * w > h) or np.any(col_1sts + 3 * w > w_ch):
        raise ValueError("extraction exceeds channel bounds.")

    ch_ctx = channel_single_or_pair_uint8[:, :, ctx_plane]
    ch_clean = channel_single_or_pair_uint8[:, :, 0]
    r = row_1sts[:, None, None]
    c = col_1sts[:, None, None]
    ar = np.arange(w)[None, :, None]
    ac3 = np.arange(3 * w)[None, None, :]
    above = ch_ctx[r + ar, c + ac3][..., None]
    ar2 = np.arange(2 * w)[None, :, None]
    ac = np.arange(w)[None, None, :]
    left = ch_ctx[r + w + ar2, c + ac][..., None]
    target = ch_clean[r + w + ar, c + w + ac][..., None]
    return above, left, target


def extract_context_portions_targets_from_channels(
        channels_single_or_pair_uint8: np.ndarray, width_target: int,
        row_1sts: np.ndarray, col_1sts: np.ndarray):
    """Batched extraction at the same or per-image positions from N
    channels (N, H, W, 1|2): positions (N, P) per image or (P,) shared.
    Returns the stacked uint8 triplets with leading dim N * P."""
    chans = channels_single_or_pair_uint8
    if chans.ndim != 4:
        raise ValueError("channels must be 4D (N, H, W, C).")
    row_1sts = np.asarray(row_1sts)
    col_1sts = np.asarray(col_1sts)
    if row_1sts.ndim == 1:
        row_1sts = np.broadcast_to(row_1sts, (chans.shape[0], row_1sts.size))
        col_1sts = np.broadcast_to(col_1sts, (chans.shape[0], col_1sts.size))
    parts = [extract_context_portions_targets_from_channel(
        chans[i], width_target, row_1sts[i], col_1sts[i])
        for i in range(chans.shape[0])]
    return tuple(np.concatenate([p[k] for p in parts], axis=0)
                 for k in range(3))
