"""HEVC syntax: context indices, MPM derivation and the encoders of the
luma intra mode and of one TU's coefficients (HM `TEncSbac`).

A frozen copy of the port's `codec/syntax.py` as the benchmark's plain
reference uses it (only the parts it needs; nothing of the port is
imported).
"""

from __future__ import annotations

import functools

import numpy as np

from . import cabac, scans
from .contexts import OFFSETS


PLANAR_IDX, DC_IDX, HOR_IDX, VER_IDX = 0, 1, 10, 26


C1FLAG_NUMBER = 8


SBH_THRESHOLD = 4


COEF_REMAIN_BIN_REDUCTION = 3


CTX_IND_MAP_4X4 = np.array([0, 1, 4, 5,
                            2, 3, 4, 5,
                            6, 6, 8, 8,
                            7, 7, 8, 8], dtype=np.int32)


class _ChannelParams:
    def __init__(self, is_chroma: bool):
        self.is_chroma = is_chroma
        if is_chroma:
            self.sig = OFFSETS.sig_chroma
            self.sig_cg = OFFSETS.sig_cg_chroma
            self.last_x = OFFSETS.last_x_chroma
            self.last_y = OFFSETS.last_y_chroma
            self.greater1 = OFFSETS.greater1_chroma
            self.greater2 = OFFSETS.greater2_chroma
        else:
            self.sig = OFFSETS.sig
            self.sig_cg = OFFSETS.sig_cg
            self.last_x = OFFSETS.last_x
            self.last_y = OFFSETS.last_y
            self.greater1 = OFFSETS.greater1
            self.greater2 = OFFSETS.greater2


LUMA = _ChannelParams(False)


CHROMA = _ChannelParams(True)


def _last_ctx_params(log2n: int, ch: _ChannelParams):
    """(blkSizeOffset, shift) for last-significant-XY context."""
    if ch.is_chroma:
        return 0, log2n - 2
    return ((log2n - 2) * 3 + ((log2n - 1) >> 2)), ((log2n + 1) >> 2)


def _sig_ctx(pattern: int, pos_x: int, pos_y: int, log2n: int, scan_type: int,
             first_ctx: int, ch: _ChannelParams) -> int:
    """Absolute sig_coeff_flag context index."""
    if pos_x + pos_y == 0:
        return ch.sig + 0
    if log2n == 2:
        return ch.sig + int(CTX_IND_MAP_4X4[4 * pos_y + pos_x])
    px, py = pos_x & 3, pos_y & 3
    if pattern == 0:
        total = px + py
        cnt = 0 if total >= 3 else (1 if total >= 1 else 2)
    elif pattern == 1:
        cnt = 0 if py >= 2 else (1 if py >= 1 else 2)
    elif pattern == 2:
        cnt = 0 if px >= 2 else (1 if px >= 1 else 2)
    else:
        cnt = 2
    not_first_group = ((pos_x >> 2) + (pos_y >> 2)) > 0
    nfg_off = (0 if ch.is_chroma else 3) if not_first_group else 0
    return ch.sig + first_ctx + nfg_off + cnt


def _first_sig_ctx(n: int, scan_type: int, ch: _ChannelParams) -> int:
    if n == 4:
        return 0
    if ch.is_chroma:
        return 9 if n == 8 else 12
    if n == 8:
        return 9 + (6 if scan_type != scans.SCAN_DIAG else 0)
    return 21


def _greater1_ctx_set(subset_idx: int, prev_c1_zero: bool,
                      ch: _ChannelParams) -> int:
    base = 2 if (subset_idx > 0 and not ch.is_chroma) else 0
    return base + (1 if prev_c1_zero else 0)


def _scan_for(mode: int, n: int, ch: _ChannelParams) -> int:
    """Mode-dependent coefficient scan: luma up to 8x8, chroma only 4x4
    (HM getCoefScanIdx)."""
    if ch.is_chroma and n > 4:
        return scans.SCAN_DIAG
    return scans.select_scan(mode, n)


def mpm_candidates(left_mode: int, above_mode: int):
    """Three most-probable modes from the left/above PU modes (DC if absent)."""
    if left_mode == above_mode:
        if left_mode > 1:
            return [left_mode,
                    ((left_mode + 29) % 32) + 2,
                    ((left_mode - 1) % 32) + 2]
        return [PLANAR_IDX, DC_IDX, VER_IDX]
    mpm0, mpm1 = left_mode, above_mode
    if left_mode and above_mode:
        mpm2 = PLANAR_IDX
    elif (left_mode + above_mode) < 2:
        mpm2 = VER_IDX
    else:
        mpm2 = DC_IDX
    return [mpm0, mpm1, mpm2]


def encode_intra_mode(enc: cabac.CabacEncoder, ctx: np.ndarray, mode: int, mpms):
    if mode in mpms:
        enc.encode_bin(1, ctx, OFFSETS.prev_intra)
        idx = mpms.index(mode)
        if idx == 0:
            enc.encode_bin_ep(0)
        else:
            enc.encode_bin_ep(1)
            enc.encode_bin_ep(idx - 1)
    else:
        enc.encode_bin(0, ctx, OFFSETS.prev_intra)
        sorted_mpms = sorted(mpms)
        rem = mode
        for m in reversed(sorted_mpms):
            if rem > m:
                rem -= 1
        enc.encode_bins_ep(rem, 5)


@functools.lru_cache(maxsize=None)
def _coef_tables(n: int, scan_type: int, is_chroma: bool):
    """Python-list tables of one (size, scan, channel) for the coefficient
    coder's per-bin loop: the scan, the CG scan, and the sig_coeff_flag
    context of every raster position under each CG pattern 0-3."""
    ch = CHROMA if is_chroma else LUMA
    log2n = n.bit_length() - 1
    first_ctx = _first_sig_ctx(n, scan_type, ch)
    sig = [[_sig_ctx(p, rp % n, rp // n, log2n, scan_type, first_ctx, ch)
            for rp in range(n * n)] for p in range(4)]
    return (scans.scan_order(n, n, scan_type).tolist(),
            scans.cg_scan_order(n, n, scan_type).tolist(), sig)


def encode_coefficients(enc: cabac.CabacEncoder, ctx: np.ndarray,
                        coeffs: np.ndarray, mode: int,
                        sign_hiding: bool = False,
                        channel: _ChannelParams = LUMA):
    """Encodes one non-empty n x n TU coefficient block (luma or chroma)."""
    ch = channel
    n = coeffs.shape[0]
    log2n = n.bit_length() - 1
    scan_type = _scan_for(mode, n, ch)
    scan, scan_cg, sig_ctx = _coef_tables(n, scan_type, ch.is_chroma)
    flat = coeffs.reshape(-1).tolist()
    width_in_groups = max(n // 4, 1)
    encode_bin = enc.encode_bin

    nz_scan_positions = [sp for sp, rp in enumerate(scan) if flat[rp]]
    assert nz_scan_positions, "empty TU passed to encode_coefficients"
    scan_pos_last = nz_scan_positions[-1]
    pos_last = scan[scan_pos_last]
    pos_last_y, pos_last_x = divmod(pos_last, n)

    sig_cg = [0] * max(width_in_groups * width_in_groups, 1)
    for sp in nz_scan_positions:
        py, px = divmod(scan[sp], n)
        sig_cg[(py >> 2) * width_in_groups + (px >> 2)] = 1

    # ---- last significant position ----
    lx, ly = pos_last_x, pos_last_y
    if scan_type == scans.SCAN_VER:
        lx, ly = ly, lx
    group_x = int(scans.GROUP_IDX[lx])
    group_y = int(scans.GROUP_IDX[ly])
    blk_offset, shift = _last_ctx_params(log2n, ch)
    for c in range(group_x):
        encode_bin(1, ctx, ch.last_x + blk_offset + (c >> shift))
    if group_x < int(scans.GROUP_IDX[n - 1]):
        encode_bin(0, ctx, ch.last_x + blk_offset + (group_x >> shift))
    for c in range(group_y):
        encode_bin(1, ctx, ch.last_y + blk_offset + (c >> shift))
    if group_y < int(scans.GROUP_IDX[n - 1]):
        encode_bin(0, ctx, ch.last_y + blk_offset + (group_y >> shift))
    if group_x > 3:
        count = (group_x - 2) >> 1
        rem = lx - int(scans.MIN_IN_GROUP[group_x])
        for i in range(count - 1, -1, -1):
            enc.encode_bin_ep((rem >> i) & 1)
    if group_y > 3:
        count = (group_y - 2) >> 1
        rem = ly - int(scans.MIN_IN_GROUP[group_y])
        for i in range(count - 1, -1, -1):
            enc.encode_bin_ep((rem >> i) & 1)

    # ---- per-CG coding, last to first ----
    last_scan_set = scan_pos_last >> 4
    c1 = 1
    scan_pos_sig = scan_pos_last

    # Track sig_cg flags as coded (for context of subsequent CGs the full map
    # is already known to the encoder; HM builds it upfront identically).
    for subset in range(last_scan_set, -1, -1):
        sub_pos = subset << 4
        go_rice = 0
        abs_coeffs = []
        coeff_signs = 0
        num_nonzero = 0
        last_nz_in_cg = -1
        first_nz_in_cg = 16

        if scan_pos_sig == scan_pos_last:
            v = flat[pos_last]
            abs_coeffs.append(abs(v))
            coeff_signs = 1 if v < 0 else 0
            num_nonzero = 1
            last_nz_in_cg = first_nz_in_cg = scan_pos_sig
            scan_pos_sig -= 1

        cg_blk = scan_cg[subset]
        cg_y, cg_x = divmod(cg_blk, width_in_groups)
        if subset == last_scan_set or subset == 0:
            sig_cg[cg_blk] = 1
        else:
            right = cg_x < width_in_groups - 1 and sig_cg[cg_blk + 1]
            below = cg_y < width_in_groups - 1 and sig_cg[cg_blk + width_in_groups]
            ctx_cg = 1 if (right or below) else 0
            encode_bin(sig_cg[cg_blk], ctx, ch.sig_cg + ctx_cg)

        if sig_cg[cg_blk]:
            right = cg_x < width_in_groups - 1 and sig_cg[cg_blk + 1]
            below = cg_y < width_in_groups - 1 and sig_cg[cg_blk + width_in_groups]
            ctx_of = sig_ctx[(1 if right else 0) + (2 if below else 0)]
            while scan_pos_sig >= sub_pos:
                rp = scan[scan_pos_sig]
                v = flat[rp]
                if scan_pos_sig > sub_pos or subset == 0 or num_nonzero:
                    encode_bin(1 if v else 0, ctx, ctx_of[rp])
                if v:
                    abs_coeffs.append(abs(v))
                    coeff_signs = 2 * coeff_signs + (1 if v < 0 else 0)
                    num_nonzero += 1
                    if last_nz_in_cg == -1:
                        last_nz_in_cg = scan_pos_sig
                    first_nz_in_cg = scan_pos_sig
                scan_pos_sig -= 1
        else:
            scan_pos_sig = sub_pos - 1

        if num_nonzero > 0:
            hidden = sign_hiding and (last_nz_in_cg - first_nz_in_cg >= SBH_THRESHOLD)
            ctx_set = _greater1_ctx_set(subset, c1 == 0, ch)
            c1 = 1
            base_g1 = ch.greater1 + 4 * ctx_set
            escape_present = False
            num_c1 = min(num_nonzero, C1FLAG_NUMBER)
            first_c2_idx = -1
            for idx in range(num_c1):
                symbol = 1 if abs_coeffs[idx] > 1 else 0
                encode_bin(symbol, ctx, base_g1 + c1)
                if symbol:
                    c1 = 0
                    if first_c2_idx == -1:
                        first_c2_idx = idx
                    else:
                        escape_present = True
                elif 0 < c1 < 3:
                    c1 += 1
            if c1 == 0 and first_c2_idx != -1:
                symbol = 1 if abs_coeffs[first_c2_idx] > 2 else 0
                encode_bin(symbol, ctx, ch.greater2 + ctx_set)
                if symbol:
                    escape_present = True
            escape_present = escape_present or (num_nonzero > C1FLAG_NUMBER)

            if hidden:
                enc.encode_bins_ep(coeff_signs >> 1, num_nonzero - 1)
            else:
                enc.encode_bins_ep(coeff_signs, num_nonzero)

            if escape_present:
                first_coeff2 = 1
                for idx in range(num_nonzero):
                    base_level = (2 + first_coeff2) if idx < C1FLAG_NUMBER else 1
                    if abs_coeffs[idx] >= base_level:
                        _write_coef_remain(enc, abs_coeffs[idx] - base_level, go_rice)
                        if abs_coeffs[idx] > (3 << go_rice):
                            go_rice = min(go_rice + 1, 4)
                    if abs_coeffs[idx] >= 2:
                        first_coeff2 = 0


def _write_coef_remain(enc: cabac.CabacEncoder, symbol: int, r_param: int):
    if symbol < (COEF_REMAIN_BIN_REDUCTION << r_param):
        length = symbol >> r_param
        enc.encode_bins_ep((1 << (length + 1)) - 2, length + 1)
        enc.encode_bins_ep(symbol % (1 << r_param), r_param)
    else:
        length = r_param
        code = symbol - (COEF_REMAIN_BIN_REDUCTION << r_param)
        while code >= (1 << length):
            code -= 1 << length
            length += 1
        enc.encode_bins_ep((1 << (COEF_REMAIN_BIN_REDUCTION + length + 1 - r_param)) - 2,
                           COEF_REMAIN_BIN_REDUCTION + length + 1 - r_param)
        enc.encode_bins_ep(code, length)

