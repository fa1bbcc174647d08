"""Rate-distortion optimized quantization (RDOQ).

Faithful port of HM-16.15 `TComTrQuant::xRateDistOptQuant`
(TComTrQuant.cpp:2119-2560) with `xGetCodedLevel`, `xGetICRate`,
`xGetRateLast` and the estBit tables (TEncSbac::estBit) for the 8-bit luma
no-scaling-list configuration:

* per-coefficient level choice among {0, ceil-1, ceil} minimizing
  err^2 * errScale + lambda * rate, with rates from the CURRENT CABAC context
  states (fractional bits via the entropy table);
* coefficient-group zero-out decisions;
* optimal last-significant-position selection (including the all-zero/CBF
  trade-off);
* errScale = 2^SCALE_BITS * 2^(-2*transformShift) / quantScale^2.

This is the main RD tool separating plain scalar quantization from HM; it is
used by the host RDO encoder for every candidate evaluation (HM does the
same).  The port's copy of the JAX package's `codec/rdoq.py`, host numpy;
`rdoq` takes the native routine for luma with no Python fallback.
"""

from __future__ import annotations

import numpy as np

from ..ops import transform
from . import cabac, scans
from .contexts import OFFSETS
from .syntax import (C1FLAG_NUMBER, LUMA, _first_sig_ctx,
                     _last_ctx_params, _scan_for, _sig_ctx)

SCALE_BITS = 15
C2FLAG_NUMBER = 1
IEP_RATE = 1 << 15
MAX_DOUBLE = 1e30


def _bits(ctx_states: np.ndarray, idx: int, bin_value: int) -> int:
    return int(cabac.ENTROPY_BITS[int(ctx_states[idx]) ^ bin_value])


def _ic_rate(abs_level: int, g1_bits0: int, g1_bits1: int, g2_bits0: int,
             g2_bits1: int, go_rice: int, c1_idx: int, c2_idx: int) -> int:
    """xGetICRate: fractional-bit rate (2^15 units) of a nonzero level."""
    rate = IEP_RATE  # sign bit
    base_level = (2 + (1 if c2_idx < C2FLAG_NUMBER else 0)) \
        if c1_idx < C1FLAG_NUMBER else 1
    if abs_level >= base_level:
        symbol = abs_level - base_level
        if symbol < (3 << go_rice):
            length = symbol >> go_rice
            rate += (length + 1 + go_rice) << 15
        else:
            length = go_rice
            symbol -= 3 << go_rice
            while symbol >= (1 << length):
                symbol -= 1 << length
                length += 1
            rate += (3 + length + 1 - go_rice + length) << 15
        if c1_idx < C1FLAG_NUMBER:
            rate += g1_bits1
            if c2_idx < C2FLAG_NUMBER:
                rate += g2_bits1
    elif abs_level == 1:
        rate += g1_bits0
    elif abs_level == 2:
        rate += g1_bits1 + g2_bits0
    else:
        rate = 0
    return rate


def rdoq(coeffs: np.ndarray, qp: int, mode: int, lam: float,
         ctx_states: np.ndarray, *, cbf_ctx_offset: int = 1,
         sign_hiding: bool = False, channel=LUMA) -> np.ndarray:
    """RDOQ of one TU: a luma TU through the native `rdoq_tu`
    (`native/rdoq.cpp`, equal output to `rdoq_python`; a build or call
    failure raises), a chroma TU through `rdoq_python` with the chroma
    context set (the native routine covers luma only)."""
    if channel.is_chroma:
        return rdoq_python(coeffs, qp, mode, lam, ctx_states,
                           cbf_ctx_offset=cbf_ctx_offset,
                           sign_hiding=sign_hiding, channel=channel)
    from . import native

    return native.rdoq_tu_native(coeffs, qp, mode, lam, ctx_states,
                                 cbf_ctx_offset, sign_hiding)


def rdoq_python(coeffs: np.ndarray, qp: int, mode: int, lam: float,
                ctx_states: np.ndarray, *, cbf_ctx_offset: int = 1,
                sign_hiding: bool = False, channel=LUMA) -> np.ndarray:
    """RD-optimized quantization of one n x n luma TU.

    `ctx_states` is the running context array (read-only here; RDOQ uses it
    as HM uses the loaded RD-sbac estimate).  Returns signed levels.  With
    `sign_hiding` the HM RDOQ tail adjusts one level per eligible CG so the
    hidden sign's parity matches (TComTrQuant.cpp:2533-2660).
    """
    n = coeffs.shape[0]
    log2n = n.bit_length() - 1
    per, rem = qp // 6, qp % 6
    tshift = transform.transform_shift(log2n)
    qbits = transform.QUANT_SHIFT + per + tshift
    qscale = transform.QUANT_SCALES[rem]
    err_scale = (float(1 << SCALE_BITS) * (2.0 ** (-2.0 * tshift))
                 / qscale / qscale)
    entropy_max = (1 << transform.MAX_TR_DYNAMIC_RANGE) - 1

    ch = channel
    scan_type = _scan_for(mode, n, ch)
    scan = scans.scan_order(n, n, scan_type)
    scan_cg = scans.cg_scan_order(n, n, scan_type)
    wig = max(n // 4, 1)
    first_ctx = _first_sig_ctx(n, scan_type, ch)
    flat = coeffs.reshape(-1)
    total = n * n
    cg_num = max(total >> 4, 1)
    cg_size = min(total, 16)

    # Precompute vectorized quantities.
    abs_src = np.abs(flat.astype(np.int64))
    level_double = abs_src * qscale
    max_abs = np.minimum((level_double + (1 << (qbits - 1))) >> qbits,
                         entropy_max).astype(np.int64)
    cost_coeff0_blk = (level_double.astype(np.float64) ** 2) * err_scale

    # estBits helpers (fractional bits in 2^15 units).
    def sig_bits(ctx_inc, b):
        return _bits(ctx_states, ctx_inc, b)

    dst = np.zeros(total, dtype=np.int64)          # by blk pos, unsigned
    cost_coeff = np.zeros(total)
    cost_sig = np.zeros(total)
    cost_coeff0 = np.zeros(total)
    delta_u = np.zeros(total, dtype=np.int64)      # by blk pos
    rate_inc_up = np.zeros(total, dtype=np.int64)
    rate_inc_down = np.zeros(total, dtype=np.int64)
    sig_rate_delta = np.zeros(total, dtype=np.int64)

    block_uncoded_cost = 0.0
    base_cost = 0.0
    last_scan_pos = -1
    cg_last_scan_pos = -1
    ctx_set = 0
    c1, c2 = 1, 0
    c1_idx = c2_idx = 0
    go_rice = 0
    sig_cg_flags = np.zeros(cg_num, dtype=np.int64)
    cost_cg_sig = np.zeros(cg_num)

    def get_ic_rate(level, one_ctx, abs_ctx, rice, c1i, c2i):
        return _ic_rate(level,
                        _bits(ctx_states, ch.greater1 + one_ctx, 0),
                        _bits(ctx_states, ch.greater1 + one_ctx, 1),
                        _bits(ctx_states, ch.greater2 + abs_ctx, 0),
                        _bits(ctx_states, ch.greater2 + abs_ctx, 1),
                        rice, c1i, c2i)

    def ic_cost(rate):
        return lam * rate

    for cg_scan_pos in range(cg_num - 1, -1, -1):
        cg_blk = int(scan_cg[cg_scan_pos])
        cg_y, cg_x = divmod(cg_blk, wig)
        right = cg_x < wig - 1 and sig_cg_flags[cg_blk + 1]
        below = cg_y < wig - 1 and sig_cg_flags[cg_blk + wig]
        pattern = (1 if right else 0) + (2 if below else 0)

        rd_sig_cost = 0.0
        rd_sig_cost_0 = 0.0
        rd_coded_dist = 0.0
        rd_uncoded_dist = 0.0
        rd_nnz_before0 = 0

        for pos_in_cg in range(cg_size - 1, -1, -1):
            scan_pos = cg_scan_pos * cg_size + pos_in_cg
            blk = int(scan[scan_pos])
            ld = int(level_double[blk])
            ma = int(max_abs[blk])
            cost_coeff0[scan_pos] = cost_coeff0_blk[blk]
            block_uncoded_cost += cost_coeff0[scan_pos]
            dst[blk] = ma
            if ma > 0 and last_scan_pos < 0:
                last_scan_pos = scan_pos
                ctx_set = (2 if ((scan_pos >> 4) > 0
                                 and not ch.is_chroma) else 0)
                cg_last_scan_pos = cg_scan_pos

            if last_scan_pos >= 0:
                one_ctx = 4 * ctx_set + c1
                # HM: uiAbsCtx = ctxSet + c2 (c2 can exceed the per-set slot -
                # an HM estimation quirk); clamp into the luma table.
                abs_ctx = min(ctx_set + c2, 1 if ch.is_chroma else 3)
                is_last = scan_pos == last_scan_pos
                if is_last:
                    sig_ctx_inc = 0
                    cost_sig_1 = 0.0
                else:
                    py, px = divmod(blk, n)
                    sig_ctx_inc = _sig_ctx(pattern, px, py, log2n, scan_type,
                                           first_ctx, ch)
                    cost_sig_1 = ic_cost(sig_bits(sig_ctx_inc, 1))

                # xGetCodedLevel
                best_level = 0
                if not is_last and ma < 3:
                    cost_sig[scan_pos] = ic_cost(sig_bits(sig_ctx_inc, 0))
                    cost_coeff[scan_pos] = cost_coeff0[scan_pos] + cost_sig[scan_pos]
                    coded_cost = cost_coeff[scan_pos]
                else:
                    coded_cost = MAX_DOUBLE
                if ma > 0:
                    min_abs = ma - 1 if ma > 1 else 1
                    for lvl in range(ma, min_abs - 1, -1):
                        err = float(ld - (lvl << qbits))
                        cur = (err * err * err_scale
                               + ic_cost(get_ic_rate(lvl, one_ctx, abs_ctx,
                                                     go_rice, c1_idx, c2_idx))
                               + cost_sig_1)
                        if cur < coded_cost:
                            best_level = lvl
                            coded_cost = cur
                            cost_coeff[scan_pos] = cur
                            cost_sig[scan_pos] = cost_sig_1
                level = best_level
                dst[blk] = level
                base_cost += cost_coeff[scan_pos]
                if not is_last:
                    sig_rate_delta[blk] = (sig_bits(sig_ctx_inc, 1)
                                           - sig_bits(sig_ctx_inc, 0))
                delta_u[blk] = (ld - (level << qbits)) >> (qbits - 8)
                if level > 0:
                    rate_now = get_ic_rate(level, one_ctx, abs_ctx, go_rice,
                                           c1_idx, c2_idx)
                    rate_inc_up[blk] = get_ic_rate(
                        level + 1, one_ctx, abs_ctx, go_rice, c1_idx, c2_idx) - rate_now
                    rate_inc_down[blk] = get_ic_rate(
                        level - 1, one_ctx, abs_ctx, go_rice, c1_idx, c2_idx) - rate_now
                else:
                    rate_inc_up[blk] = _bits(ctx_states,
                                             ch.greater1 + one_ctx, 0)

                base_level = (2 + (1 if c2_idx < C2FLAG_NUMBER else 0)) \
                    if c1_idx < C1FLAG_NUMBER else 1
                if level >= base_level and level > (3 << go_rice):
                    go_rice = min(go_rice + 1, 4)
                if level >= 1:
                    c1_idx += 1
                if level > 1:
                    c1 = 0
                    c2 += (1 if c2 < 2 else 0)
                    c2_idx += 1
                elif 0 < c1 < 3 and level:
                    c1 += 1
                if scan_pos % cg_size == 0 and scan_pos > 0:
                    ctx_set = (2 if (((scan_pos - 1) >> 4) > 0
                                     and not ch.is_chroma) else 0) \
                        + (1 if c1 == 0 else 0)
                    c1, c2 = 1, 0
                    c1_idx = c2_idx = 0
                    go_rice = 0
            else:
                base_cost += cost_coeff0[scan_pos]

            rd_sig_cost += cost_sig[scan_pos]
            if pos_in_cg == 0:
                rd_sig_cost_0 = cost_sig[scan_pos]
            if dst[blk]:
                sig_cg_flags[cg_blk] = 1
                rd_coded_dist += cost_coeff[scan_pos] - cost_sig[scan_pos]
                rd_uncoded_dist += cost_coeff0[scan_pos]
                if pos_in_cg != 0:
                    rd_nnz_before0 += 1

        # Coefficient-group decisions.
        if cg_last_scan_pos >= 0:
            if cg_scan_pos:
                cg_ctx = 1 if (right or below) else 0
                if sig_cg_flags[cg_blk] == 0:
                    rate0 = ic_cost(_bits(ctx_states, ch.sig_cg + cg_ctx, 0))
                    base_cost += rate0 - rd_sig_cost
                    cost_cg_sig[cg_scan_pos] = rate0
                else:
                    if cg_scan_pos < cg_last_scan_pos:
                        if rd_nnz_before0 == 0:
                            base_cost -= rd_sig_cost_0
                            rd_sig_cost -= rd_sig_cost_0
                        cost_zero_cg = base_cost
                        rate1 = ic_cost(_bits(ctx_states, ch.sig_cg + cg_ctx, 1))
                        rate0 = ic_cost(_bits(ctx_states, ch.sig_cg + cg_ctx, 0))
                        base_cost += rate1
                        cost_zero_cg += rate0
                        cost_cg_sig[cg_scan_pos] = rate1
                        cost_zero_cg += rd_uncoded_dist
                        cost_zero_cg -= rd_coded_dist
                        cost_zero_cg -= rd_sig_cost
                        if cost_zero_cg < base_cost:
                            sig_cg_flags[cg_blk] = 0
                            base_cost = cost_zero_cg
                            cost_cg_sig[cg_scan_pos] = rate0
                            for pos_in_cg in range(cg_size - 1, -1, -1):
                                scan_pos = cg_scan_pos * cg_size + pos_in_cg
                                blk = int(scan[scan_pos])
                                if dst[blk]:
                                    dst[blk] = 0
                                    cost_coeff[scan_pos] = cost_coeff0[scan_pos]
                                    cost_sig[scan_pos] = 0.0
            else:
                sig_cg_flags[cg_blk] = 1

    if last_scan_pos < 0:
        return np.zeros((n, n), dtype=np.int32)

    # ---- last-position / CBF decision ----
    cbf_base = OFFSETS.cbf_chroma if ch.is_chroma else OFFSETS.cbf_luma
    cbf_idx = cbf_base + cbf_ctx_offset
    best_cost = block_uncoded_cost + ic_cost(_bits(ctx_states, cbf_idx, 0))
    base_cost += ic_cost(_bits(ctx_states, cbf_idx, 1))
    best_last_idx_p1 = 0

    blk_offset, shift = _last_ctx_params(log2n, ch)
    max_group = int(scans.GROUP_IDX[n - 1])

    def rate_last(pos_x, pos_y):
        gx = int(scans.GROUP_IDX[pos_x])
        gy = int(scans.GROUP_IDX[pos_y])
        cost = 0
        # lastXBits[gx]: gx ones + terminating zero (if below max group).
        for c in range(gx):
            cost += _bits(ctx_states, ch.last_x + blk_offset + (c >> shift), 1)
        if gx < max_group:
            cost += _bits(ctx_states, ch.last_x + blk_offset + (gx >> shift), 0)
        for c in range(gy):
            cost += _bits(ctx_states, ch.last_y + blk_offset + (c >> shift), 1)
        if gy < max_group:
            cost += _bits(ctx_states, ch.last_y + blk_offset + (gy >> shift), 0)
        if gx > 3:
            cost += IEP_RATE * ((gx - 2) >> 1)
        if gy > 3:
            cost += IEP_RATE * ((gy - 2) >> 1)
        return ic_cost(cost)

    found_last = False
    for cg_scan_pos in range(cg_last_scan_pos, -1, -1):
        cg_blk = int(scan_cg[cg_scan_pos])
        base_cost -= cost_cg_sig[cg_scan_pos]
        if sig_cg_flags[cg_blk]:
            for pos_in_cg in range(cg_size - 1, -1, -1):
                scan_pos = cg_scan_pos * cg_size + pos_in_cg
                if scan_pos > last_scan_pos:
                    continue
                blk = int(scan[scan_pos])
                if dst[blk]:
                    py, px = divmod(blk, n)
                    if scan_type == scans.SCAN_VER:
                        cost_last = rate_last(py, px)
                    else:
                        cost_last = rate_last(px, py)
                    total_cost = base_cost + cost_last - cost_sig[scan_pos]
                    if total_cost < best_cost:
                        best_last_idx_p1 = scan_pos + 1
                        best_cost = total_cost
                    if dst[blk] > 1:
                        found_last = True
                        break
                    base_cost -= cost_coeff[scan_pos]
                    base_cost += cost_coeff0[scan_pos]
                else:
                    base_cost -= cost_sig[scan_pos]
            if found_last:
                break

    out = np.zeros(total, dtype=np.int32)
    abs_sum = 0
    for scan_pos in range(best_last_idx_p1):
        blk = int(scan[scan_pos])
        level = int(dst[blk])
        abs_sum += level
        out[blk] = -level if flat[blk] < 0 else level

    if sign_hiding and abs_sum >= 2:
        inv_scale = float(transform.INV_QUANT_SCALES[rem])
        rd_factor = int(inv_scale * inv_scale * (1 << (2 * per)) / lam / 16 + 0.5)
        last_cg = -1
        big = np.iinfo(np.int64).max
        for subset in range((total - 1) >> 4, -1, -1):
            sub_pos = subset << 4
            first_nz, last_nz = cg_size, -1
            for i in range(cg_size - 1, -1, -1):
                if out[scan[sub_pos + i]]:
                    last_nz = i
                    break
            for i in range(cg_size):
                if out[scan[sub_pos + i]]:
                    first_nz = i
                    break
            cg_abs_sum = 0
            for i in range(max(first_nz, 0), last_nz + 1):
                cg_abs_sum += abs(int(out[scan[sub_pos + i]]))
            if last_nz >= 0 and last_cg == -1:
                last_cg = 1
            if last_nz - first_nz >= 4:  # SBH_THRESHOLD
                signbit = 0 if out[scan[sub_pos + first_nz]] > 0 else 1
                if signbit != (cg_abs_sum & 1):
                    min_cost, min_pos, final_change = big, -1, 0
                    start = last_nz if last_cg == 1 else cg_size - 1
                    for i in range(start, -1, -1):
                        blk = int(scan[sub_pos + i])
                        if out[blk] != 0:
                            cost_up = rd_factor * (-int(delta_u[blk])) + int(rate_inc_up[blk])
                            cost_down = (rd_factor * int(delta_u[blk])
                                         + int(rate_inc_down[blk])
                                         - (int(sig_rate_delta[blk])
                                            if abs(int(out[blk])) == 1 else 0))
                            if last_cg == 1 and last_nz == i and abs(int(out[blk])) == 1:
                                cost_down -= 4 << 15
                            if cost_up < cost_down:
                                cur_cost, cur_change = cost_up, 1
                            else:
                                cur_change = -1
                                if i == first_nz and abs(int(out[blk])) == 1:
                                    cur_cost = big
                                else:
                                    cur_cost = cost_down
                        else:
                            cur_cost = (rd_factor * (-abs(int(delta_u[blk])))
                                        + (1 << 15) + int(rate_inc_up[blk])
                                        + int(sig_rate_delta[blk]))
                            cur_change = 1
                            if i < first_nz:
                                this_sign = 0 if flat[blk] >= 0 else 1
                                if this_sign != signbit:
                                    cur_cost = big
                        if cur_cost < min_cost:
                            min_cost, final_change, min_pos = cur_cost, cur_change, blk
                    if (out[min_pos] == entropy_max
                            or out[min_pos] == -(entropy_max + 1)):
                        final_change = -1
                    if flat[min_pos] >= 0:
                        out[min_pos] += final_change
                    else:
                        out[min_pos] -= final_change
            if last_cg == 1:
                last_cg = 0
    return out.reshape(n, n)
