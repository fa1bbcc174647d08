"""Static CABAC rate tables of the wavefront2 trial (HM FAST_BIT_EST from
the context-initialisation states at the frame QP).

A frozen copy of the port's `parallel/rate_model.py` as the benchmark's
plain reference uses it (only the parts it needs; nothing of the port is
imported).
"""

from __future__ import annotations

import functools

import numpy as np

from . import cabac, scans
from .contexts import OFFSETS, make_context_states
from .syntax import (LUMA, _first_sig_ctx, _last_ctx_params, _scan_for,
                     _sig_ctx)


_LOG2_15 = float(1 << 15)


@functools.lru_cache(maxsize=None)
def _states(qp: int) -> np.ndarray:
    st = make_context_states(qp).astype(np.int64)
    st.setflags(write=False)
    return st


def _fb(states: np.ndarray, idx: int, b: int) -> float:
    """Fractional bits of coding bin b in context idx at its current state."""
    return float(cabac.ENTROPY_BITS[int(states[idx]) ^ b]) / _LOG2_15


@functools.lru_cache(maxsize=None)
def scalar_bits(qp: int) -> dict:
    """QP-calibrated scalar bit costs for structure/mode syntax."""
    st = _states(qp)
    avg = lambda off, k, b: float(
        np.mean([_fb(st, off + i, b) for i in range(k)]))
    return dict(
        split0=avg(OFFSETS.split_cu, 3, 0),
        split1=avg(OFFSETS.split_cu, 3, 1),
        part_2nx2n=_fb(st, OFFSETS.part_size, 1),
        part_nxn=_fb(st, OFFSETS.part_size, 0),
        cbf0=_fb(st, OFFSETS.cbf_luma + 1, 0),
        cbf1=_fb(st, OFFSETS.cbf_luma + 1, 1),
        csb0=avg(OFFSETS.sig_cg, 2, 0),
        csb1=avg(OFFSETS.sig_cg, 2, 1),
        g1_0=float(np.mean([_fb(st, OFFSETS.greater1 + c, 0)
                            for c in (1, 9)])),
        g1_1=float(np.mean([_fb(st, OFFSETS.greater1 + c, 1)
                            for c in (1, 9)])),
        g2_0=float(np.mean([_fb(st, OFFSETS.greater2 + c, 0)
                            for c in (0, 2)])),
        g2_1=float(np.mean([_fb(st, OFFSETS.greater2 + c, 1)
                            for c in (0, 2)])),
        mpm1=_fb(st, OFFSETS.prev_intra, 1),
        mpm0=_fb(st, OFFSETS.prev_intra, 0),
        # Switch policy: leading PNNS bin per PU, dedicated context init 154
        # (hm_16_15_switch ContextTables.h:239-247).
        pnns0=_fb(st, OFFSETS.pnns_flag, 0),
        pnns1=_fb(st, OFFSETS.pnns_flag, 1),
    )


@functools.lru_cache(maxsize=None)
def sig_bits_tables(qp: int, n: int):
    """(sig0, sig1) float32 (3, n*n) in SCAN order per scan type.

    Exact per-position context (syntax._sig_ctx), bits averaged over the four
    neighbour-CG sig patterns (unknown statically).
    """
    st = _states(qp)
    log2n = n.bit_length() - 1
    out0 = np.zeros((3, n * n), np.float32)
    out1 = np.zeros((3, n * n), np.float32)
    for stype in range(3):
        first = _first_sig_ctx(n, stype, LUMA)
        scan = scans.scan_order(n, n, stype)
        for pos in range(n * n):
            py, px = divmod(int(scan[pos]), n)
            b0 = b1 = 0.0
            for pattern in range(4):
                ctx = _sig_ctx(pattern, px, py, log2n, stype, first, LUMA)
                b0 += _fb(st, ctx, 0)
                b1 += _fb(st, ctx, 1)
            out0[stype, pos] = b0 / 4.0
            out1[stype, pos] = b1 / 4.0
    return out0, out1


@functools.lru_cache(maxsize=None)
def last_bits_tables(qp: int, n: int):
    """Exact last-significant-coordinate bits: (x_bits, y_bits), (n,) each."""
    st = _states(qp)
    log2n = n.bit_length() - 1
    blk_offset, shift = _last_ctx_params(log2n, LUMA)
    gmax = int(scans.GROUP_IDX[n - 1])

    def table(base_off):
        out = np.zeros(n, np.float32)
        for v in range(n):
            g = int(scans.GROUP_IDX[v])
            bits = 0.0
            for c in range(g):
                bits += _fb(st, base_off + blk_offset + (c >> shift), 1)
            if g < gmax:
                bits += _fb(st, base_off + blk_offset + (g >> shift), 0)
            if g > 3:
                bits += (g >> 1) - 1  # EP suffix
            out[v] = bits
        return out

    return table(OFFSETS.last_x), table(OFFSETS.last_y)


@functools.lru_cache(maxsize=None)
def scan_tables(n: int):
    """(scan_gather (3, n*n) int32 scan->raster, mode_scan (35,) int32)."""
    gather = np.stack([np.asarray(scans.scan_order(n, n, t), np.int32)
                       for t in range(3)])
    mode_scan = np.array([_scan_for(m, n, LUMA) for m in range(35)], np.int32)
    return gather, mode_scan


def mode_bits_table(qp: int) -> np.ndarray:
    """[mpm0, mpm1, mpm2, non-mpm] total mode-signalling bits."""
    s = scalar_bits(qp)
    return np.array([s["mpm1"] + 1.0, s["mpm1"] + 2.0, s["mpm1"] + 2.0,
                     s["mpm0"] + 5.0], np.float32)

