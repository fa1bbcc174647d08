"""Rate-distortion optimization: lambda model, SATD, bit counting.

The port's copy of the JAX package's `codec/rdo.py`, host numpy as there;
parity with HM-16.15:
* lambda = 0.57 * 2^((QP-12)/3) for All-Intra (TEncSlice::calculateLambda with
  zero B-frames), sqrt(lambda) for the SATD-based fast pass;
* Hadamard SATD evaluated on 8x8 sub-blocks ((sum+2)>>2) or 4x4 ((sum+1)>>1)
  like TComRdCost::xCalcHADs8x8/4x4;
* candidate counts per PU size from g_aucIntraModeNumFast_UseMPM
  (TComRom.cpp: 8 for 4x4/8x8, 3 for 16-64);
* rate estimation via a counting CABAC (HM FAST_BIT_EST): same context
  transitions as the real encoder, fractional bits from the entropy table.
"""

from __future__ import annotations

import functools

import numpy as np

from . import cabac, native, scans, syntax

# Python-list copy of the entropy table for the per-bin counts.
_ENTROPY = cabac.ENTROPY_BITS.tolist()

# g_aucIntraModeNumFast_UseMPM, indexed by log2(size).
NUM_FAST_CANDIDATES = {4: 8, 8: 8, 16: 3, 32: 3, 64: 3}


def lambda_for_qp(qp: int) -> float:
    return 0.57 * (2.0 ** ((qp - 12) / 3.0))


# ------------------------------------------------------------------ SATD ----

def _hadamard(n: int) -> np.ndarray:
    h = np.array([[1]], dtype=np.int64)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def satd(residuals: np.ndarray) -> np.ndarray:
    """Batched HM-style SATD of (B, n, n) int residuals -> (B,) int64.

    n >= 8 evaluates 8x8 Hadamard sub-blocks; n == 4 the 4x4 Hadamard.
    """
    b, n, _ = residuals.shape
    r = residuals.astype(np.int64)
    if n == 4:
        h = _hadamard(4)
        t = h @ r @ h
        return (np.abs(t).sum(axis=(1, 2)) + 1) >> 1
    h = _hadamard(8)
    blocks = r.reshape(b, n // 8, 8, n // 8, 8).transpose(0, 1, 3, 2, 4).reshape(-1, 8, 8)
    t = h @ blocks @ h
    sums = (np.abs(t).sum(axis=(1, 2)) + 2) >> 2
    return sums.reshape(b, -1).sum(axis=1)


# ----------------------------------------------------------- bit counting ----

class BitCounter:
    """Duck-typed CabacEncoder that counts fractional bits instead of coding.

    Context states advance exactly as in the real engine, so estimates track
    adaptation.  `bits` is in 15-bit fixed point (32768 = 1 bit).
    """

    def __init__(self):
        self.bits = 0

    def encode_bin(self, bin_value: int, ctx: np.ndarray, idx: int):
        state = int(ctx[idx])
        self.bits += _ENTROPY[state ^ bin_value]
        ctx[idx] = (cabac._NEXT_MPS[state] if bin_value == (state & 1)
                    else cabac._NEXT_LPS[state])

    def encode_bin_ep(self, bin_value: int):
        self.bits += cabac.EP_BIN_BITS

    def encode_bins_ep(self, bin_values: int, num_bins: int):
        self.bits += cabac.EP_BIN_BITS * num_bins

    def encode_bin_trm(self, bin_value: int):
        self.bits += cabac.EP_BIN_BITS

    def count_coefficients(self, ctx: np.ndarray, coeffs: np.ndarray,
                           mode: int, sign_hiding: bool = False,
                           channel=syntax.LUMA):
        """Counts `syntax.encode_coefficients(self, ctx, coeffs, mode,
        sign_hiding, channel)` in one native call: the same bits, and the
        same context states left in `ctx`."""
        n = coeffs.shape[0]
        scan_type = syntax._scan_for(mode, n, channel)
        blk_offset, shift = syntax._last_ctx_params(n.bit_length() - 1,
                                                    channel)
        self.bits += native.count_coefficient_bits(
            coeffs, ctx, _count_tables(n, scan_type, channel.is_chroma)[1],
            (1 if scan_type == scans.SCAN_VER else 0, 1 if sign_hiding else 0,
             channel.last_x, channel.last_y, blk_offset, shift,
             channel.sig_cg, channel.greater1, channel.greater2,
             1 if channel.is_chroma else 0))

    @property
    def frac_bits(self) -> float:
        return self.bits / 32768.0


@functools.lru_cache(maxsize=None)
def _count_tables(n: int, scan_type: int, is_chroma: bool) -> tuple:
    """(int32 arrays, their addresses) for `native.count_coefficient_bits`:
    the scan, the CG scan and the sig_coeff_flag contexts of
    `syntax._coef_tables`, then the entropy and next-state tables.  The
    cache keeps the arrays alive."""
    scan, scan_cg, sig = syntax._coef_tables(n, scan_type, is_chroma)
    arrays = tuple(np.ascontiguousarray(a, dtype=np.int32) for a in (
        scan, scan_cg, sig, cabac.ENTROPY_BITS, cabac.NEXT_STATE_MPS,
        cabac.NEXT_STATE_LPS))
    return arrays, tuple(a.ctypes.data for a in arrays)
