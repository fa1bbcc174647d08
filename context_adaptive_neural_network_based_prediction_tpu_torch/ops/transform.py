"""HEVC integer transforms (DCT-II 4-32, DST-VII 4) and scalar quantisation.

The port of the JAX package's `ops/transform.py`: the DST-VII 4x4 pair,
the integer DCT-II of sizes 4-32 (6-bit and 14-bit high-precision
forward), the quantiser scales, and HM's batched transforms and scalar
(de)quantiser in two forms.  `forward_transform`, `inverse_transform`,
`quantize` and `dequantize` take (B, n, n) integer tensors and compute on
the tensor's device (a numpy array goes to `device`, the card by default);
their matrix products run in float64 (`_product`), since CUDA has no
int64 product, and every sum stays below 2^53, so they are exact.  The
numpy twins (`forward_transform_np`, `quantize_np`, `dequantize_np`,
`inverse_transform_np`, int64) are what the host codec calls per TU.  The
wavefront encoder's transforms run inside the fused unit trial
(`ops/unit_fused.py`, `ops/csrc/unit_trial.cu`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


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


def forward_transform_np(residuals: np.ndarray, *, use_dst: bool = False,
                         bit_depth: int = BIT_DEPTH) -> np.ndarray:
    """HM's forward transform of (B, n, n) residuals (JAX package :258),
    the 14-bit high-precision matrices, exact in int64."""
    n = residuals.shape[-1]
    log2n = n.bit_length() - 1
    t = (DST4_FWD if use_dst
         else np.asarray(dct_matrix(n, True), np.int32)).astype(np.int64)
    shift1 = log2n + bit_depth + FWD_MATRIX_SHIFT - MAX_TR_DYNAMIC_RANGE
    shift2 = log2n + FWD_MATRIX_SHIFT
    add1 = (1 << (shift1 - 1)) if shift1 > 0 else 0
    add2 = 1 << (shift2 - 1)
    r = residuals.astype(np.int64)
    a = (np.einsum("bin,kn->bik", r, t) + add1) >> shift1
    return ((np.einsum("ki,bil->bkl", t, a) + add2) >> shift2).astype(np.int32)


def inverse_transform_np(coeffs: np.ndarray, *, use_dst: bool = False,
                         bit_depth: int = BIT_DEPTH) -> np.ndarray:
    """Numpy twin of `inverse_transform` (int64, on the host)."""
    n = coeffs.shape[-1]
    t = (DST4 if use_dst else np.asarray(dct_matrix(n), np.int32)).astype(np.int64)
    shift1 = TRANSFORM_MATRIX_SHIFT + 1
    shift2 = (TRANSFORM_MATRIX_SHIFT + MAX_TR_DYNAMIC_RANGE - 1) - bit_depth
    add1 = 1 << (shift1 - 1)
    add2 = (1 << (shift2 - 1)) if shift2 > 0 else 0
    lo, hi = -(1 << MAX_TR_DYNAMIC_RANGE), (1 << MAX_TR_DYNAMIC_RANGE) - 1
    c = coeffs.astype(np.int64)
    e = np.clip((np.einsum("ki,bkl->bil", t, c) + add1) >> shift1, lo, hi)
    r = (np.einsum("bik,kn->bin", e, t) + add2) >> shift2
    return np.clip(r, -32768, 32767).astype(np.int32)


def quantize_np(coeffs: np.ndarray, qp: int, *, is_intra_slice: bool = True,
                bit_depth: int = BIT_DEPTH) -> np.ndarray:
    """HM's scalar quantiser (no RDOQ) of (B, n, n) coefficients (JAX
    package :290)."""
    n = coeffs.shape[-1]
    log2n = n.bit_length() - 1
    per, rem = qp // 6, qp % 6
    qbits = QUANT_SHIFT + per + transform_shift(log2n, bit_depth)
    add = (171 if is_intra_slice else 85) << (qbits - 9)
    c = coeffs.astype(np.int64)
    q = np.sign(c) * ((np.abs(c) * QUANT_SCALES[rem] + add) >> qbits)
    lo, hi = -(1 << MAX_TR_DYNAMIC_RANGE), (1 << MAX_TR_DYNAMIC_RANGE) - 1
    return np.clip(q, lo, hi).astype(np.int32)


def dequantize_np(qcoeffs: np.ndarray, qp: int, *, bit_depth: int = BIT_DEPTH) -> np.ndarray:
    """Numpy twin of `dequantize` (int64, on the host)."""
    n = qcoeffs.shape[-1]
    log2n = n.bit_length() - 1
    per, rem = qp // 6, qp % 6
    right_shift = IQUANT_SHIFT - (transform_shift(log2n, bit_depth) + per)
    scale = INV_QUANT_SCALES[rem]
    q = qcoeffs.astype(np.int64)
    if right_shift > 0:
        c = (q * scale + (1 << (right_shift - 1))) >> right_shift
    else:
        c = (q * scale) << (-right_shift)
    lo, hi = -(1 << MAX_TR_DYNAMIC_RANGE), (1 << MAX_TR_DYNAMIC_RANGE) - 1
    return np.clip(c, lo, hi).astype(np.int32)


# ------------------------------------------------ batched, on a device --

def _product(a, b):
    """Exact integer matrix product through float64 (CUDA has no int64
    product; every sum of products here stays far below 2^53); int64
    out."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int64)


def _as_int64(x, device) -> torch.Tensor:
    """(B, n, n) integers as an int64 tensor: a tensor stays on its device,
    a numpy array goes to `device`."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x)).to(torch.device(device))
    return x.to(torch.int64)


@functools.lru_cache(maxsize=None)
def _matrix_on(n: int, use_dst: bool, forward: bool, device: str):
    """The transform matrix (int64) on `device`: the 14-bit forward or the
    6-bit inverse, DST-VII 4x4 or DCT-II."""
    if forward:
        t = DST4_FWD if use_dst else dct_matrix(n, True)
    else:
        t = DST4 if use_dst else dct_matrix(n)
    return torch.from_numpy(np.asarray(t, np.int64)).to(device)


def _check_dst(n: int, use_dst: bool):
    if use_dst and n != 4:
        raise ValueError("DST only applies to 4x4 TUs.")


def forward_transform(residuals, *, use_dst: bool = False,
                      bit_depth: int = BIT_DEPTH, device="cuda"):
    """HM's forward transform of (B, n, n) integer residuals -> (B, n, n)
    int32 coefficients on the residuals' device (the JAX package's :193),
    with the 14-bit high-precision matrices; `use_dst` selects the DST-VII
    (HM: luma intra 4x4 TUs only; other sizes raise).

    Exact (equal to `forward_transform_np`) over HM's 16-bit residual
    range [-32768, 32767].  The JAX package's version sums in int32 and
    agrees where its sums fit: |r| < 2^(17 - log2 n) (32768, 16384, 8192,
    4096 for n = 4 ... 32), which holds every residual of 8-bit video;
    beyond it the JAX package's sums wrap."""
    n = residuals.shape[-1]
    _check_dst(n, use_dst)
    r = _as_int64(residuals, device)
    t = _matrix_on(n, use_dst, True, str(r.device))
    log2n = n.bit_length() - 1
    shift1 = log2n + bit_depth + FWD_MATRIX_SHIFT - MAX_TR_DYNAMIC_RANGE
    shift2 = log2n + FWD_MATRIX_SHIFT
    add1 = (1 << (shift1 - 1)) if shift1 > 0 else 0
    # A[b, i, k] = sum_n R[b, i, n] T[k, n]; C[b, k, l] = sum_i T[k, i] A[b, i, l].
    a = (_product(r, t.T) + add1) >> shift1
    c = (_product(t, a) + (1 << (shift2 - 1))) >> shift2
    return c.to(torch.int32)


def inverse_transform(coeffs, *, use_dst: bool = False,
                      bit_depth: int = BIT_DEPTH, device="cuda"):
    """HM's inverse transform of (B, n, n) integer coefficients -> (B, n, n)
    int32 residuals on the coefficients' device (the JAX package's :204):
    the first stage clipped to 16 bits, the result to HM's Pel range.

    Exact, and equal to the JAX package's int32 version and to
    `inverse_transform_np`, over HM's 16-bit coefficient range
    [-32768, 32767] (every sum below 2^27)."""
    n = coeffs.shape[-1]
    _check_dst(n, use_dst)
    c = _as_int64(coeffs, device)
    t = _matrix_on(n, use_dst, False, str(c.device))
    shift1 = TRANSFORM_MATRIX_SHIFT + 1
    shift2 = (TRANSFORM_MATRIX_SHIFT + MAX_TR_DYNAMIC_RANGE - 1) - bit_depth
    add2 = (1 << (shift2 - 1)) if shift2 > 0 else 0
    lo, hi = -(1 << MAX_TR_DYNAMIC_RANGE), (1 << MAX_TR_DYNAMIC_RANGE) - 1
    # E[b, i, l] = sum_k T[k, i] C[b, k, l]; R[b, i, n] = sum_k E[b, i, k] T[k, n].
    e = torch.clamp((_product(t.T, c) + (1 << (shift1 - 1))) >> shift1,
                    lo, hi)
    r = (_product(e, t) + add2) >> shift2
    return torch.clamp(r, -32768, 32767).to(torch.int32)


def quantize(coeffs, qp: int, *, is_intra_slice: bool = True,
             bit_depth: int = BIT_DEPTH, device="cuda"):
    """HM's scalar quantiser (no RDOQ) of (B, n, n) integer coefficients ->
    int32 levels clipped to 16 bits, on the coefficients' device (the JAX
    package's :322).  Computed in int64: equal to `quantize_np` for any
    int32 input, and to the JAX package's int32 version over HM's 16-bit
    coefficient range [-32768, 32767]."""
    n = coeffs.shape[-1]
    log2n = n.bit_length() - 1
    per, rem = qp // 6, qp % 6
    qbits = QUANT_SHIFT + per + transform_shift(log2n, bit_depth)
    add = (171 if is_intra_slice else 85) << (qbits - 9)
    c = _as_int64(coeffs, device)
    q = torch.sign(c) * ((c.abs() * QUANT_SCALES[rem] + add) >> qbits)
    lo, hi = -(1 << MAX_TR_DYNAMIC_RANGE), (1 << MAX_TR_DYNAMIC_RANGE) - 1
    return torch.clamp(q, lo, hi).to(torch.int32)


def dequantize(qcoeffs, qp: int, *, bit_depth: int = BIT_DEPTH,
               device="cuda"):
    """HM's dequantiser of (B, n, n) integer levels -> int32 coefficients
    clipped to 16 bits, on the levels' device (the JAX package's :327).
    Computed in int64: equal to `dequantize_np`, and to the JAX package's
    int32 version over HM's 16-bit level range [-32768, 32767]."""
    n = qcoeffs.shape[-1]
    log2n = n.bit_length() - 1
    per, rem = qp // 6, qp % 6
    right_shift = IQUANT_SHIFT - (transform_shift(log2n, bit_depth) + per)
    scale = INV_QUANT_SCALES[rem]
    q = _as_int64(qcoeffs, device)
    if right_shift > 0:
        c = (q * scale + (1 << (right_shift - 1))) >> right_shift
    else:
        c = (q * scale) << (-right_shift)
    lo, hi = -(1 << MAX_TR_DYNAMIC_RANGE), (1 << MAX_TR_DYNAMIC_RANGE) - 1
    return torch.clamp(c, lo, hi).to(torch.int32)
