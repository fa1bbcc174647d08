"""Quality and rate metrics: PSNR and the Bjontegaard delta rate (numpy,
on the host).

The port's copy of the JAX package's `utils/metrics.py` (`compute_psnr`
:15, `compute_psnr_batch` :25, `compute_bjontegaard` :34): PSNR is
10 log10(255^2 / (MSE + 1e-6)), in float64; the Bjontegaard delta fits a
cubic to (PSNR, log rate) of each curve and integrates both over their
common PSNR range, giving curve 1's average bitrate change against
curve 0 in percent.
"""

from __future__ import annotations

import numpy as np


def compute_psnr(array_0_uint8, array_1_uint8) -> np.float64:
    """PSNR in dB between two uint8 arrays of identical shape."""
    a0 = np.asarray(array_0_uint8)
    a1 = np.asarray(array_1_uint8)
    if a0.dtype != np.uint8 or a1.dtype != np.uint8:
        raise TypeError("inputs must be uint8 arrays")
    mse = np.mean((a0.astype(np.float64) - a1.astype(np.float64)) ** 2)
    return 10.0 * np.log10(255.0 ** 2 / (mse + 1.0e-6))


def compute_psnr_batch(a0_uint8, a1_uint8) -> np.ndarray:
    """Per-example PSNR for batched uint8 arrays (N, ...) -> (N,) float64."""
    a0 = np.asarray(a0_uint8).astype(np.float64)
    a1 = np.asarray(a1_uint8).astype(np.float64)
    axes = tuple(range(1, a0.ndim))
    mse = np.mean((a0 - a1) ** 2, axis=axes)
    return 10.0 * np.log10(255.0 ** 2 / (mse + 1.0e-6))


def compute_bjontegaard(rates_0, psnrs_0, rates_1, psnrs_1) -> float:
    """Average percent bitrate saving of curve 1 vs curve 0 (negative = saving).

    Cubic fit of log(rate) as a function of PSNR for each curve, integrated over
    the PSNR interval where both curves are defined.
    """
    rates_0 = np.asarray(rates_0, dtype=np.float64)
    rates_1 = np.asarray(rates_1, dtype=np.float64)
    psnrs_0 = np.asarray(psnrs_0, dtype=np.float64)
    psnrs_1 = np.asarray(psnrs_1, dtype=np.float64)
    if rates_0.ndim != 1 or rates_1.ndim != 1:
        raise ValueError("rates must be 1D arrays")
    if psnrs_0.shape != rates_0.shape or psnrs_1.shape != rates_1.shape:
        raise ValueError("psnrs must match rates in shape")
    for arr, name in ((rates_0, "rates_0"), (rates_1, "rates_1"),
                      (psnrs_0, "psnrs_0"), (psnrs_1, "psnrs_1")):
        if not np.all(arr > 0.0):
            raise ValueError(f"an element of `{name}` is not strictly positive")

    log_rates_0 = np.log(rates_0)
    log_rates_1 = np.log(rates_1)
    poly_0 = np.polyfit(psnrs_0, log_rates_0, 3)
    poly_1 = np.polyfit(psnrs_1, log_rates_1, 3)
    lo = max(psnrs_0.min(), psnrs_1.min())
    hi = min(psnrs_0.max(), psnrs_1.max())
    anti_0 = np.polyint(poly_0)
    anti_1 = np.polyint(poly_1)
    int_0 = np.polyval(anti_0, hi) - np.polyval(anti_0, lo)
    int_1 = np.polyval(anti_1, hi) - np.polyval(anti_1, lo)
    return 100.0 * (np.exp((int_1 - int_0) / (hi - lo)).item() - 1.0)
