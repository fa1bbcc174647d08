"""Prediction quality: PSNR (numpy, on the host).

The port's copy of `compute_psnr` (:15) and `compute_psnr_batch` (:25) of
the JAX package's `utils/metrics.py`: PSNR is 10 log10(255^2 / (MSE +
1e-6)), in float64.
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
