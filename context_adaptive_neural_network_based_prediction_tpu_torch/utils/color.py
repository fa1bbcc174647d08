"""ITU-T T.871 (JFIF) RGB -> YCbCr conversion (numpy, on the host).

The port's copy of `rgb_to_ycbcr` (:30) and `cast_float_to_uint8` of the
JAX package's `utils/color.py`: full range, [0, 255] RGB to [0, 255]
Y/Cb/Cr.
"""

from __future__ import annotations

import numpy as np


def cast_float_to_uint8(x):
    """Rounds to nearest and saturates to [0, 255]."""
    return np.clip(np.round(x), 0.0, 255.0).astype(np.uint8)


def rgb_to_ycbcr(rgb_uint8):
    """Converts an RGB image (H, W, 3) uint8 to YCbCr uint8 per ITU-T T.871:
      Y  =  0.299 R + 0.587 G + 0.114 B
      Cb = 128 - (0.299/1.772) R - (0.587/1.772) G + (0.886/1.772) B
      Cr = 128 + (0.701/1.402) R - (0.587/1.402) G - (0.114/1.402) B
    """
    if rgb_uint8.dtype != np.uint8:
        raise TypeError("`rgb_uint8.dtype` is not uint8.")
    if rgb_uint8.ndim != 3 or rgb_uint8.shape[2] != 3:
        raise ValueError("`rgb_uint8` must have shape (H, W, 3).")
    rgb = rgb_uint8.astype(np.float64)
    r, g, b = rgb[:, :, 0], rgb[:, :, 1], rgb[:, :, 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - (0.299 / 1.772) * r - (0.587 / 1.772) * g \
        + (0.886 / 1.772) * b
    cr = 128.0 + (0.701 / 1.402) * r - (0.587 / 1.402) * g \
        - (0.114 / 1.402) * b
    return cast_float_to_uint8(np.stack((y, cb, cr), axis=2))
