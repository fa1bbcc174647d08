"""ITU-T T.871 (JFIF) colour conversion between RGB and YCbCr.

The port of the JAX package's `utils/color.py`: full range, [0, 255] RGB
to [0, 255] Y/Cb/Cr and back, in float64, rounded to nearest (half to
even) and saturated.  `rgb_to_ycbcr` (:30) and `cast_float_to_uint8` run
in numpy on the host; `ycbcr_to_rgb` (:52) takes a numpy array or a uint8
tensor, which it converts on the tensor's device.
"""

from __future__ import annotations

import numpy as np
import torch


def cast_float_to_uint8(x):
    """Rounds to nearest and saturates to [0, 255]."""
    return np.clip(np.round(x), 0.0, 255.0).astype(np.uint8)


def _check_image(img, uint8, name: str):
    if img.dtype != uint8:
        raise TypeError(f"`{name}.dtype` is not uint8.")
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"`{name}` must have shape (H, W, 3).")


def rgb_to_ycbcr(rgb_uint8):
    """Converts an RGB image (H, W, 3) uint8 to YCbCr uint8 per ITU-T T.871:
      Y  =  0.299 R + 0.587 G + 0.114 B
      Cb = 128 - (0.299/1.772) R - (0.587/1.772) G + (0.886/1.772) B
      Cr = 128 + (0.701/1.402) R - (0.587/1.402) G - (0.114/1.402) B
    """
    _check_image(rgb_uint8, np.uint8, "rgb_uint8")
    rgb = rgb_uint8.astype(np.float64)
    r, g, b = rgb[:, :, 0], rgb[:, :, 1], rgb[:, :, 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - (0.299 / 1.772) * r - (0.587 / 1.772) * g \
        + (0.886 / 1.772) * b
    cr = 128.0 + (0.701 / 1.402) * r - (0.587 / 1.402) * g \
        - (0.114 / 1.402) * b
    return cast_float_to_uint8(np.stack((y, cb, cr), axis=2))


def ycbcr_to_rgb(ycbcr_uint8):
    """Converts a YCbCr image (H, W, 3) uint8 to RGB uint8 per ITU-T T.871,
    the inverse of `rgb_to_ycbcr`:
      R = Y + 1.402 (Cr - 128)
      G = Y - (0.114 1.772 / 0.587) (Cb - 128)
            - (0.299 1.402 / 0.587) (Cr - 128)
      B = Y + 1.772 (Cb - 128)
    A numpy array gives a numpy array; a uint8 tensor gives a tensor on
    its device (each float64 operation on its own, in the same order, so
    both give the same bytes)."""
    if isinstance(ycbcr_uint8, torch.Tensor):
        _check_image(ycbcr_uint8, torch.uint8, "ycbcr_uint8")
        ycbcr = ycbcr_uint8.to(torch.float64)
    else:
        _check_image(ycbcr_uint8, np.uint8, "ycbcr_uint8")
        ycbcr = ycbcr_uint8.astype(np.float64)
    y, cb, cr = ycbcr[:, :, 0], ycbcr[:, :, 1], ycbcr[:, :, 2]
    r = y + 1.402 * (cr - 128.0)
    g = y - (0.114 * 1.772 / 0.587) * (cb - 128.0) \
        - (0.299 * 1.402 / 0.587) * (cr - 128.0)
    b = y + 1.772 * (cb - 128.0)
    if isinstance(ycbcr, torch.Tensor):
        rgb = torch.stack((r, g, b), dim=2)
        return torch.clamp(torch.round(rgb), 0.0, 255.0).to(torch.uint8)
    return cast_float_to_uint8(np.stack((r, g, b), axis=2))
