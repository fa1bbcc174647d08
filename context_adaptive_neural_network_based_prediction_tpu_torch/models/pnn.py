"""The two constants of the JAX package's `models/pnn.py` that the
integer PNN forward needs: the LeakyReLU slope and TF-SAME padding."""

from __future__ import annotations

LEAKY_SLOPE = 0.1


def _tf_same_pads(in_size: int, stride: int, kernel: int):
    """TF 'SAME' padding (beg, end) for one spatial dim."""
    out_size = -(-in_size // stride)
    pad_total = max((out_size - 1) * stride + kernel - in_size, 0)
    beg = pad_total // 2
    return beg, pad_total - beg
