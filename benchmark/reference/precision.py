"""The precisions in which the reference's integer contractions run: the
exact one, and the lower ones of the control.

The codec's contractions are sums of products of integers.  "float64"
holds them exactly.  The lower precisions are what the control puts in
the program's place: "float32" (products and sums in float32, TF32 off:
sums past 2^24 round), "tf32" (operands rounded to TF32's 10-bit
mantissa, to nearest with ties away from zero, as the card's TF32 tensor
cores read them; products and sums in float32) and "bfloat16" (operands
rounded to 8 significant bits; sums in float32).  The rounding is done
here, in plain tensor operations, so every precision reads the same on
the CPU and on the card.
"""

from __future__ import annotations

import torch

PRECISIONS = ("float64", "float32", "tf32", "bfloat16")


def operands(x: torch.Tensor, precision: str) -> torch.Tensor:
    """`x` as a contraction's operand in `precision`: float64 for
    "float64", else float32 holding the operand's rounded value."""
    if precision == "float64":
        return x.to(torch.float64)
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r} "
                         f"(have {PRECISIONS})")
    x = x.to(torch.float32)
    if precision == "tf32":
        # Sign and magnitude: adding half of the last kept place to the
        # magnitude bits and clearing the 13 dropped bits rounds the
        # magnitude to nearest, ties away from zero.
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    if precision == "bfloat16":
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b of integer-valued tensors in `precision`, int64 out.  Float32
    products run with TF32 off, so "float32" is float32 on the card."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(operands(a, precision),
                            operands(b, precision)).to(torch.int64)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
