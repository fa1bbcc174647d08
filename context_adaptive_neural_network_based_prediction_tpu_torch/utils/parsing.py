"""Typed argparse validators, usable as `type=` callbacks.

The port's copy of the JAX package's `utils/parsing.py` (:10-51).
"""

from __future__ import annotations

import argparse


def float_positive(string: str) -> float:
    value = float(string)
    if value < 0.0:
        raise argparse.ArgumentTypeError(f"{value} is not positive.")
    return value


def float_strictly_positive(string: str) -> float:
    value = float(string)
    if value <= 0.0:
        raise argparse.ArgumentTypeError(
            f"{value} is not strictly positive.")
    return value


def int_positive(string: str) -> int:
    value = int(string)
    if value < 0:
        raise argparse.ArgumentTypeError(f"{value} is not positive.")
    return value


def int_strictly_positive(string: str) -> int:
    value = int(string)
    if value <= 0:
        raise argparse.ArgumentTypeError(
            f"{value} is not strictly positive.")
    return value


def tuple_two_positive_integers(string: str):
    """Parses "w,h" into a tuple of two non-negative integers."""
    parts = string.split(",")
    if len(parts) != 2:
        raise argparse.ArgumentTypeError(
            f'"{string}" does not contain exactly two integers.')
    values = []
    for part in parts:
        v = int(part)
        if v < 0:
            raise argparse.ArgumentTypeError(f"{v} is not positive.")
        values.append(v)
    return tuple(values)
