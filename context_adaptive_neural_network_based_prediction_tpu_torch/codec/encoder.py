"""Encode records and the framework container header.

The port's copy of the parts of the JAX package's `codec/encoder.py` that
the wavefront encoder returns and the port's decoder reads: the decided
CU-tree records, `EncodeResult`, `stream_header` (the header the native
packer's payload follows), the structure constants and the switch
policy's MPM rule.  The stream format is the JAX package's, so its decoder
reads the port's streams and the port's decoder reads its streams.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from . import syntax

MAGIC = b"CPNN"
VERSION = 6
POLICIES = ("regular", "substitution", "switch")
PNNS_MODE = 35
MIN_CU = 8
MAX_TU = 32


@dataclass
class TuRecord:
    x: int
    y: int
    n: int
    cbf: int
    coeffs: Optional[np.ndarray]
    tskip: int = 0


@dataclass
class PuRecord:
    x: int
    y: int
    n: int
    mode: int
    tus: List[TuRecord] = field(default_factory=list)


@dataclass
class CuNode:
    x: int
    y: int
    size: int
    depth: int
    split: bool
    part_nxn: bool = False
    pus: List[PuRecord] = field(default_factory=list)
    children: list = field(default_factory=list)


@dataclass
class EncodeResult:
    bitstream: bytes
    reconstruction: np.ndarray
    num_bits: int
    ctu_trees: List[CuNode]
    mode_map: np.ndarray  # per 4x4 unit: chosen luma mode (-1 outside)
    qp: int
    policy: str


def stream_header(*, width: int, height: int, qp: int, policy: str,
                  ctu_size: int, sign_hiding: bool, deblocking: bool = False,
                  max_tu_depth: int = 0, has_sao: bool = False,
                  transform_skip: bool = False) -> bytes:
    """The framework container header (shared by Python + native packers)."""
    return struct.pack("<4sBBBBBBBBBII", MAGIC, VERSION,
                       POLICIES.index(policy), qp, 1 if sign_hiding else 0,
                       1 if deblocking else 0, max_tu_depth,
                       1 if has_sao else 0, 1 if transform_skip else 0,
                       ctu_size, width, height)


def mpms_switch(left: int, above: int):
    """hm_16_15_switch MPM rules (TComDataCU.cpp:1475-1596; the JAX
    package's `FrameEncoder._mpms_switch`)."""
    if left == above:
        if 1 < left < PNNS_MODE:
            return [left, ((left + 29) % 32) + 2, ((left - 1) % 32) + 2]
        return [syntax.PLANAR_IDX, syntax.DC_IDX, syntax.VER_IDX]
    if left == PNNS_MODE or above == PNNS_MODE:
        m0 = above if left == PNNS_MODE else left
        if m0 > 1:
            return [m0, syntax.PLANAR_IDX, syntax.DC_IDX]
        if m0 == syntax.DC_IDX:
            return [syntax.DC_IDX, syntax.PLANAR_IDX, syntax.VER_IDX]
        return [syntax.PLANAR_IDX, syntax.DC_IDX, syntax.VER_IDX]
    return syntax.mpm_candidates(left, above)
