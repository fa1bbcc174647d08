"""HEVC Annex-B writing: NAL types, emulation prevention, the bit writer
(u(n), ue(v), se(v)), profile_tier_level and the picture checksum.

The port's copy of the writer half of the JAX package's
`codec/hm_bitstream.py` (:27-72, :156-195, :234-245, :529-535), for the
HM-syntax writer `hm_encoder.py`; field order follows Rec. ITU-T H.265 as
HM-16.15's `TEncCavlc` emits it.  The parser half goes with the HM-syntax
decoder, which the port does not have.
"""

from __future__ import annotations

from typing import List

import numpy as np

NAL_TRAIL_R = 1
NAL_IDR_W_RADL = 19
NAL_IDR_N_LP = 20
NAL_CRA = 21
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34
NAL_AUD = 35
NAL_PREFIX_SEI = 39
NAL_SUFFIX_SEI = 40


def insert_emulation_prevention(rbsp: bytes) -> bytes:
    """Inserts emulation_prevention_three_byte where 00 00 0x(0..3) occurs."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


class BitWriter:
    def __init__(self):
        self.bits: List[int] = []

    def u(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def flag(self, v: int):
        self.u(1 if v else 0, 1)

    def ue(self, value: int):
        value += 1
        n = value.bit_length()
        self.u(0, n - 1)
        self.u(value, n)

    def se(self, value: int):
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    def rbsp_trailing(self):
        self.u(1, 1)
        while len(self.bits) & 7:
            self.u(0, 1)

    def byte_align_zero(self):
        while len(self.bits) & 7:
            self.u(0, 1)

    def to_bytes(self) -> bytes:
        if len(self.bits) % 8:
            raise ValueError(f"{len(self.bits)} bits: not byte-aligned")
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            b = 0
            for bit in self.bits[i:i + 8]:
                b = (b << 1) | bit
            out.append(b)
        return bytes(out)


def _write_ptl(w: BitWriter, profile_idc: int, level_idc: int,
               compat: int, constraint_bits: int = 0):
    """profile_tier_level with no sub-layers (12 bytes)."""
    w.u(0, 2)             # profile_space
    w.flag(0)             # tier
    w.u(profile_idc, 5)
    w.u(compat, 32)
    w.flag(1)             # progressive_source
    w.flag(0)             # interlaced_source
    w.flag(0)             # non_packed
    w.flag(1)             # frame_only
    w.u(constraint_bits, 44)  # profile-specific constraint flags + inbld
    w.u(level_idc, 8)


def picture_checksum(plane: np.ndarray) -> int:
    """Rec. H.265 (D.3.19) picture checksum of one 8-bit plane."""
    h, w = plane.shape
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    xor_mask = ((xx & 0xFF) ^ ((xx >> 8) & 0xFF) ^ (yy & 0xFF)
                ^ ((yy >> 8) & 0xFF))
    return int(np.sum(plane.astype(np.uint32) ^ xor_mask).astype(np.uint32)
               & np.uint32(0xFFFFFFFF))
