"""HEVC CABAC tables, context initialisation and the encoding engine
(HM-16.15 `TEncBinCoderCABAC.cpp`, `ContextModel.cpp`).

A frozen copy of the port's `codec/cabac.py` as the benchmark's plain
reference uses it (only the parts it needs; nothing of the port is
imported).
"""

from __future__ import annotations

import numpy as np


# LPS range table: [pStateIdx 0..63][ (range >> 6) & 3 ].
LPS_TABLE = np.array([
    [128, 176, 208, 240], [128, 167, 197, 227], [128, 158, 187, 216],
    [123, 150, 178, 205], [116, 142, 169, 195], [111, 135, 160, 185],
    [105, 128, 152, 175], [100, 122, 144, 166], [95, 116, 137, 158],
    [90, 110, 130, 150], [85, 104, 123, 142], [81, 99, 117, 135],
    [77, 94, 111, 128], [73, 89, 105, 122], [69, 85, 100, 116],
    [66, 80, 95, 110], [62, 76, 90, 104], [59, 72, 86, 99],
    [56, 69, 81, 94], [53, 65, 77, 89], [51, 62, 73, 85],
    [48, 59, 69, 80], [46, 56, 66, 76], [43, 53, 63, 72],
    [41, 50, 59, 69], [39, 48, 56, 65], [37, 45, 54, 62],
    [35, 43, 51, 59], [33, 41, 48, 56], [32, 39, 46, 53],
    [30, 37, 43, 50], [29, 35, 41, 48], [27, 33, 39, 45],
    [26, 31, 37, 43], [24, 30, 35, 41], [23, 28, 33, 39],
    [22, 27, 32, 37], [21, 26, 30, 35], [20, 24, 29, 33],
    [19, 23, 27, 31], [18, 22, 26, 30], [17, 21, 25, 28],
    [16, 20, 23, 27], [15, 19, 22, 25], [14, 18, 21, 24],
    [14, 17, 20, 23], [13, 16, 19, 22], [12, 15, 18, 21],
    [12, 14, 17, 20], [11, 14, 16, 19], [11, 13, 15, 18],
    [10, 12, 15, 17], [10, 12, 14, 16], [9, 11, 13, 15],
    [9, 11, 12, 14], [8, 10, 12, 14], [8, 9, 11, 13],
    [7, 9, 11, 12], [7, 9, 10, 12], [7, 8, 10, 11],
    [6, 8, 9, 11], [6, 7, 9, 10], [6, 7, 8, 9], [2, 2, 2, 2],
], dtype=np.int32)


RENORM_TABLE = np.array(
    [6, 5, 4, 4, 3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 2, 2,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1], dtype=np.int32)


# State transitions in HM's 7-bit encoding (state = (pStateIdx << 1) | MPS).
NEXT_STATE_MPS = np.array([
    2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
    18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33,
    34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49,
    50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65,
    66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81,
    82, 83, 84, 85, 86, 87, 88, 89, 90, 91, 92, 93, 94, 95, 96, 97,
    98, 99, 100, 101, 102, 103, 104, 105, 106, 107, 108, 109, 110, 111, 112, 113,
    114, 115, 116, 117, 118, 119, 120, 121, 122, 123, 124, 125, 124, 125, 126, 127,
], dtype=np.int32)


NEXT_STATE_LPS = np.array([
    1, 0, 0, 1, 2, 3, 4, 5, 4, 5, 8, 9, 8, 9, 10, 11,
    12, 13, 14, 15, 16, 17, 18, 19, 18, 19, 22, 23, 22, 23, 24, 25,
    26, 27, 26, 27, 30, 31, 30, 31, 32, 33, 32, 33, 36, 37, 36, 37,
    38, 39, 38, 39, 42, 43, 42, 43, 44, 45, 44, 45, 46, 47, 48, 49,
    48, 49, 50, 51, 52, 53, 52, 53, 54, 55, 54, 55, 56, 57, 58, 59,
    58, 59, 60, 61, 60, 61, 60, 61, 62, 63, 64, 65, 64, 65, 66, 67,
    66, 67, 66, 67, 68, 69, 68, 69, 70, 71, 70, 71, 70, 71, 72, 73,
    72, 73, 72, 73, 74, 75, 74, 75, 74, 75, 76, 77, 76, 77, 126, 127,
], dtype=np.int32)


# Fractional bits (15-bit fixed point) spent coding a bin in a given state,
# indexed by (state ^ bin is-LPS layout): entry s is the cost of coding the
# symbol whose value makes the engine take path (s & 1).  HM FAST_BIT_EST.
ENTROPY_BITS = np.array([
    0x07b23, 0x085f9, 0x074a0, 0x08cbc, 0x06ee4, 0x09354, 0x067f4, 0x09c1b,
    0x060b0, 0x0a62a, 0x05a9c, 0x0af5b, 0x0548d, 0x0b955, 0x04f56, 0x0c2a9,
    0x04a87, 0x0cbf7, 0x045d6, 0x0d5c3, 0x04144, 0x0e01b, 0x03d88, 0x0e937,
    0x039e0, 0x0f2cd, 0x03663, 0x0fc9e, 0x03347, 0x10600, 0x03050, 0x10f95,
    0x02d4d, 0x11a02, 0x02ad3, 0x12333, 0x0286e, 0x12cad, 0x02604, 0x136df,
    0x02425, 0x13f48, 0x021f4, 0x149c4, 0x0203e, 0x1527b, 0x01e4d, 0x15d00,
    0x01c99, 0x166de, 0x01b18, 0x17017, 0x019a5, 0x17988, 0x01841, 0x18327,
    0x016df, 0x18d50, 0x015d9, 0x19547, 0x0147c, 0x1a083, 0x0138e, 0x1a8a3,
    0x01251, 0x1b418, 0x01166, 0x1bd27, 0x01068, 0x1c77b, 0x00f7f, 0x1d18e,
    0x00eda, 0x1d91a, 0x00e19, 0x1e254, 0x00d4f, 0x1ec9a, 0x00c90, 0x1f6e0,
    0x00c01, 0x1fef8, 0x00b5f, 0x208b1, 0x00ab6, 0x21362, 0x00a15, 0x21e46,
    0x00988, 0x2285d, 0x00934, 0x22ea8, 0x008a8, 0x239b2, 0x0081d, 0x24577,
    0x007c9, 0x24ce6, 0x00763, 0x25663, 0x00710, 0x25e8f, 0x006a0, 0x26a26,
    0x00672, 0x26f23, 0x005e8, 0x27ef8, 0x005ba, 0x284b5, 0x0055e, 0x29057,
    0x0050c, 0x29bab, 0x004c1, 0x2a674, 0x004a7, 0x2aa5e, 0x0046f, 0x2b32f,
    0x0041f, 0x2c0ad, 0x003e7, 0x2ca8d, 0x003ba, 0x2d323, 0x0010c, 0x3bfbb,
], dtype=np.int64)


def init_context_state(qp: int, init_value: int) -> int:
    """HEVC context init (ContextModel::init): returns the 7-bit engine state."""
    qp = min(max(qp, 0), 51)
    slope = (init_value >> 4) * 5 - 45
    offset = ((init_value & 15) << 3) - 16
    init_state = min(max(1, ((slope * qp) >> 4) + offset), 126)
    mps = 1 if init_state >= 64 else 0
    return (((init_state - 64) if mps else (63 - init_state)) << 1) + mps


def init_contexts(qp: int, init_values) -> np.ndarray:
    return np.array([init_context_state(qp, v) for v in init_values], dtype=np.int32)


# Python-list copies of the tables for the decoder's per-bin lookups.
_LPS = LPS_TABLE.tolist()


_RENORM = RENORM_TABLE.tolist()


_NEXT_MPS = NEXT_STATE_MPS.tolist()


_NEXT_LPS = NEXT_STATE_LPS.tolist()


class CabacEncoder:
    """HM TEncBinCABAC with an in-memory byte FIFO.  `ctx` is the context
    state array (numpy or a list), updated in place."""

    def __init__(self):
        self.bytes = bytearray()
        self._partial_bits = 0
        self._partial_count = 0
        self.start()

    def start(self):
        self.low = 0
        self.range = 510
        self.bits_left = 23
        self.num_buffered_bytes = 0
        self.buffered_byte = 0xFF

    # -- engine ------------------------------------------------------------

    def encode_bin(self, bin_value: int, ctx, idx: int):
        state = int(ctx[idx])
        lps = _LPS[state >> 1][(self.range >> 6) & 3]
        self.range -= lps
        if bin_value != (state & 1):
            num_bits = _RENORM[lps >> 3]
            self.low = (self.low + self.range) << num_bits
            self.range = lps << num_bits
            ctx[idx] = _NEXT_LPS[state]
            self.bits_left -= num_bits
        else:
            ctx[idx] = _NEXT_MPS[state]
            if self.range >= 256:
                return
            self.low <<= 1
            self.range <<= 1
            self.bits_left -= 1
        self._test_and_write_out()

    def encode_bin_ep(self, bin_value: int):
        self.low <<= 1
        if bin_value:
            self.low += self.range
        self.bits_left -= 1
        self._test_and_write_out()

    def encode_bins_ep(self, bin_values: int, num_bins: int):
        while num_bins > 8:
            num_bins -= 8
            pattern = bin_values >> num_bins
            self.low = (self.low << 8) + self.range * pattern
            bin_values -= pattern << num_bins
            self.bits_left -= 8
            self._test_and_write_out()
        self.low = (self.low << num_bins) + self.range * bin_values
        self.bits_left -= num_bins
        self._test_and_write_out()

    def encode_bin_trm(self, bin_value: int):
        self.range -= 2
        if bin_value:
            self.low += self.range
            self.low <<= 7
            self.range = 2 << 7
            self.bits_left -= 7
        elif self.range >= 256:
            return
        else:
            self.low <<= 1
            self.range <<= 1
            self.bits_left -= 1
        self._test_and_write_out()

    def finish(self) -> bytes:
        if self.low >> (32 - self.bits_left):
            self.bytes.append((self.buffered_byte + 1) & 0xFF)
            while self.num_buffered_bytes > 1:
                self.bytes.append(0x00)
                self.num_buffered_bytes -= 1
            self.low -= 1 << (32 - self.bits_left)
        else:
            if self.num_buffered_bytes > 0:
                self.bytes.append(self.buffered_byte)
            while self.num_buffered_bytes > 1:
                self.bytes.append(0xFF)
                self.num_buffered_bytes -= 1
        # The remaining (24 - bits_left) bits of low, MSB first.
        self._write_raw_bits(self.low >> 8, 24 - self.bits_left)
        return bytes(self.bytes)

    def terminate_and_finish(self) -> bytes:
        """encodeBinTrm(1) + finish + stop bit + byte align (HM flush)."""
        self.encode_bin_trm(1)
        self.finish()
        self._write_raw_bits(1, 1)
        while self._partial_count:
            self._write_raw_bits(0, 1)
        return bytes(self.bytes)

    # -- internals ---------------------------------------------------------

    def _write_raw_bits(self, value: int, n_bits: int):
        """Bit-level writes, only after finish() (the bitstream tail)."""
        for i in range(n_bits - 1, -1, -1):
            self._partial_bits = (self._partial_bits << 1) | ((value >> i)
                                                              & 1)
            self._partial_count += 1
            if self._partial_count == 8:
                self.bytes.append(self._partial_bits)
                self._partial_bits = 0
                self._partial_count = 0

    def _test_and_write_out(self):
        if self.bits_left < 12:
            lead_byte = self.low >> (24 - self.bits_left)
            self.bits_left += 8
            self.low &= 0xFFFFFFFF >> self.bits_left
            if lead_byte == 0xFF:
                self.num_buffered_bytes += 1
            elif self.num_buffered_bytes > 0:
                carry = lead_byte >> 8
                self.bytes.append((self.buffered_byte + carry) & 0xFF)
                byte = (0xFF + carry) & 0xFF
                while self.num_buffered_bytes > 1:
                    self.bytes.append(byte)
                    self.num_buffered_bytes -= 1
                self.buffered_byte = lead_byte & 0xFF
            else:
                self.num_buffered_bytes = 1
                self.buffered_byte = lead_byte & 0xFF

