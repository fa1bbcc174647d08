"""The framework container stream of decided CU trees: the header, the
switch policy's MPM rule and the real CABAC pass (`serialize_trees`).

A frozen copy of the port's `codec/encoder.py` as the benchmark's plain
reference uses it (only the parts it needs; nothing of the port is
imported).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from . import cabac, syntax
from .contexts import OFFSETS, make_context_states


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


def serialize_trees(trees, *, width: int, height: int, qp: int, policy: str,
                    ctu_size: int, sign_hiding: bool,
                    max_tu_depth: int = 0) -> bytes:
    """Real CABAC pass over decided CU trees -> framework bitstream.

    Shared by the RDO encoder and the wavefront (fixed-grid) encoder.
    """
    header = stream_header(width=width, height=height, qp=qp, policy=policy,
                           ctu_size=ctu_size, sign_hiding=sign_hiding,
                           max_tu_depth=max_tu_depth)
    enc = cabac.CabacEncoder()
    ctx = make_context_states(qp)
    uh, uw = height // 4, width // 4
    mode_map = np.full((uh, uw), -1, dtype=np.int32)
    depth_map = np.zeros((uh, uw), dtype=np.int32)
    coded = np.zeros((uh, uw), dtype=bool)

    def split_ctx(x, y, depth):
        c = 0
        ux, uy = x // 4, y // 4
        if x > 0 and coded[uy, ux - 1]:
            c += 1 if depth_map[uy, ux - 1] > depth else 0
        if y > 0 and coded[uy - 1, ux]:
            c += 1 if depth_map[uy - 1, ux] > depth else 0
        return c

    def mpms_at(x, y):
        def nb(left):
            if left:
                nx, ny = x - 1, y
            else:
                nx, ny = x, y - 1
                if y % ctu_size == 0:
                    return syntax.DC_IDX
            if nx < 0 or ny < 0:
                return syntax.DC_IDX
            m = int(mode_map[ny // 4, nx // 4])
            return m if m >= 0 else syntax.DC_IDX
        left, above = nb(True), nb(False)
        if policy == "switch":
            return mpms_switch(left, above)
        return syntax.mpm_candidates(left, above)

    def ser_cu(node):
        if node is None:
            return
        x, y, size, depth = node.x, node.y, node.size, node.depth
        inside = x + size <= width and y + size <= height
        if size > MIN_CU and inside:
            enc.encode_bin(1 if node.split else 0, ctx,
                           OFFSETS.split_cu + split_ctx(x, y, depth))
        if node.split:
            for child in node.children:
                ser_cu(child)
            return
        if size == MIN_CU:
            enc.encode_bin(0 if node.part_nxn else 1, ctx, OFFSETS.part_size)
        for pu in node.pus:
            mpms = mpms_at(pu.x, pu.y)
            if policy == "switch":
                enc.encode_bin(1 if pu.mode == PNNS_MODE else 0, ctx,
                               OFFSETS.pnns_flag)
                if pu.mode != PNNS_MODE:
                    syntax.encode_intra_mode(enc, ctx, pu.mode, mpms)
            else:
                syntax.encode_intra_mode(enc, ctx, pu.mode, mpms)
            mode_map[pu.y // 4:(pu.y + pu.n) // 4,
                     pu.x // 4:(pu.x + pu.n) // 4] = pu.mode
            leaves = {(tu.x, tu.y, tu.n): tu for tu in pu.tus}

            def ser_tus(tx, ty, tsize, tdepth):
                forced = tsize > MAX_TU
                half = tsize // 2
                if forced:
                    for (cx, cy) in ((tx, ty), (tx + half, ty),
                                     (tx, ty + half), (tx + half, ty + half)):
                        ser_tus(cx, cy, half, tdepth + 1)
                    return
                leaf = leaves.get((tx, ty, tsize))
                if tsize > 4 and tdepth < max_tu_depth:
                    flag_ctx = OFFSETS.trans_subdiv + (5 - (tsize.bit_length() - 1))
                    enc.encode_bin(0 if leaf is not None else 1, ctx, flag_ctx)
                if leaf is None:
                    for (cx, cy) in ((tx, ty), (tx + half, ty),
                                     (tx, ty + half), (tx + half, ty + half)):
                        ser_tus(cx, cy, half, tdepth + 1)
                    return
                enc.encode_bin(leaf.cbf, ctx,
                               OFFSETS.cbf_luma + (1 if tdepth == 0 else 0))
                if leaf.cbf:
                    syntax.encode_coefficients(
                        enc, ctx, leaf.coeffs,
                        pu.mode if pu.mode != PNNS_MODE else 0, sign_hiding)

            # NxN PUs are quadrants of the CU-level transform tree: their TUs
            # sit at trafo depth 1 (cbf_luma context 0), like the HM layout.
            ser_tus(pu.x, pu.y, pu.n, 1 if node.part_nxn else 0)
        depth_map[y // 4:(y + size) // 4, x // 4:(x + size) // 4] = depth
        coded[y // 4:(y + size) // 4, x // 4:(x + size) // 4] = True

    for node in trees:
        ser_cu(node)
    return header + enc.terminate_and_finish()

