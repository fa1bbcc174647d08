"""All-Intra luma frame decoder of the framework's container streams.

The port's copy of the JAX package's `codec/decoder.py` (:28-227), the
normative inverse of its encoders (`TDecCu.cpp:131-520`, `TDecSbac`):
parse the CU quadtree, the intra modes (with the switch policy's leading
PNNS bin and its own context, `TDecSbac.cpp:645-760` in hm_16_15_switch),
cbf and coefficients, then reconstruct TU by TU with the same reference
samples, intra prediction, dequantisation and inverse transform, and for
the NN policies the same PNN forward (`nn_intra.PnnPredictor`, quantized
models, on its device).  After the CUs the loop filters run as in the JAX
package (:199-220): the SAO parameters parsed after the last CU,
deblocking on the TU map (`deblock.deblock_luma`, native), then
`sao.apply_sao`.  The stream parsing, per-TU work and loop filters are
host work; only the PNN forward runs on the device.  Transform skip and
TU-split depths are parsed as in the JAX package.  Strong intra smoothing
of 32x32 references is on unless the caller turns it off, as in the JAX
package: the header does not carry it, and the uniform-grid encoder
(`parallel/wavefront.py`) filters 32x32 references with [1 2 1] only, so
its block-size-32 streams decode with `strong_intra_smoothing=False`.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ..ops import intra, reference_samples as rs, transform
from . import cabac, deblock, sao as sao_mod, syntax
from .contexts import OFFSETS, make_context_states
from .encoder import MAGIC, MAX_TU, MIN_CU, PNNS_MODE, POLICIES, mpms_switch
from .nn_intra import as_predictor

HEADER = "<4sBBBBBBBBBII"


@dataclass
class DecodeResult:
    reconstruction: np.ndarray      # (H, W) uint8
    mode_map: np.ndarray            # per 4x4 unit luma mode
    qp: int
    policy: str


class FrameDecoder:
    """One stream's decode.  `pnn` is a `PnnBundle` or a `PnnPredictor`
    (NN policies need one); the PNN runs on `device` ("cuda" by
    default)."""

    def __init__(self, bitstream: bytes, *, pnn=None, device="cuda",
                 strong_intra_smoothing: bool = True):
        header_size = struct.calcsize(HEADER)
        (magic, _version, policy_idx, qp, sign_hiding, deblocking,
         max_tu_depth, sao_on, tskip_on, ctu, w, h) = struct.unpack(
             HEADER, bitstream[:header_size])
        if magic != MAGIC:
            raise ValueError("not a CPNN bitstream")
        self.deblocking = bool(deblocking)
        self.sao_on = bool(sao_on)
        self.policy = POLICIES[policy_idx]
        if self.policy != "regular" and pnn is None:
            raise ValueError("NN policies need a PnnPredictor to decode")
        self.qp = qp
        self.sign_hiding = bool(sign_hiding)
        self.max_tu_depth = int(max_tu_depth)
        self.tskip_on = bool(tskip_on)
        self.ctu = ctu
        self.w, self.h = w, h
        self.strong_smoothing = strong_intra_smoothing
        if pnn is not None:
            pnn = as_predictor(pnn, device).bind_qp(qp)
        self.pnn = pnn
        self.dec = cabac.CabacDecoder(bitstream[header_size:])
        # A list: faster per bin than a numpy array, the same states.
        self.ctx = make_context_states(qp).tolist()

        uh, uw = h // 4, w // 4
        self.recon = np.zeros((h, w), dtype=np.int32)
        self.unit_coded = np.zeros((uh, uw), dtype=bool)
        self.mode_map = np.full((uh, uw), -1, dtype=np.int32)
        self.depth_map = np.zeros((uh, uw), dtype=np.int32)
        self.tu_map = np.full((uh, uw), -1, dtype=np.int32)
        self.tu_counter = 0

    # ------------------------------------------------------------ helpers --

    def _split_ctx(self, x, y, depth):
        ctx = 0
        ux, uy = x // 4, y // 4
        if x > 0 and self.unit_coded[uy, ux - 1]:
            ctx += 1 if self.depth_map[uy, ux - 1] > depth else 0
        if y > 0 and self.unit_coded[uy - 1, ux]:
            ctx += 1 if self.depth_map[uy - 1, ux] > depth else 0
        return ctx

    def _mpms(self, x, y):
        def nb(left):
            if left:
                nx, ny = x - 1, y
            else:
                nx, ny = x, y - 1
                if y % self.ctu == 0:
                    return syntax.DC_IDX
            if nx < 0 or ny < 0:
                return syntax.DC_IDX
            m = int(self.mode_map[ny // 4, nx // 4])
            return m if m >= 0 else syntax.DC_IDX
        left, above = nb(True), nb(False)
        if self.policy == "switch":
            return mpms_switch(left, above)
        return syntax.mpm_candidates(left, above)

    def _predict(self, x, y, n, mode):
        flags = rs.coded_unit_flags(self.unit_coded, x, y, n, self.h, self.w)
        if ((self.policy == "substitution" and mode == 18
             and self.pnn.supports(n)) or mode == PNNS_MODE):
            return self.pnn.predict(self.recon, x, y, n, flags)
        ref_top, ref_left = rs.fill_reference_samples(self.recon, x, y, n,
                                                      flags)
        if rs.use_filtered_for_mode(mode, n):
            ref_top, ref_left = rs.filter_reference_samples(
                ref_top, ref_left, n,
                strong_intra_smoothing=self.strong_smoothing)
        return intra.predict_one_mode_np(ref_top, ref_left, mode)

    def _decode_tu(self, x, y, n, mode, tu_depth0: bool):
        pred = self._predict(x, y, n, mode)
        cbf = self.dec.decode_bin(self.ctx,
                                  OFFSETS.cbf_luma + (1 if tu_depth0 else 0))
        if cbf:
            tskip = 0
            if self.tskip_on and n == 4:
                tskip = self.dec.decode_bin(self.ctx, OFFSETS.transform_skip)
            q = syntax.decode_coefficients(
                self.dec, self.ctx, n,
                mode if mode != PNNS_MODE else 0, self.sign_hiding)
            deq = transform.dequantize_np(q[None], self.qp)[0]
            if tskip:
                tshift = transform.transform_shift(2)
                rec_resi = (deq + (1 << (tshift - 1))) >> tshift
            else:
                rec_resi = transform.inverse_transform_np(
                    deq[None], use_dst=(n == 4))[0]
            rec = np.clip(pred + rec_resi, 0, 255)
        else:
            rec = pred
        self.recon[y:y + n, x:x + n] = rec
        self.unit_coded[y // 4:(y + n) // 4, x // 4:(x + n) // 4] = True
        self.tu_map[y // 4:(y + n) // 4, x // 4:(x + n) // 4] = \
            self.tu_counter
        self.tu_counter += 1

    def _decode_tu_tree(self, x, y, size, depth, mode, nxn=False):
        forced = size > MAX_TU
        half = size // 2
        quadrants = ((x, y), (x + half, y), (x, y + half),
                     (x + half, y + half))
        if forced:
            for (cx, cy) in quadrants:
                self._decode_tu_tree(cx, cy, half, depth + 1, mode)
            return
        split = False
        if size > 4 and depth < self.max_tu_depth:
            flag_ctx = OFFSETS.trans_subdiv + (5 - (size.bit_length() - 1))
            split = bool(self.dec.decode_bin(self.ctx, flag_ctx))
        if split:
            for (cx, cy) in quadrants:
                self._decode_tu_tree(cx, cy, half, depth + 1, mode)
            return
        # NxN PU TUs sit at trafo depth 1 in the stream (cbf_luma context 0).
        self._decode_tu(x, y, size, mode, tu_depth0=(depth == 0 and not nxn))

    def _decode_pu(self, x, y, n, nxn=False):
        mpms = self._mpms(x, y)
        if self.policy == "switch" and self.dec.decode_bin(
                self.ctx, OFFSETS.pnns_flag):
            mode = PNNS_MODE
        else:
            mode = syntax.decode_intra_mode(self.dec, self.ctx, mpms)
        self.mode_map[y // 4:(y + n) // 4, x // 4:(x + n) // 4] = mode
        self._decode_tu_tree(x, y, n, 0, mode, nxn)

    def _decode_cu(self, x, y, size, depth):
        if x >= self.w or y >= self.h:
            return
        inside = x + size <= self.w and y + size <= self.h
        forced_split = not inside and size > MIN_CU
        if forced_split:
            split = True
        elif size > MIN_CU and inside:
            split = self.dec.decode_bin(
                self.ctx, OFFSETS.split_cu + self._split_ctx(x, y, depth))
        else:
            split = False
        if split:
            half = size // 2
            for (cx, cy) in ((x, y), (x + half, y), (x, y + half),
                             (x + half, y + half)):
                self._decode_cu(cx, cy, half, depth + 1)
            return
        if size == MIN_CU:
            part_2n = self.dec.decode_bin(self.ctx, OFFSETS.part_size)
            if part_2n:
                self._decode_pu(x, y, size)
            else:
                for (px, py) in ((x, y), (x + 4, y), (x, y + 4),
                                 (x + 4, y + 4)):
                    self._decode_pu(px, py, 4, nxn=True)
        else:
            self._decode_pu(x, y, size)
        self.depth_map[y // 4:(y + size) // 4, x // 4:(x + size) // 4] = depth

    def decode(self) -> DecodeResult:
        if self.pnn is not None:
            self.pnn.invalidate()
        for cy in range(0, self.h, self.ctu):
            for cx in range(0, self.w, self.ctu):
                self._decode_cu(cx, cy, self.ctu, 0)
        sao_grid = None
        if self.sao_on:
            sao_grid = sao_mod.decode_params(
                self.dec, self.ctx, (self.h + self.ctu - 1) // self.ctu,
                (self.w + self.ctu - 1) // self.ctu)
        final = self.recon.astype(np.uint8)
        if self.deblocking:
            final = deblock.deblock_luma(final, self.tu_map, self.qp)
        if sao_grid is not None:
            final = sao_mod.apply_sao(final, sao_grid, self.ctu)
        return DecodeResult(
            reconstruction=final,
            mode_map=self.mode_map.copy(),
            qp=self.qp,
            policy=self.policy,
        )


def decode_frame(bitstream: bytes, *, pnn=None, device="cuda",
                 strong_intra_smoothing: bool = True) -> DecodeResult:
    """Decodes one container stream; `pnn` (a `PnnBundle` or a
    `PnnPredictor`) for the NN policies, its forward on `device`.  Strong
    intra smoothing is on by default, as in the quadtree encoders; the
    uniform-grid encoder's block-size-32 streams need it off."""
    return FrameDecoder(bitstream, pnn=pnn, device=device,
                        strong_intra_smoothing=strong_intra_smoothing
                        ).decode()
