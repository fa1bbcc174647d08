"""HM-16.15 conformant HEVC decoder (All-Intra, 4:0:0 or 4:2:0, 8-bit).

The port's copy of the JAX package's `codec/hm_decoder.py`: it decodes
Annex-B streams of HM-16.15 (TAppEncoderStatic, All-Intra 8-bit) and of
the port's `hm_encoder` bit-exactly: NAL / SPS / PPS / slice-header
parsing from `hm_bitstream`, then HM's CABAC slice syntax (per
`TDecEntropy` / `TDecSbac` / `TDecCu`) and normative reconstruction (intra
prediction, dequantisation, inverse transform, deblocking, SAO), luma and
4:2:0 chroma, for the three policies ('substitution' and 'switch' are the
reference's NN codec syntaxes).  The output is checked against the
decoded-picture-hash SEI the stream carries.

`use_native` picks the slice parser: "auto" and "always" parse (and for
'regular' reconstruct) in C++ (`native.hm_decode_slice_native`), the NN
policies replaying the reconstruction here with the PNN on the
predictor's device; "never" parses in Python.  Switch 4:2:0 streams have
no native parser (their chroma candidate list and chroma PNNS), so
"auto" parses them in Python and "always" raises.  A native failure
raises: no path falls back.

Scope: I-slices, no tiles / WPP / dependent slices, no scaling lists, no
PCM.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..ops import intra, reference_samples as rs, transform
from . import cabac, deblock, hm_bitstream, native, sao as sao_mod, syntax
from .contexts import OFFSETS, make_context_states
from .encoder import mpms_switch
from .nn_intra import as_predictor, check_device


# Rec. H.265 Table 8-10 / HM g_aucChromaScale row CHROMA_420: qPi -> QpC.
CHROMA_SCALE_420 = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
     20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 29, 30, 31, 32, 33, 33, 34, 34,
     35, 35, 36, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49,
     50, 51], dtype=np.int32)


def chroma_qp_420(qp_luma: int, offset: int = 0) -> int:
    q = int(np.clip(qp_luma + offset, 0, 57))
    return int(CHROMA_SCALE_420[q])


# IntraPredModeC candidate list (Rec. H.265 8.4.3): {planar, ver, hor, dc};
# an entry equal to the luma mode is replaced by angular 34.
CHROMA_CANDIDATES = (0, 26, 10, 1)
# Switch-policy list {planar, dc, ver, PNNS}; a collision with the luma mode
# is replaced by HORIZONTAL (hm_16_15_switch/.../TComDataCU.cpp:1364-1400).
SWITCH_CHROMA_CANDIDATES = (0, 1, 26, 35)


def chroma_mode_from_index(index: int, luma_mode: int,
                           policy: str = "regular") -> int:
    """index 4 = DM (luma mode); 0..3 = candidate list with substitution.

    Regular/substitution: H.265 8.4.3 (34-substitution).  Switch: the
    reference replaces the 35-bearing list's luma collision with HOR."""
    if index == 4:
        return luma_mode
    if policy == "switch":
        mode = SWITCH_CHROMA_CANDIDATES[index]
        return 10 if mode == luma_mode else mode
    mode = CHROMA_CANDIDATES[index]
    return 34 if mode == luma_mode else mode


@dataclass
class HmDecodeResult:
    reconstruction: np.ndarray
    qp: int
    mode_map: np.ndarray
    hash_checked: bool
    hash_ok: bool
    reconstruction_cb: Optional[np.ndarray] = None
    reconstruction_cr: Optional[np.ndarray] = None


PNNS_MODE = 35


class HmFrameDecoder:
    """Decodes HM-framed streams; `policy` extends the syntax for the
    reference's NN codecs: 'substitution' replaces mode 18's *prediction*
    with the normative PNN (stock syntax, `hm_16_15_substitution`), 'switch'
    parses the leading PNNS bin per PU with its dedicated context
    (`hm_16_15_switch/TDecSbac.cpp:645-760`).  `pnn` is a `PnnPredictor`
    or a `PnnBundle`; its forwards run on `device` ("cuda" by default; a
    CUDA device without a card raises)."""

    def __init__(self, annexb: bytes, *, policy: str = "regular", pnn=None,
                 device="cuda"):
        if policy not in ("regular", "substitution", "switch"):
            raise ValueError(f"unknown policy {policy!r}")
        if policy != "regular" and pnn is None:
            raise ValueError("NN policies need a PnnPredictor")
        self.policy = policy
        st = hm_bitstream.parse_stream(annexb)
        if st.sps.chroma_format_idc not in (0, 1):
            raise ValueError("only 4:0:0 / 4:2:0 streams supported")
        if st.sps.bit_depth_luma != 8:
            raise ValueError("only 8-bit streams supported")
        self.stream = st
        self.sps = st.sps
        self.pps = st.pps
        self.sh = st.slice_header
        self.qp = self.sh.qp
        self.w = st.sps.width
        self.h = st.sps.height
        self.ctu = st.sps.ctu_size
        self.min_cb = 1 << st.sps.log2_min_cb
        self.max_tb = 1 << st.sps.log2_max_tb
        self.min_tb = 1 << st.sps.log2_min_tb
        self.chroma = st.sps.chroma_format_idc == 1

        self.pnn = (as_predictor(pnn, check_device(device)).bind_qp(self.qp)
                    if pnn is not None else None)
        self.dec = cabac.CabacDecoder(self.sh.slice_data)
        # A list: faster per bin than a numpy array, the same states.
        self.ctx = make_context_states(self.qp).tolist()

        uh, uw = (self.h + 3) // 4, (self.w + 3) // 4
        self.recon = np.zeros((self.h, self.w), dtype=np.int32)
        self.unit_coded = np.zeros((uh, uw), dtype=bool)
        self.mode_map = np.full((uh, uw), -1, dtype=np.int32)
        self.depth_map = np.zeros((uh, uw), dtype=np.int32)
        self.tu_map = np.full((uh, uw), -1, dtype=np.int32)
        self.tu_counter = 0
        self.sao_grid = None
        self.sao_grid_cb = None
        self.sao_grid_cr = None
        if self.chroma:
            self.recon_cb = np.zeros((self.h // 2, self.w // 2), dtype=np.int32)
            self.recon_cr = np.zeros((self.h // 2, self.w // 2), dtype=np.int32)
            self.qp_cb = chroma_qp_420(self.qp, self.pps.cb_qp_offset)
            self.qp_cr = chroma_qp_420(self.qp, self.pps.cr_qp_offset)

    # --------------------------------------------------------------- CUs ----

    def _split_ctx(self, x: int, y: int, depth: int) -> int:
        ctx = 0
        ux, uy = x // 4, y // 4
        if x > 0 and self.unit_coded[uy, ux - 1]:
            ctx += 1 if self.depth_map[uy, ux - 1] > depth else 0
        if y > 0 and self.unit_coded[uy - 1, ux]:
            ctx += 1 if self.depth_map[uy - 1, ux] > depth else 0
        return ctx

    def _neighbor_mode(self, nx: int, ny: int) -> int:
        """Intra mode of the 4x4 unit at sample (nx, ny); DC if unavailable.

        Availability follows *parse* order (mode recorded), matching HM's
        Z-scan neighbour availability in `getIntraDirPredictor` — inside an
        NxN CU the earlier PUs are valid MPM neighbours before their TUs
        reconstruct."""
        if nx < 0 or ny < 0:
            return syntax.DC_IDX
        m = int(self.mode_map[ny // 4, nx // 4])
        return m if m >= 0 else syntax.DC_IDX

    def _mpms(self, x: int, y: int):
        left = self._neighbor_mode(x - 1, y)
        if y % self.ctu == 0:
            # HM restricts the above neighbour to the current CTU row.
            above = syntax.DC_IDX
        else:
            above = self._neighbor_mode(x, y - 1)
        if self.policy == "switch":
            return mpms_switch(left, above)
        return syntax.mpm_candidates(left, above)

    def _decode_cu(self, x: int, y: int, log2_size: int, depth: int):
        size = 1 << log2_size
        inside = x + size <= self.w and y + size <= self.h
        if size > self.min_cb and inside:
            split = self.dec.decode_bin(
                self.ctx, OFFSETS.split_cu + self._split_ctx(x, y, depth))
        elif size > self.min_cb:
            split = 1  # partially outside: split inferred
        else:
            split = 0
        if split:
            half = size // 2
            for (cx, cy) in ((x, y), (x + half, y), (x, y + half),
                             (x + half, y + half)):
                if cx < self.w and cy < self.h:
                    self._decode_cu(cx, cy, log2_size - 1, depth + 1)
            return

        if self.pps.transquant_bypass_enabled:
            raise ValueError("transquant bypass unsupported")

        # part_mode: only present at the minimum CU size (intra).
        part_nxn = False
        if log2_size == self.sps.log2_min_cb:
            part_nxn = not self.dec.decode_bin(self.ctx, OFFSETS.part_size)

        if part_nxn:
            half = size // 2
            pu_xy = ((x, y), (x + half, y), (x, y + half), (x + half, y + half))
            # HM parses the four leading flags first, then the four
            # mpm_idx / rem_intra fields (TDecSbac::parseIntraDirLumaAng);
            # the switch codec prepends a PNNS bin per PU in the first loop.
            prev_flags = []
            for _ in range(4):
                if self.policy == "switch" and self.dec.decode_bin(
                        self.ctx, OFFSETS.pnns_flag):
                    prev_flags.append(None)  # PNNS: no prev flag
                else:
                    prev_flags.append(
                        self.dec.decode_bin(self.ctx, OFFSETS.prev_intra))
            modes = []
            raw = []
            for i in range(4):
                if prev_flags[i] is None:
                    raw.append(("pnns", 0))
                elif prev_flags[i]:
                    if self.dec.decode_bin_ep() == 0:
                        raw.append(("mpm", 0))
                    else:
                        raw.append(("mpm", 1 + self.dec.decode_bin_ep()))
                else:
                    raw.append(("rem", self.dec.decode_bins_ep(5)))
            for i, (px, py) in enumerate(pu_xy):
                mpms = self._mpms(px, py)
                kind, v = raw[i]
                if kind == "pnns":
                    mode = PNNS_MODE
                elif kind == "mpm":
                    mode = mpms[v]
                else:
                    rem = v
                    for m in sorted(mpms):
                        if rem >= m:
                            rem += 1
                    mode = rem
                modes.append(mode)
                # Record the mode before the next PU derives its MPMs.
                self.mode_map[py // 4:(py + half) // 4,
                              px // 4:(px + half) // 4] = mode
            chroma_mode = self._parse_chroma_mode(modes[0])
            self._transform_tree(x, y, x, y, log2_size, 0, 0, modes,
                                 chroma_mode, 1, 1,
                                 intra_split=True)
        else:
            if self.policy == "switch" and self.dec.decode_bin(
                    self.ctx, OFFSETS.pnns_flag):
                mode = PNNS_MODE
            elif self.dec.decode_bin(self.ctx, OFFSETS.prev_intra):
                if self.dec.decode_bin_ep() == 0:
                    idx = 0
                else:
                    idx = 1 + self.dec.decode_bin_ep()
                mode = self._mpms(x, y)[idx]
            else:
                rem = self.dec.decode_bins_ep(5)
                for m in sorted(self._mpms(x, y)):
                    if rem >= m:
                        rem += 1
                mode = rem
            self.mode_map[y // 4:(y + size) // 4, x // 4:(x + size) // 4] = mode
            chroma_mode = self._parse_chroma_mode(mode)
            self._transform_tree(x, y, x, y, log2_size, 0, 0, [mode] * 4,
                                 chroma_mode, 1, 1,
                                 intra_split=False)

        self.depth_map[y // 4:(y + size) // 4, x // 4:(x + size) // 4] = depth

    def _parse_chroma_mode(self, luma_mode0: int) -> int:
        """intra_chroma_pred_mode: one per CU in 4:2:0 (TDecSbac::
        parseIntraDirChroma); DM derives from the first PU's luma mode."""
        if not self.chroma:
            return -1
        if self.dec.decode_bin(self.ctx, OFFSETS.chroma_pred) == 0:
            index = 4  # DM
        else:
            index = self.dec.decode_bins_ep(2)
        return chroma_mode_from_index(index, luma_mode0, self.policy)

    # --------------------------------------------------------------- TUs ----

    def _transform_tree(self, x: int, y: int, x_base: int, y_base: int,
                        log2_size: int, tr_depth: int, blk_idx: int,
                        pu_modes, chroma_mode: int,
                        parent_cbf_cb: int, parent_cbf_cr: int,
                        *, intra_split: bool):
        max_depth = (self.sps.max_transform_hierarchy_depth_intra
                     + (1 if intra_split else 0))
        size = 1 << log2_size
        if log2_size > self.sps.log2_max_tb:
            split = 1
        elif intra_split and tr_depth == 0:
            split = 1
        elif (log2_size > self.sps.log2_min_tb and tr_depth < max_depth):
            split = self.dec.decode_bin(
                self.ctx, OFFSETS.trans_subdiv + (5 - log2_size))
        else:
            split = 0

        # Chroma cbfs: coded at nodes with log2 > 2 when the parent's cbf was
        # set (or at depth 0); inherited otherwise (Rec. 7.3.8.8).
        cbf_cb, cbf_cr = parent_cbf_cb, parent_cbf_cr
        if self.chroma and log2_size > 2:
            if tr_depth == 0 or parent_cbf_cb:
                cbf_cb = self.dec.decode_bin(
                    self.ctx, OFFSETS.cbf_chroma + tr_depth)
            else:
                cbf_cb = 0
            if tr_depth == 0 or parent_cbf_cr:
                cbf_cr = self.dec.decode_bin(
                    self.ctx, OFFSETS.cbf_chroma + tr_depth)
            else:
                cbf_cr = 0

        if split:
            half = size // 2
            for i, (cx, cy) in enumerate(((x, y), (x + half, y), (x, y + half),
                                          (x + half, y + half))):
                self._transform_tree(cx, cy, x, y, log2_size - 1, tr_depth + 1,
                                     i, pu_modes, chroma_mode, cbf_cb, cbf_cr,
                                     intra_split=intra_split)
            return
        # Leaf TU: which PU does it belong to? (NxN -> quadrant index.)
        if intra_split:
            cu_size = 1 << self.sps.log2_min_cb
            qi = (2 if (y % cu_size) >= cu_size // 2 else 0) + \
                 (1 if (x % cu_size) >= cu_size // 2 else 0)
            mode = pu_modes[qi]
        else:
            mode = pu_modes[0]
        cbf = self.dec.decode_bin(
            self.ctx, OFFSETS.cbf_luma + (1 if tr_depth == 0 else 0))
        self._reconstruct_tu(x, y, size, mode, cbf)
        if self.chroma:
            if log2_size > 2:
                self._chroma_tu(x // 2, y // 2, size // 2, chroma_mode,
                                cbf_cb, cbf_cr)
            elif blk_idx == 3:
                # Four 4x4 luma TUs share one 4x4 chroma TB coded at the last
                # child, covering the parent 8x8 luma area.
                self._chroma_tu(x_base // 2, y_base // 2, 4, chroma_mode,
                                parent_cbf_cb, parent_cbf_cr)

    def _reconstruct_tu(self, x: int, y: int, n: int, mode: int, cbf: int):
        flags = rs.coded_unit_flags(self.unit_coded, x, y, n, self.h, self.w)
        if ((self.policy == "substitution" and mode == 18
             and self.pnn.supports(n)) or mode == PNNS_MODE):
            pred = self.pnn.predict(self.recon, x, y, n, flags)
        else:
            ref_top, ref_left = rs.fill_reference_samples(self.recon, x, y, n,
                                                          flags)
            if rs.use_filtered_for_mode(mode, n):
                ref_top, ref_left = rs.filter_reference_samples(
                    ref_top, ref_left, n,
                    strong_intra_smoothing=self.sps.strong_intra_smoothing)
            pred = intra.predict_one_mode_np(ref_top, ref_left, mode)
        if cbf:
            tskip = 0
            if self.pps.transform_skip_enabled and n == 4:
                tskip = self.dec.decode_bin(self.ctx, OFFSETS.transform_skip)
            q = syntax.decode_coefficients(
                self.dec, self.ctx, n, mode if mode != PNNS_MODE else 0,
                self.pps.sign_data_hiding)
            deq = transform.dequantize_np(q[None], self.qp)[0]
            if tskip:
                tshift = transform.transform_shift(2)
                resi = (deq + (1 << (tshift - 1))) >> tshift
            else:
                resi = transform.inverse_transform_np(deq[None],
                                                      use_dst=(n == 4))[0]
            rec = np.clip(pred + resi, 0, 255)
        else:
            rec = pred
        self.recon[y:y + n, x:x + n] = rec
        self.unit_coded[y // 4:(y + n) // 4, x // 4:(x + n) // 4] = True
        self.tu_map[y // 4:(y + n) // 4, x // 4:(x + n) // 4] = self.tu_counter
        self.tu_counter += 1

    def _chroma_tu(self, xc: int, yc: int, nc: int, chroma_mode: int,
                   cbf_cb: int, cbf_cr: int):
        """Parses + reconstructs the Cb then Cr TBs of one chroma TU.

        Chroma reference samples are unfiltered and the DC/edge boundary
        filters do not apply (Rec. 8.4.4.2.3/8.4.4.2.6 for ChromaArrayType 1).
        """
        for plane, cbf, qpc in ((self.recon_cb, cbf_cb, self.qp_cb),
                                (self.recon_cr, cbf_cr, self.qp_cr)):
            if chroma_mode == PNNS_MODE:
                # Switch chroma PNNS: luma-trained nets on the chroma plane
                # (nn_intra.predict_chroma docstring).
                pred = self.pnn.predict_chroma(
                    plane, self.unit_coded, xc, yc, nc,
                    self.h // 2, self.w // 2)
            else:
                flags = rs.coded_unit_flags(self.unit_coded, xc, yc, nc,
                                               self.h // 2, self.w // 2,
                                               unit=2)
                ref_top, ref_left = rs.fill_reference_samples(
                    plane, xc, yc, nc, flags, unit=2)
                pred = intra.predict_one_mode_np(ref_top, ref_left,
                                                 chroma_mode,
                                                 filtered_edges=False)
            if cbf:
                tskip = 0
                if self.pps.transform_skip_enabled and nc == 4:
                    tskip = self.dec.decode_bin(
                        self.ctx, OFFSETS.transform_skip_chroma)
                q = syntax.decode_coefficients(self.dec, self.ctx, nc,
                                               chroma_mode,
                                               self.pps.sign_data_hiding,
                                               channel=syntax.CHROMA)
                deq = transform.dequantize_np(q[None], qpc)[0]
                if tskip:
                    tshift = transform.transform_shift(2)
                    resi = (deq + (1 << (tshift - 1))) >> tshift
                else:
                    resi = transform.inverse_transform_np(deq[None],
                                                          use_dst=False)[0]
                rec = np.clip(pred + resi, 0, 255)
            else:
                rec = pred
            plane[yc:yc + nc, xc:xc + nc] = rec

    # -------------------------------------------------------------- frame ----

    def _parse_sao_offsets(self, mode: int, eo_class_or_none):
        """Offsets (+signs/band for BO) for one component with a known type."""
        mags = [sao_mod._decode_offset_mag(self.dec) for _ in range(4)]
        if mode == sao_mod.MODE_BO:
            offsets = []
            for m in mags:
                if m != 0 and self.dec.decode_bin_ep():
                    offsets.append(-m)
                else:
                    offsets.append(m)
            pos = self.dec.decode_bins_ep(5)
            return sao_mod.SaoParams(sao_mod.MODE_BO, pos, tuple(offsets))
        offsets = (mags[0], mags[1], -mags[2], -mags[3])
        eo_class = (self.dec.decode_bins_ep(2)
                    if eo_class_or_none is None else eo_class_or_none)
        return sao_mod.SaoParams(sao_mod.MODE_EO, eo_class, offsets)

    def _parse_sao_type(self) -> int:
        if not self.dec.decode_bin(self.ctx, OFFSETS.sao_type):
            return sao_mod.MODE_OFF
        return sao_mod.MODE_EO if self.dec.decode_bin_ep() else sao_mod.MODE_BO

    def _decode_sao_ctu(self, cy: int, cx: int):
        grids = [g for g in (self.sao_grid, self.sao_grid_cb, self.sao_grid_cr)
                 if g is not None]
        if cx > 0 and self.dec.decode_bin(self.ctx, OFFSETS.sao_merge):
            for g in grids:
                g[cy][cx] = g[cy][cx - 1]
            return
        if cy > 0 and self.dec.decode_bin(self.ctx, OFFSETS.sao_merge):
            for g in grids:
                g[cy][cx] = g[cy - 1][cx]
            return
        if self.sh.sao_luma:
            mode = self._parse_sao_type()
            self.sao_grid[cy][cx] = (sao_mod.SaoParams() if mode == 0
                                     else self._parse_sao_offsets(mode, None))
        if self.chroma and self.sh.sao_chroma:
            mode = self._parse_sao_type()  # sao_type_idx_chroma: cb + cr
            if mode == sao_mod.MODE_OFF:
                self.sao_grid_cb[cy][cx] = sao_mod.SaoParams()
                self.sao_grid_cr[cy][cx] = sao_mod.SaoParams()
            else:
                pcb = self._parse_sao_offsets(mode, None)
                # Cr shares the type and EO class with Cb; own offsets/band.
                eo = pcb.type_aux if pcb.mode == sao_mod.MODE_EO else None
                pcr = self._parse_sao_offsets(mode, eo)
                self.sao_grid_cb[cy][cx] = pcb
                self.sao_grid_cr[cy][cx] = pcr

    # ------------------------------------------------------ native fast path

    def _decode_native(self) -> HmDecodeResult:
        """CABAC parse (and, for 'regular', reconstruction) in C++.

        The native module (native/hm_parse.cpp) emits per-TU records; NN
        policies replay reconstruction here so the normative PNN forward runs
        on the predictor's device, while all bin decoding stays in C++.
        """
        if self.policy == "switch" and self.chroma:
            # The C++ parser derives chroma modes with the regular candidate
            # list; switch 4:2:0 (chroma PNNS, SWITCH_CHROMA_CANDIDATES)
            # has no native parser.
            raise NotImplementedError(
                "switch 4:2:0 streams have no native parser; decode them "
                "with use_native='never' or 'auto'")
        policy_id = {"regular": 0, "substitution": 1, "switch": 2}[self.policy]
        full_recon = self.policy == "regular"
        res = native.hm_decode_slice_native(
            self.sh.slice_data, width=self.w, height=self.h,
            ctu_size=self.ctu, log2_min_cb=self.sps.log2_min_cb,
            log2_max_tb=self.sps.log2_max_tb, log2_min_tb=self.sps.log2_min_tb,
            max_tr_depth_intra=self.sps.max_transform_hierarchy_depth_intra,
            chroma=self.chroma, qp=self.qp,
            qp_cb=self.qp_cb if self.chroma else 0,
            qp_cr=self.qp_cr if self.chroma else 0,
            transform_skip_enabled=self.pps.transform_skip_enabled,
            sign_data_hiding=self.pps.sign_data_hiding,
            sao_luma=self.sh.sao_luma, sao_chroma=self.sh.sao_chroma,
            strong_intra_smoothing=self.sps.strong_intra_smoothing,
            policy=policy_id, reconstruct=full_recon)

        self.mode_map = res["mode_map"]
        self.tu_map = res["tu_map"]
        if full_recon:
            self.recon = res["recon_y"]
            if self.chroma:
                self.recon_cb = res["recon_cb"]
                self.recon_cr = res["recon_cr"]
        else:
            self._replay_records(res["tu_meta"], res["coeffs"])

        n_ctu_y = (self.h + self.ctu - 1) // self.ctu
        n_ctu_x = (self.w + self.ctu - 1) // self.ctu

        def sao_grid_from(comp: int):
            grid = []
            for cy in range(n_ctu_y):
                row = []
                for cx in range(n_ctu_x):
                    e = res["sao"][cy * n_ctu_x + cx, comp]
                    row.append(sao_mod.SaoParams(int(e[0]), int(e[1]),
                                                 tuple(int(v) for v in e[2:6])))
                grid.append(row)
            return grid

        if self.sh.sao_luma:
            self.sao_grid = sao_grid_from(0)
        if self.chroma and self.sh.sao_chroma:
            self.sao_grid_cb = sao_grid_from(1)
            self.sao_grid_cr = sao_grid_from(2)
        return self._finish()

    def _replay_records(self, tu_meta: np.ndarray, coeffs: np.ndarray):
        """Reconstructs from native TU records (parse already done in C++)."""
        for rec in tu_meta:
            plane, x, y, n, mode, cbf, tskip, off = (int(v) for v in rec)
            if plane == 0:
                flags = rs.coded_unit_flags(self.unit_coded, x, y, n,
                                               self.h, self.w)
                if ((self.policy == "substitution" and mode == 18
                     and self.pnn.supports(n)) or mode == PNNS_MODE):
                    pred = self.pnn.predict(self.recon, x, y, n, flags)
                else:
                    ref_top, ref_left = rs.fill_reference_samples(
                        self.recon, x, y, n, flags)
                    if rs.use_filtered_for_mode(mode, n):
                        ref_top, ref_left = rs.filter_reference_samples(
                            ref_top, ref_left, n,
                            strong_intra_smoothing=self.sps.strong_intra_smoothing)
                    pred = intra.predict_one_mode_np(ref_top, ref_left, mode)
                rec_blk = self._apply_residual(pred, coeffs, off, n, cbf,
                                               tskip, self.qp, use_dst=(n == 4))
                self.recon[y:y + n, x:x + n] = rec_blk
                self.unit_coded[y // 4:(y + n) // 4, x // 4:(x + n) // 4] = True
                self.tu_counter += 1
            else:
                plane_arr = self.recon_cb if plane == 1 else self.recon_cr
                qpc = self.qp_cb if plane == 1 else self.qp_cr
                flags = rs.coded_unit_flags(self.unit_coded, x, y, n,
                                               self.h // 2, self.w // 2, unit=2)
                ref_top, ref_left = rs.fill_reference_samples(
                    plane_arr, x, y, n, flags, unit=2)
                pred = intra.predict_one_mode_np(ref_top, ref_left, mode,
                                                 filtered_edges=False)
                rec_blk = self._apply_residual(pred, coeffs, off, n, cbf,
                                               tskip, qpc, use_dst=False)
                plane_arr[y:y + n, x:x + n] = rec_blk

    @staticmethod
    def _apply_residual(pred, coeffs, off, n, cbf, tskip, qp, *, use_dst):
        if not cbf:
            return pred
        q = coeffs[off:off + n * n].reshape(n, n)
        deq = transform.dequantize_np(q[None], qp)[0]
        if tskip:
            tshift = transform.transform_shift(2)
            resi = (deq + (1 << (tshift - 1))) >> tshift
        else:
            resi = transform.inverse_transform_np(deq[None], use_dst=use_dst)[0]
        return np.clip(pred + resi, 0, 255)

    # --------------------------------------------------------- python path

    def decode(self, *, use_native: str = "auto") -> HmDecodeResult:
        if use_native not in ("auto", "always", "never"):
            raise ValueError(f"use_native must be 'auto', 'always' or "
                             f"'never', got {use_native!r}")
        if use_native == "always" or (
                use_native == "auto"
                and not (self.policy == "switch" and self.chroma)):
            return self._decode_native()
        n_ctu_y = (self.h + self.ctu - 1) // self.ctu
        n_ctu_x = (self.w + self.ctu - 1) // self.ctu
        sao_any = self.sh.sao_luma or (self.chroma and self.sh.sao_chroma)
        if self.sh.sao_luma:
            self.sao_grid = [[None] * n_ctu_x for _ in range(n_ctu_y)]
        if self.chroma and self.sh.sao_chroma:
            self.sao_grid_cb = [[None] * n_ctu_x for _ in range(n_ctu_y)]
            self.sao_grid_cr = [[None] * n_ctu_x for _ in range(n_ctu_y)]
        log2_ctu = self.sps.log2_max_cb
        for cy in range(n_ctu_y):
            for cx in range(n_ctu_x):
                if sao_any:
                    self._decode_sao_ctu(cy, cx)
                self._decode_cu(cx * self.ctu, cy * self.ctu, log2_ctu, 0)
                end = self.dec.decode_bin_trm()
                is_last = (cy == n_ctu_y - 1) and (cx == n_ctu_x - 1)
                if bool(end) != is_last:
                    raise ValueError(
                        f"end_of_slice_segment_flag desync at CTU ({cy},{cx})")
        return self._finish()

    def _finish(self) -> HmDecodeResult:
        """Loop filters + decoded-picture-hash check (shared by both paths)."""
        out = self.recon.astype(np.uint8)
        out_cb = self.recon_cb.astype(np.uint8) if self.chroma else None
        out_cr = self.recon_cr.astype(np.uint8) if self.chroma else None
        if not self.sh.deblocking_disabled:
            out = deblock.deblock_luma(out, self.tu_map, self.qp)
            if self.chroma:
                out_cb = deblock.deblock_chroma(out_cb, self.tu_map, self.qp_cb)
                out_cr = deblock.deblock_chroma(out_cr, self.tu_map, self.qp_cr)
        if self.sh.sao_luma:
            grid = [[p if p is not None else sao_mod.SaoParams() for p in row]
                    for row in self.sao_grid]
            out = sao_mod.apply_sao(out, grid, self.ctu)
        if self.chroma and self.sh.sao_chroma:
            grid_cb = [[p if p is not None else sao_mod.SaoParams()
                        for p in row] for row in self.sao_grid_cb]
            grid_cr = [[p if p is not None else sao_mod.SaoParams()
                        for p in row] for row in self.sao_grid_cr]
            out_cb = sao_mod.apply_sao(out_cb, grid_cb, self.ctu // 2)
            out_cr = sao_mod.apply_sao(out_cr, grid_cr, self.ctu // 2)

        hash_checked = hash_ok = False
        if self.stream.picture_hash is not None:
            hash_type, values = self.stream.picture_hash
            if hash_type == 2 and values:
                hash_checked = True
                hash_ok = hm_bitstream.picture_checksum(out) == values[0]
                if self.chroma and len(values) >= 3:
                    hash_ok = (hash_ok
                               and hm_bitstream.picture_checksum(out_cb) == values[1]
                               and hm_bitstream.picture_checksum(out_cr) == values[2])
        return HmDecodeResult(out, self.qp, self.mode_map.copy(),
                              hash_checked, hash_ok,
                              reconstruction_cb=out_cb,
                              reconstruction_cr=out_cr)


def decode_hm_stream(annexb: bytes, *, use_native: str = "auto",
                     **kwargs) -> HmDecodeResult:
    """Decodes an HM-16.15 All-Intra 8-bit Annex-B stream (4:0:0 or 4:2:0).

    Pass policy= / pnn= (and device=, "cuda" by default) for the
    reference's NN codec syntaxes (hm_16_15_substitution / hm_16_15_switch
    semantics).  `use_native` selects the C++ slice parser ("auto" /
    "always" / "never", see the module docstring); the output is
    bit-identical either way."""
    return HmFrameDecoder(annexb, **kwargs).decode(use_native=use_native)
