"""HM-conformant HEVC bitstream output (All-Intra, 4:0:0, 8-bit).

The port's copy of the JAX package's `codec/hm_encoder.py` (:30-467) for
luma-only streams: it re-serialises decided `encoder.CuNode` trees and a
SAO grid into a standard Annex-B HEVC stream that HM-16.15's
TAppDecoderStatic decodes bit-exactly: VPS/SPS/PPS NALs, an IDR slice in
HM's CABAC syntax order (per-CTU SAO parameters, end_of_slice flags, NxN
prev-flag grouping, inferred transform-tree splits) and a
decoded-picture-hash suffix SEI, so HM checks the reconstruction itself.
Syntax per `TEncCavlc::codeSPS/codePPS/codeSliceHeader` and `TEncSbac`;
the switch policy's leading PNNS bin per hm_16_15_switch
`TDecSbac.cpp:645-760` (such streams target that modified decoder, not
stock HM).

Scope: I-slices, 4:0:0 8-bit, CTU 32 or 64, TU 4..32, no tiles / WPP, no
scaling lists, no PCM.  The JAX package's host RDO encoders
(`encode_frame_hm`, `encode_frame_hm_420`) are not ported.
"""

from __future__ import annotations

from typing import List

import numpy as np

from . import cabac, sao as sao_mod, syntax
from .contexts import OFFSETS, make_context_states
from .encoder import MIN_CU, PNNS_MODE, CuNode, mpms_switch
from .hm_bitstream import (NAL_IDR_W_RADL, NAL_PPS, NAL_SPS, NAL_SUFFIX_SEI,
                           NAL_VPS, BitWriter, insert_emulation_prevention,
                           picture_checksum)

# Verbatim HM-16.15 VPS RBSP and profile_tier_level (main-RExt monochrome-8,
# level 5.2) as TAppEncoderStatic emits for the reference configuration.
VPS_RBSP = bytes.fromhex("0c01ffff04080000000fc8000000009cf024")
PTL_BYTES = bytes.fromhex("04080000000fc8000000009c")

MAX_TB_LOG2 = 5
MIN_TB_LOG2 = 2


def _nal(nal_type: int, rbsp: bytes, *, long_start: bool = True) -> bytes:
    header = bytes([(nal_type << 1) & 0x7E, 0x01])
    start = b"\x00\x00\x00\x01" if long_start else b"\x00\x00\x01"
    return start + header + insert_emulation_prevention(rbsp)


def write_sps(width: int, height: int, *, sao: bool, max_tu_depth: int,
              strong_intra_smoothing: bool, ctu_size: int = 64) -> bytes:
    """4:0:0 SPS RBSP."""
    w = BitWriter()
    w.u(0, 4)            # sps_video_parameter_set_id
    w.u(0, 3)            # sps_max_sub_layers_minus1
    w.flag(1)            # sps_temporal_id_nesting_flag
    ptl = bytearray(PTL_BYTES)
    if ctu_size < 32:
        # Levels >= 5 require CtbSizeY >= 32 (Rec. H.265 A.4.1); declare
        # level 4.1 for CTB-16 streams (covers 1080p).
        ptl[-1] = 123
    for b in ptl:
        w.u(b, 8)
    w.ue(0)              # sps_seq_parameter_set_id
    w.ue(0)              # chroma_format_idc: 4:0:0
    w.ue(width)
    w.ue(height)
    w.flag(0)            # conformance_window_flag (dims are multiples of 8)
    w.ue(0)              # bit_depth_luma_minus8
    w.ue(0)              # bit_depth_chroma_minus8
    w.ue(4)              # log2_max_pic_order_cnt_lsb_minus4
    w.flag(1)            # sps_sub_layer_ordering_info_present_flag
    w.ue(1)              # sps_max_dec_pic_buffering_minus1
    w.ue(0)              # sps_max_num_reorder_pics
    w.ue(0)              # sps_max_latency_increase_plus1
    ctu_log2 = ctu_size.bit_length() - 1
    max_tb_log2 = min(MAX_TB_LOG2, ctu_log2)
    w.ue(0)              # log2_min_luma_coding_block_size_minus3
    w.ue(ctu_log2 - 3)   # log2_diff_max_min_luma_coding_block_size
    w.ue(MIN_TB_LOG2 - 2)
    w.ue(max_tb_log2 - MIN_TB_LOG2)
    w.ue(max_tu_depth)   # max_transform_hierarchy_depth_inter
    w.ue(max_tu_depth)   # max_transform_hierarchy_depth_intra
    w.flag(0)            # scaling_list_enabled_flag
    w.flag(1)            # amp_enabled_flag
    w.flag(1 if sao else 0)
    w.flag(0)            # pcm_enabled_flag
    w.ue(0)              # num_short_term_ref_pic_sets
    w.flag(0)            # long_term_ref_pics_present_flag
    w.flag(0)            # sps_temporal_mvp_enabled_flag
    w.flag(1 if strong_intra_smoothing else 0)
    w.flag(0)            # vui_parameters_present_flag
    w.flag(0)            # sps_extension_present_flag
    w.rbsp_trailing()
    return w.to_bytes()


def write_pps(*, sign_hiding: bool, transform_skip: bool,
              deblocking: bool) -> bytes:
    w = BitWriter()
    w.ue(0)              # pps_pic_parameter_set_id
    w.ue(0)              # pps_seq_parameter_set_id
    w.flag(0)            # dependent_slice_segments_enabled_flag
    w.flag(0)            # output_flag_present_flag
    w.u(0, 3)            # num_extra_slice_header_bits
    w.flag(1 if sign_hiding else 0)
    w.flag(0)            # cabac_init_present_flag
    w.ue(0)              # num_ref_idx_l0_default_active_minus1
    w.ue(0)              # num_ref_idx_l1_default_active_minus1
    w.se(0)              # init_qp_minus26
    w.flag(0)            # constrained_intra_pred_flag
    w.flag(1 if transform_skip else 0)
    w.flag(0)            # cu_qp_delta_enabled_flag
    w.se(0)              # pps_cb_qp_offset
    w.se(0)              # pps_cr_qp_offset
    w.flag(0)            # pps_slice_chroma_qp_offsets_present_flag
    w.flag(0)            # weighted_pred_flag
    w.flag(0)            # weighted_bipred_flag
    w.flag(0)            # transquant_bypass_enabled_flag
    w.flag(0)            # tiles_enabled_flag
    w.flag(0)            # entropy_coding_sync_enabled_flag
    w.flag(1)            # pps_loop_filter_across_slices_enabled_flag
    w.flag(1)            # deblocking_filter_control_present_flag
    w.flag(0)            # deblocking_filter_override_enabled_flag
    w.flag(0 if deblocking else 1)  # pps_deblocking_filter_disabled_flag
    if deblocking:
        w.se(0)          # pps_beta_offset_div2
        w.se(0)          # pps_tc_offset_div2
    w.flag(0)            # pps_scaling_list_data_present_flag
    w.flag(0)            # lists_modification_present_flag
    w.ue(0)              # log2_parallel_merge_level_minus2
    w.flag(0)            # slice_segment_header_extension_present_flag
    w.flag(0)            # pps_extension_present_flag
    w.rbsp_trailing()
    return w.to_bytes()


def serialize_hm_slice(trees: List[CuNode], *, width: int, height: int,
                       qp: int, policy: str, ctu_size: int, sign_hiding: bool,
                       max_tu_depth: int, sao_grid,
                       transform_skip: bool) -> bytes:
    """CABAC slice data in HM's exact syntax order (4:0:0): a per-bin
    Python walk of the trees."""
    enc = cabac.CabacEncoder()
    ctx = make_context_states(qp).tolist()
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

    def code_mpm_or_rem(mode, mpms):
        if mode in mpms:
            idx = mpms.index(mode)
            if idx == 0:
                enc.encode_bin_ep(0)
            else:
                enc.encode_bin_ep(1)
                enc.encode_bin_ep(idx - 1)
        else:
            rem = mode
            for m in sorted(mpms, reverse=True):
                if rem > m:
                    rem -= 1
            enc.encode_bins_ep(rem, 5)

    def ser_tu_leaf(tu, mode, tr_depth):
        enc.encode_bin(tu.cbf, ctx,
                       OFFSETS.cbf_luma + (1 if tr_depth == 0 else 0))
        if tu.cbf:
            if transform_skip and tu.n == 4:
                enc.encode_bin(tu.tskip, ctx, OFFSETS.transform_skip)
            syntax.encode_coefficients(
                enc, ctx, tu.coeffs,
                mode if mode != PNNS_MODE else 0, sign_hiding)

    def ser_transform_tree(tx, ty, log2_size, tr_depth, leaves, mode,
                           intra_split):
        max_depth = max_tu_depth + (1 if intra_split else 0)
        size = 1 << log2_size
        if log2_size > MAX_TB_LOG2 or (intra_split and tr_depth == 0):
            split = 1  # inferred, not coded
        elif log2_size > MIN_TB_LOG2 and tr_depth < max_depth:
            split = 0 if (tx, ty, size) in leaves else 1
            enc.encode_bin(split, ctx, OFFSETS.trans_subdiv + (5 - log2_size))
        else:
            split = 0
        if split:
            half = size // 2
            for cx, cy in ((tx, ty), (tx + half, ty), (tx, ty + half),
                           (tx + half, ty + half)):
                ser_transform_tree(cx, cy, log2_size - 1, tr_depth + 1,
                                   leaves, mode, intra_split)
            return
        ser_tu_leaf(leaves[(tx, ty, size)], mode, tr_depth)

    def set_mode(pu):
        mode_map[pu.y // 4:(pu.y + pu.n) // 4,
                 pu.x // 4:(pu.x + pu.n) // 4] = pu.mode

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

        pus = node.pus
        # Intra dir coding: HM groups the leading flags of all PUs first.
        mpm_info = []
        for pu in pus:
            if policy == "switch":
                enc.encode_bin(1 if pu.mode == PNNS_MODE else 0, ctx,
                               OFFSETS.pnns_flag)
                if pu.mode == PNNS_MODE:
                    mpm_info.append(None)
                    # Recorded at once: later PUs of this CU see the PNNS
                    # neighbour exactly as the decoder does.
                    set_mode(pu)
                    continue
            mpms = mpms_at(pu.x, pu.y)
            enc.encode_bin(1 if pu.mode in mpms else 0, ctx,
                           OFFSETS.prev_intra)
            mpm_info.append(mpms)
            # The next PU's MPMs see this mode (parse-order availability,
            # TComDataCU::getIntraDirPredictor).
            set_mode(pu)
        for pu, mpms in zip(pus, mpm_info):
            if mpms is not None:
                code_mpm_or_rem(pu.mode, mpms)

        if node.part_nxn:
            # One CU-level transform tree: inferred split, PU i = quadrant i.
            leaves = {(tu.x, tu.y, tu.n): tu for pu in pus for tu in pu.tus}
            half = size // 2
            log2 = size.bit_length() - 1
            for i, (cx, cy) in enumerate(((x, y), (x + half, y),
                                          (x, y + half),
                                          (x + half, y + half))):
                ser_transform_tree(cx, cy, log2 - 1, 1, leaves, pus[i].mode,
                                   True)
        else:
            pu = pus[0]
            leaves = {(tu.x, tu.y, tu.n): tu for tu in pu.tus}
            ser_transform_tree(x, y, size.bit_length() - 1, 0, leaves,
                               pu.mode, False)
        depth_map[y // 4:(y + size) // 4, x // 4:(x + size) // 4] = depth
        coded[y // 4:(y + size) // 4, x // 4:(x + size) // 4] = True

    n_ctu_y = (height + ctu_size - 1) // ctu_size
    n_ctu_x = (width + ctu_size - 1) // ctu_size
    for cy in range(n_ctu_y):
        for cx in range(n_ctu_x):
            if sao_grid is not None:
                _encode_sao_ctu(enc, ctx, sao_grid, cy, cx)
            ser_cu(trees[cy * n_ctu_x + cx])
            if not (cy == n_ctu_y - 1 and cx == n_ctu_x - 1):
                enc.encode_bin_trm(0)       # end_of_slice_segment_flag
    return enc.terminate_and_finish()


def _sao_payload(enc, p, *, with_class: bool):
    for o in p.offsets:
        sao_mod._encode_offset_mag(enc, abs(o))
    if p.mode == sao_mod.MODE_BO:
        for o in p.offsets:
            if o != 0:
                enc.encode_bin_ep(1 if o < 0 else 0)
        enc.encode_bins_ep(p.type_aux, 5)
    elif with_class:
        enc.encode_bins_ep(p.type_aux, 2)


def _encode_sao_ctu(enc, ctx, grid, cy: int, cx: int):
    """One CTU's luma SAO parameters in HM's order (merge-left, merge-up,
    then type and payload, Rec. 7.3.8.3)."""
    p = grid[cy][cx]
    if cx > 0:
        merge_left = p.key() == grid[cy][cx - 1].key()
        enc.encode_bin(1 if merge_left else 0, ctx, OFFSETS.sao_merge)
        if merge_left:
            return
    if cy > 0:
        merge_up = p.key() == grid[cy - 1][cx].key()
        enc.encode_bin(1 if merge_up else 0, ctx, OFFSETS.sao_merge)
        if merge_up:
            return
    enc.encode_bin(0 if p.mode == sao_mod.MODE_OFF else 1, ctx,
                   OFFSETS.sao_type)
    if p.mode != sao_mod.MODE_OFF:
        enc.encode_bin_ep(1 if p.mode == sao_mod.MODE_EO else 0)
        _sao_payload(enc, p, with_class=True)


def write_decoded_picture_hash_sei(recon: np.ndarray) -> bytes:
    """Suffix SEI with the checksum decoded-picture hash (payload 132) of
    the luma plane."""
    w = BitWriter()
    w.u(132, 8)          # payload type
    w.u(5, 8)            # payload size: hash_type + one 32-bit checksum
    w.u(2, 8)            # hash_type: checksum
    w.u(picture_checksum(recon), 32)
    w.rbsp_trailing()
    return w.to_bytes()


def assemble_hm_stream(result, *, sao_enabled: bool, deblocking: bool,
                       sign_hiding: bool, transform_skip: bool,
                       max_tu_depth: int, sao_grid,
                       strong_intra_smoothing: bool = True,
                       ctu_size: int = 64) -> bytes:
    """EncodeResult -> standard Annex-B HEVC stream decodable by HM
    (4:0:0; the JAX package's `assemble_hm_stream` with chroma=False)."""
    h, w = result.reconstruction.shape
    sps = write_sps(w, h, sao=sao_enabled, max_tu_depth=max_tu_depth,
                    strong_intra_smoothing=strong_intra_smoothing,
                    ctu_size=ctu_size)
    pps = write_pps(sign_hiding=sign_hiding, transform_skip=transform_skip,
                    deblocking=deblocking)

    # Slice header + byte-aligned CABAC payload in one RBSP.
    sh = BitWriter()
    sh.flag(1)                        # first_slice_segment_in_pic_flag
    sh.flag(0)                        # no_output_of_prior_pics_flag
    sh.ue(0)                          # slice_pic_parameter_set_id
    sh.ue(2)                          # slice_type: I
    if sao_enabled:
        sh.flag(1 if sao_grid is not None else 0)  # slice_sao_luma_flag
    sh.se(result.qp - 26)             # slice_qp_delta
    # deblocking_control_present=1, override_enabled=0: nothing more unless
    # the loop-filter-across-slices condition holds.
    if sao_grid is not None or deblocking:
        sh.flag(1)                    # slice_loop_filter_across_slices
    sh.u(1, 1)                        # byte_alignment: alignment bit
    sh.byte_align_zero()
    slice_data = serialize_hm_slice(
        result.ctu_trees, width=w, height=h, qp=result.qp,
        policy=result.policy, ctu_size=ctu_size, sign_hiding=sign_hiding,
        max_tu_depth=max_tu_depth, sao_grid=sao_grid,
        transform_skip=transform_skip)
    sei = write_decoded_picture_hash_sei(result.reconstruction)
    return (_nal(NAL_VPS, VPS_RBSP) + _nal(NAL_SPS, sps) + _nal(NAL_PPS, pps)
            + _nal(NAL_IDR_W_RADL, sh.to_bytes() + slice_data)
            + _nal(NAL_SUFFIX_SEI, sei, long_start=False))
