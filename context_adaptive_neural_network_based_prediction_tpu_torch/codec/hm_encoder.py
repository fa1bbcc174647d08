"""HEVC Annex-B output of the codec's decided trees (HM-16.15 syntax).

The port's copy of the JAX package's `codec/hm_encoder.py`: it
re-serialises decided `encoder.CuNode` trees and SAO grids into a standard
Annex-B HEVC stream that HM-16.15's TAppDecoderStatic decodes bit-exactly:
VPS / SPS / PPS NALs, an IDR slice in HM's CABAC syntax order (per-CTU SAO
parameters, end_of_slice flags, NxN prev-flag grouping, inferred
transform-tree splits, 4:2:0 chroma cbfs, modes and TBs) and a
decoded-picture-hash suffix SEI, so HM checks the reconstruction itself.
Syntax per `TEncCavlc::codeSPS/codePPS/codeSliceHeader` and `TEncSbac`;
the switch policy's leading PNNS bin per hm_16_15_switch
`TDecSbac.cpp:645-760` (such streams target that modified decoder, not
stock HM).  `encode_frame_hm` (luma) and `encode_frame_hm_420` run the
host RDO encoder (`encoder.FrameEncoder`, with `chroma_enc.ChromaPass` in
its CU trials for 4:2:0) and assemble its stream; the wavefront encoders
assemble theirs from `assemble_hm_stream`.

Scope: I-slices, 4:0:0 or 4:2:0 8-bit, CTU 16-64, TU 4..32, no tiles /
WPP, no scaling lists, no PCM.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import cabac, chroma_enc, deblock, sao as sao_mod, syntax
from .contexts import OFFSETS, make_context_states
from .encoder import MIN_CU, PNNS_MODE, CuNode, FrameEncoder, mpms_switch
from .hm_decoder import chroma_qp_420
from .hm_bitstream import (NAL_IDR_W_RADL, NAL_PPS, NAL_SPS, NAL_SUFFIX_SEI,
                           NAL_VPS, BitWriter, insert_emulation_prevention,
                           picture_checksum)

# Verbatim HM-16.15 VPS RBSP and profile_tier_level (main-RExt monochrome-8,
# level 5.2) as TAppEncoderStatic emits for the reference configuration.
VPS_RBSP = bytes.fromhex("0c01ffff04080000000fc8000000009cf024")
PTL_BYTES = bytes.fromhex("04080000000fc8000000009c")
# Main profile (4:2:0 8-bit), level 5.2 - from TAppEncoderStatic intra_main.cfg.
PTL_BYTES_MAIN = bytes.fromhex("01600000000000000000009c")

MAX_TB_LOG2 = 5
MIN_TB_LOG2 = 2


def _nal(nal_type: int, rbsp: bytes, *, long_start: bool = True) -> bytes:
    header = bytes([(nal_type << 1) & 0x7E, 0x01])
    start = b"\x00\x00\x00\x01" if long_start else b"\x00\x00\x01"
    return start + header + insert_emulation_prevention(rbsp)


def write_sps(width: int, height: int, *, sao: bool, max_tu_depth: int,
              strong_intra_smoothing: bool, ctu_size: int = 64,
              chroma_format_idc: int = 0) -> bytes:
    w = BitWriter()
    w.u(0, 4)            # sps_video_parameter_set_id
    w.u(0, 3)            # sps_max_sub_layers_minus1
    w.flag(1)            # sps_temporal_id_nesting_flag
    ptl = bytearray(PTL_BYTES_MAIN if chroma_format_idc == 1 else PTL_BYTES)
    if ctu_size < 32:
        # Levels >= 5 require CtbSizeY >= 32 (Rec. H.265 A.4.1); declare
        # level 4.1 for CTB-16 streams (covers 1080p).
        ptl[-1] = 123
    for b in ptl:
        w.u(b, 8)
    w.ue(0)              # sps_seq_parameter_set_id
    w.ue(chroma_format_idc)
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
                       max_tu_depth: int, sao_grid, transform_skip: bool,
                       chroma: bool = False, sao_grid_cb=None,
                       sao_grid_cr=None) -> bytes:
    """CABAC slice data in HM's exact syntax order (4:0:0 or 4:2:0): a
    per-bin Python walk of the trees."""
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

    def ser_chroma_tb(node, xc, yc, nc, cbf_cb, cbf_cr):
        tb = node._chroma_index[(xc, yc, nc)]
        cmode = node.chroma.mode
        for cbf, coeffs in ((cbf_cb, tb.coeffs_cb), (cbf_cr, tb.coeffs_cr)):
            if cbf:
                if transform_skip and nc == 4:
                    enc.encode_bin(0, ctx, OFFSETS.transform_skip_chroma)
                syntax.encode_coefficients(enc, ctx, coeffs, cmode,
                                           sign_hiding, channel=syntax.CHROMA)

    def cbf_in(node, tx, ty, size, comp):
        """OR of the component's TB cbfs inside luma region (tx,ty,size)."""
        v = 0
        for tb in node.chroma.tbs:
            if (tx <= 2 * tb.xc < tx + size) and (ty <= 2 * tb.yc < ty + size):
                v |= tb.cbf_cb if comp == 0 else tb.cbf_cr
        return v

    def ser_transform_tree(node, tx, ty, x_base, y_base, log2_size, tr_depth,
                           blk_idx, leaves, mode, intra_split,
                           parent_cb, parent_cr):
        max_depth = max_tu_depth + (1 if intra_split else 0)
        size = 1 << log2_size
        if log2_size > MAX_TB_LOG2 or (intra_split and tr_depth == 0):
            split = 1  # inferred, not coded
        elif log2_size > MIN_TB_LOG2 and tr_depth < max_depth:
            split = 0 if (tx, ty, size) in leaves else 1
            enc.encode_bin(split, ctx, OFFSETS.trans_subdiv + (5 - log2_size))
        else:
            split = 0
        cbf_cb, cbf_cr = parent_cb, parent_cr
        if chroma and log2_size > 2:
            if tr_depth == 0 or parent_cb:
                cbf_cb = cbf_in(node, tx, ty, size, 0)
                enc.encode_bin(cbf_cb, ctx, OFFSETS.cbf_chroma + tr_depth)
            else:
                cbf_cb = 0
            if tr_depth == 0 or parent_cr:
                cbf_cr = cbf_in(node, tx, ty, size, 1)
                enc.encode_bin(cbf_cr, ctx, OFFSETS.cbf_chroma + tr_depth)
            else:
                cbf_cr = 0
        if split:
            half = size // 2
            for i, (cx, cy) in enumerate(((tx, ty), (tx + half, ty),
                                          (tx, ty + half),
                                          (tx + half, ty + half))):
                ser_transform_tree(node, cx, cy, tx, ty, log2_size - 1,
                                   tr_depth + 1, i, leaves, mode, intra_split,
                                   cbf_cb, cbf_cr)
            return
        ser_tu_leaf(leaves[(tx, ty, size)], mode, tr_depth)
        if chroma:
            if log2_size > 2:
                ser_chroma_tb(node, tx // 2, ty // 2, size // 2,
                              cbf_cb, cbf_cr)
            elif blk_idx == 3:
                ser_chroma_tb(node, x_base // 2, y_base // 2, 4,
                              parent_cb, parent_cr)

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
                    # Record immediately: later PUs of this CU must see the
                    # PNNS neighbour exactly as the decoder does.
                    mode_map[pu.y // 4:(pu.y + pu.n) // 4,
                             pu.x // 4:(pu.x + pu.n) // 4] = pu.mode
                    continue
            mpms = mpms_at(pu.x, pu.y)
            enc.encode_bin(1 if pu.mode in mpms else 0, ctx,
                           OFFSETS.prev_intra)
            mpm_info.append(mpms)
            # Record the mode immediately: the next PU's MPMs see it
            # (parse-order availability, TComDataCU::getIntraDirPredictor).
            mode_map[pu.y // 4:(pu.y + pu.n) // 4,
                     pu.x // 4:(pu.x + pu.n) // 4] = pu.mode
        for pu, mpms in zip(pus, mpm_info):
            if mpms is None:
                continue
            code_mpm_or_rem(pu.mode, mpms)
        for pu in pus:
            mode_map[pu.y // 4:(pu.y + pu.n) // 4,
                     pu.x // 4:(pu.x + pu.n) // 4] = pu.mode

        if chroma:
            # intra_chroma_pred_mode: one per CU in 4:2:0.
            node._chroma_index = {(tb.xc, tb.yc, tb.nc): tb
                                  for tb in node.chroma.tbs}
            if node.chroma.mode_index == 4:
                enc.encode_bin(0, ctx, OFFSETS.chroma_pred)
            else:
                enc.encode_bin(1, ctx, OFFSETS.chroma_pred)
                enc.encode_bins_ep(node.chroma.mode_index, 2)
        if node.part_nxn:
            # One CU-level transform tree: inferred split, PU i = quadrant i.
            leaves = {}
            half = size // 2
            for pu in pus:
                for tu in pu.tus:
                    leaves[(tu.x, tu.y, tu.n)] = tu
            log2 = size.bit_length() - 1
            cbf_cb = cbf_cr = 0
            if chroma:
                cbf_cb = cbf_in(node, x, y, size, 0)
                enc.encode_bin(cbf_cb, ctx, OFFSETS.cbf_chroma + 0)
                cbf_cr = cbf_in(node, x, y, size, 1)
                enc.encode_bin(cbf_cr, ctx, OFFSETS.cbf_chroma + 0)
            for i, (cx, cy) in enumerate(((x, y), (x + half, y),
                                          (x, y + half), (x + half, y + half))):
                ser_transform_tree(node, cx, cy, x, y, log2 - 1, 1,
                                   i, leaves, pus[i].mode, True,
                                   cbf_cb, cbf_cr)
        else:
            pu = pus[0]
            leaves = {(tu.x, tu.y, tu.n): tu for tu in pu.tus}
            ser_transform_tree(node, x, y, x, y, size.bit_length() - 1, 0, 0,
                               leaves, pu.mode, False, 1, 1)
        depth_map[y // 4:(y + size) // 4, x // 4:(x + size) // 4] = depth
        coded[y // 4:(y + size) // 4, x // 4:(x + size) // 4] = True

    n_ctu_y = (height + ctu_size - 1) // ctu_size
    n_ctu_x = (width + ctu_size - 1) // ctu_size
    for cy in range(n_ctu_y):
        for cx in range(n_ctu_x):
            if sao_grid is not None or sao_grid_cb is not None:
                _encode_sao_ctu(enc, ctx, sao_grid, cy, cx,
                                sao_grid_cb, sao_grid_cr)
            idx = cy * n_ctu_x + cx
            ser_cu(trees[idx])
            is_last = (cy == n_ctu_y - 1) and (cx == n_ctu_x - 1)
            if not is_last:
                enc.encode_bin_trm(0)
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


def _encode_sao_ctu(enc, ctx, grid, cy: int, cx: int,
                    grid_cb=None, grid_cr=None):
    """Per-CTU SAO parameters in HM's interleaved order (all components;
    merge flags are joint, chroma shares type/EO-class, Rec. 7.3.8.3)."""
    grids = [g for g in (grid, grid_cb, grid_cr) if g is not None]
    if cx > 0:
        merge_left = all(g[cy][cx].key() == g[cy][cx - 1].key() for g in grids)
        enc.encode_bin(1 if merge_left else 0, ctx, OFFSETS.sao_merge)
        if merge_left:
            return
    if cy > 0:
        merge_up = all(g[cy][cx].key() == g[cy - 1][cx].key() for g in grids)
        enc.encode_bin(1 if merge_up else 0, ctx, OFFSETS.sao_merge)
        if merge_up:
            return
    if grid is not None:
        p = grid[cy][cx]
        enc.encode_bin(0 if p.mode == sao_mod.MODE_OFF else 1, ctx,
                       OFFSETS.sao_type)
        if p.mode != sao_mod.MODE_OFF:
            enc.encode_bin_ep(1 if p.mode == sao_mod.MODE_EO else 0)
            _sao_payload(enc, p, with_class=True)
    if grid_cb is not None:
        pcb, pcr = grid_cb[cy][cx], grid_cr[cy][cx]
        enc.encode_bin(0 if pcb.mode == sao_mod.MODE_OFF else 1, ctx,
                       OFFSETS.sao_type)
        if pcb.mode != sao_mod.MODE_OFF:
            enc.encode_bin_ep(1 if pcb.mode == sao_mod.MODE_EO else 0)
            _sao_payload(enc, pcb, with_class=True)
            _sao_payload(enc, pcr, with_class=False)


def write_decoded_picture_hash_sei(recon: np.ndarray,
                                   recon_cb: Optional[np.ndarray] = None,
                                   recon_cr: Optional[np.ndarray] = None) -> bytes:
    """Suffix SEI with the checksum decoded-picture hash (payload 132)."""
    planes = [recon] + [p for p in (recon_cb, recon_cr) if p is not None]
    w = BitWriter()
    w.u(132, 8)          # payload type
    w.u(1 + 4 * len(planes), 8)
    w.u(2, 8)            # hash_type: checksum
    for p in planes:
        w.u(picture_checksum(p), 32)
    w.rbsp_trailing()
    return w.to_bytes()


def assemble_hm_stream(result, *, sao_enabled: bool, deblocking: bool,
                       sign_hiding: bool, transform_skip: bool,
                       max_tu_depth: int, sao_grid,
                       strong_intra_smoothing: bool = True,
                       ctu_size: int = 64, chroma: bool = False,
                       recon_cb=None, recon_cr=None,
                       sao_grid_cb=None, sao_grid_cr=None) -> bytes:
    """EncodeResult -> standard Annex-B HEVC stream decodable by HM."""
    h, w = result.reconstruction.shape
    sps = write_sps(w, h, sao=sao_enabled, max_tu_depth=max_tu_depth,
                    strong_intra_smoothing=strong_intra_smoothing,
                    ctu_size=ctu_size, chroma_format_idc=1 if chroma else 0)
    pps = write_pps(sign_hiding=sign_hiding, transform_skip=transform_skip,
                    deblocking=deblocking)

    # Slice header + byte-aligned CABAC payload in one RBSP.
    sh = BitWriter()
    sh.flag(1)                        # first_slice_segment_in_pic_flag
    sh.flag(0)                        # no_output_of_prior_pics_flag
    sh.ue(0)                          # slice_pic_parameter_set_id
    sh.ue(2)                          # slice_type: I
    sao_chroma_on = chroma and sao_grid_cb is not None
    if sao_enabled:
        sh.flag(1 if sao_grid is not None else 0)  # slice_sao_luma_flag
        if chroma:
            sh.flag(1 if sao_chroma_on else 0)     # slice_sao_chroma_flag
    sh.se(result.qp - 26)             # slice_qp_delta
    # deblocking_control_present=1, override_enabled=0: nothing more unless
    # the loop-filter-across-slices condition holds.
    if (sao_grid is not None) or sao_chroma_on or deblocking:
        sh.flag(1)                    # slice_loop_filter_across_slices
    sh.u(1, 1)                        # byte_alignment: alignment bit
    sh.byte_align_zero()
    slice_data = serialize_hm_slice(
        result.ctu_trees, width=w, height=h, qp=result.qp,
        policy=result.policy, ctu_size=ctu_size, sign_hiding=sign_hiding,
        max_tu_depth=max_tu_depth, sao_grid=sao_grid,
        transform_skip=transform_skip, chroma=chroma,
        sao_grid_cb=sao_grid_cb, sao_grid_cr=sao_grid_cr)
    slice_rbsp = sh.to_bytes() + slice_data

    if chroma:
        sei = write_decoded_picture_hash_sei(result.reconstruction,
                                             recon_cb, recon_cr)
    else:
        sei = write_decoded_picture_hash_sei(result.reconstruction)
    return (_nal(NAL_VPS, VPS_RBSP) + _nal(NAL_SPS, sps) + _nal(NAL_PPS, pps)
            + _nal(NAL_IDR_W_RADL, slice_rbsp)
            + _nal(NAL_SUFFIX_SEI, sei, long_start=False))


def encode_frame_hm_420(ycbcr_or_planes, qp: int,
                        chroma_in_rdo: bool = True, **kwargs) -> tuple:
    """Encodes a 4:2:0 frame into a standard HEVC Main-profile stream.

    Input: (H, W, 3) YCbCr array (chroma subsampled by decimation) or a
    (y, cb, cr) plane tuple with cb/cr at half resolution.  Returns
    (annexb_stream, EncodeResult, recon_cb, recon_cr).

    `chroma_in_rdo=True` (default) folds each CU's best chroma mode cost
    into the luma CU-split RD trial, HM's integrated behaviour
    (TEncCu.cpp:763,1544 xCheckRDCostIntra -> estIntraPredChromaQT);
    False keeps the decoupled post-pass (chroma decided over the frozen
    luma tree).  The PNN forwards run on `device` ("cuda" by default),
    passed on to `FrameEncoder`.
    """
    if isinstance(ycbcr_or_planes, tuple):
        y, cb, cr = ycbcr_or_planes
    else:
        arr = np.asarray(ycbcr_or_planes)
        y = arr[:, :, 0]
        cb = arr[::2, ::2, 1]
        cr = arr[::2, ::2, 2]

    fe = FrameEncoder(y, qp, **kwargs)
    cp = chroma_enc.ChromaPass(cb, cr, qp, lam=fe.lam,
                               sign_hiding=fe.sign_hiding,
                               use_rdoq=fe.use_rdoq,
                               policy=fe.policy, pnn=fe.pnn)
    if chroma_in_rdo:
        cp.est_ctx = make_context_states(qp)
        fe.chroma_rdo = cp
        result = fe.encode()
        rec_cb = cp.recon_cb.astype(np.uint8)
        rec_cr = cp.recon_cr.astype(np.uint8)
    else:
        result = fe.encode()
        rec_cb, rec_cr = cp.run(result.ctu_trees, make_context_states(qp))
    if fe.deblocking:
        rec_cb = deblock.deblock_chroma(rec_cb, fe.tu_map, chroma_qp_420(qp))
        rec_cr = deblock.deblock_chroma(rec_cr, fe.tu_map, chroma_qp_420(qp))
    sao_grid_cb = sao_grid_cr = None
    if fe.sao:
        sao_grid_cb, sao_grid_cr = sao_mod.estimate_frame_chroma(
            cb, rec_cb, cr, rec_cr, fe.ctu // 2, fe.lam)
        rec_cb = sao_mod.apply_sao(rec_cb, sao_grid_cb, fe.ctu // 2)
        rec_cr = sao_mod.apply_sao(rec_cr, sao_grid_cr, fe.ctu // 2)

    stream = assemble_hm_stream(
        result, sao_enabled=fe.sao, deblocking=fe.deblocking,
        sign_hiding=fe.sign_hiding, transform_skip=fe.transform_skip,
        max_tu_depth=fe.max_tu_depth, sao_grid=fe._sao_grid,
        strong_intra_smoothing=fe.strong_smoothing, ctu_size=fe.ctu,
        chroma=True, recon_cb=rec_cb, recon_cr=rec_cr,
        sao_grid_cb=sao_grid_cb, sao_grid_cr=sao_grid_cr)
    return stream, result, rec_cb, rec_cr


def encode_frame_hm(frame_uint8: np.ndarray, qp: int, **kwargs) -> tuple:
    """Encodes a luma frame and returns (annexb_stream, EncodeResult).

    The stream is standard HEVC for policies 'regular'/'substitution'
    (substitution redefines mode 18's *prediction*, so stock HM parses it but
    only the reference's modified decoder reconstructs it correctly); 'switch'
    targets the reference's extended syntax.  The PNN forwards run on
    `device` ("cuda" by default), passed on to `FrameEncoder`.
    """
    fe = FrameEncoder(frame_uint8, qp, **kwargs)
    result = fe.encode()
    stream = assemble_hm_stream(
        result, sao_enabled=fe.sao, deblocking=fe.deblocking,
        sign_hiding=fe.sign_hiding, transform_skip=fe.transform_skip,
        max_tu_depth=fe.max_tu_depth, sao_grid=fe._sao_grid,
        strong_intra_smoothing=fe.strong_smoothing, ctu_size=fe.ctu)
    return stream, result
