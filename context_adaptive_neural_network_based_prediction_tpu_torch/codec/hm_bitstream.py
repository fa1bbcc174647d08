"""HEVC Annex-B bitstream framing and header parsing and writing.

The port's copy of the JAX package's `codec/hm_bitstream.py`: NAL unit
splitting, emulation prevention, the fixed-length / ue(v) / se(v) bit
reader and writer, the parsers and writers of the parameter sets and slice
segment headers that HM-16.15 emits for All-Intra 4:0:0 or 4:2:0, and the
decoded-picture-hash SEI (payload type 132), so a decode can be checked
against the hash the stream carries.  Field order follows Rec. ITU-T
H.265, as HM's `TDecCAVLC::parseSPS/parsePPS/parseSliceHeader` consume it
and `TEncCavlc::codeSPS/codePPS/codeSliceHeader` emit it.  The writer half
serves `hm_encoder.py`, the parser half `hm_decoder.py`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

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

IRAP_TYPES = set(range(16, 24))
SLICE_TYPES = IRAP_TYPES | set(range(0, 10))


def remove_emulation_prevention(data: bytes) -> bytes:
    """Strips emulation_prevention_three_byte (00 00 03 -> 00 00)."""
    out = bytearray()
    zeros = 0
    i = 0
    n = len(data)
    while i < n:
        b = data[i]
        if zeros >= 2 and b == 3:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


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


@dataclass
class NalUnit:
    nal_type: int
    nuh_layer_id: int
    temporal_id: int
    rbsp: bytes  # emulation prevention removed, header stripped


def split_annexb(stream: bytes) -> List[NalUnit]:
    """Splits an Annex-B byte stream (start codes 00 00 01 / 00 00 00 01)."""
    units = []
    i = 0
    n = len(stream)
    starts = []
    while i + 2 < n:
        if stream[i] == 0 and stream[i + 1] == 0 and stream[i + 2] == 1:
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    starts.append(None)
    for k in range(len(starts) - 1):
        begin = starts[k]
        end = starts[k + 1]
        if end is None:
            payload = stream[begin:]
        else:
            payload = stream[begin:end - 3]
            # Strip the leading zero(s) of a 4-byte start code / trailing_zero_8bits.
            while payload and payload[-1] == 0:
                payload = payload[:-1]
        if len(payload) < 2:
            continue
        header = (payload[0] << 8) | payload[1]
        nal_type = (header >> 9) & 0x3F
        layer_id = (header >> 3) & 0x3F
        tid = header & 0x7
        units.append(NalUnit(nal_type, layer_id, tid,
                             remove_emulation_prevention(payload[2:])))
    return units


class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def flag(self) -> int:
        return self.u(1)

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 40:
                raise ValueError("corrupt ue(v)")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if (k & 1) else -(k // 2)

    def byte_align(self):
        """byte_alignment(): alignment_bit_equal_to_one + zero bits.

        The one-bit is ALWAYS present (Rec. 7.3.2.10) - even when the reader
        is already byte-aligned a full alignment byte follows."""
        if self.u(1) != 1:
            raise ValueError("alignment bit is not 1")
        while self.pos & 7:
            self.pos += 1

    def remaining_bytes(self) -> bytes:
        assert (self.pos & 7) == 0
        return self.data[self.pos >> 3:]


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
        assert len(self.bits) % 8 == 0
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            b = 0
            for bit in self.bits[i:i + 8]:
                b = (b << 1) | bit
            out.append(b)
        return bytes(out)


# ------------------------------------------------------------------- SPS ----

@dataclass
class Sps:
    width: int = 0
    height: int = 0
    chroma_format_idc: int = 1
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8
    log2_min_cb: int = 3
    log2_max_cb: int = 6
    log2_min_tb: int = 2
    log2_max_tb: int = 5
    max_transform_hierarchy_depth_intra: int = 3
    max_transform_hierarchy_depth_inter: int = 3
    scaling_list_enabled: bool = False
    amp_enabled: bool = True
    sao_enabled: bool = True
    pcm_enabled: bool = False
    strong_intra_smoothing: bool = True
    log2_max_poc_lsb: int = 8
    conf_win: Tuple[int, int, int, int] = (0, 0, 0, 0)  # l, r, t, b

    @property
    def ctu_size(self) -> int:
        return 1 << self.log2_max_cb


def _parse_ptl(r: BitReader):
    """profile_tier_level with no sub-layers: fixed 12 bytes."""
    r.u(8)    # profile_space/tier/profile_idc
    r.u(32)   # compatibility flags
    r.u(32)   # source flags + constraint flags (first 32 of 44)
    r.u(16)   # remaining 12 constraint bits + inbld  (44+4? -> total 48)
    r.u(8)    # level_idc
    # Layout check: 2+1+5 + 32 + 4+43+1 + 8 = 96 bits = 12 bytes.


def _write_ptl(w: BitWriter, profile_idc: int, level_idc: int,
               compat: int, constraint_bits: int = 0):
    w.u(0, 2)             # profile_space
    w.flag(0)             # tier
    w.u(profile_idc, 5)
    w.u(compat, 32)
    w.flag(1)             # progressive_source
    w.flag(0)             # interlaced_source
    w.flag(0)             # non_packed
    w.flag(1)             # frame_only
    w.u(constraint_bits, 44)  # profile-specific constraint flags + reserved + inbld
    w.u(level_idc, 8)


def parse_sps(rbsp: bytes) -> Sps:
    r = BitReader(rbsp)
    s = Sps()
    r.u(4)           # sps_video_parameter_set_id
    max_sub_layers = r.u(3)
    r.flag()         # temporal_id_nesting
    _parse_ptl(r)
    if max_sub_layers != 0:
        raise ValueError("sub-layers unsupported")
    r.ue()           # sps_seq_parameter_set_id
    s.chroma_format_idc = r.ue()
    if s.chroma_format_idc == 3:
        r.flag()
    s.width = r.ue()
    s.height = r.ue()
    if r.flag():     # conformance_window_flag
        s.conf_win = (r.ue(), r.ue(), r.ue(), r.ue())
    s.bit_depth_luma = 8 + r.ue()
    s.bit_depth_chroma = 8 + r.ue()
    s.log2_max_poc_lsb = 4 + r.ue()
    sub_layer_ordering = r.flag()
    for _ in range((max_sub_layers + 1) if sub_layer_ordering else 1):
        r.ue(), r.ue(), r.ue()
    s.log2_min_cb = 3 + r.ue()
    s.log2_max_cb = s.log2_min_cb + r.ue()
    s.log2_min_tb = 2 + r.ue()
    s.log2_max_tb = s.log2_min_tb + r.ue()
    s.max_transform_hierarchy_depth_inter = r.ue()
    s.max_transform_hierarchy_depth_intra = r.ue()
    s.scaling_list_enabled = bool(r.flag())
    if s.scaling_list_enabled:
        if r.flag():
            raise ValueError("explicit scaling lists unsupported")
    s.amp_enabled = bool(r.flag())
    s.sao_enabled = bool(r.flag())
    s.pcm_enabled = bool(r.flag())
    if s.pcm_enabled:
        raise ValueError("PCM unsupported")
    num_st_rps = r.ue()
    for idx in range(num_st_rps):
        _skip_st_ref_pic_set(r, idx)
    if r.flag():     # long_term_ref_pics_present
        for _ in range(r.ue()):
            r.u(s.log2_max_poc_lsb)
            r.flag()
    r.flag()         # sps_temporal_mvp_enabled
    s.strong_intra_smoothing = bool(r.flag())
    if r.flag():     # vui_parameters_present
        _skip_vui(r)
    r.flag()         # sps_extension_present (assume 0 or ignorable)
    return s


def _skip_st_ref_pic_set(r: BitReader, idx: int):
    """Skips one st_ref_pic_set (SPS context; no inter-RPS prediction
    supported, which HM only uses with GOP structures)."""
    predicted = r.flag() if idx != 0 else 0
    if predicted:
        r.flag()  # delta_rps_sign
        r.ue()    # abs_delta_rps_minus1
        raise ValueError("inter-RPS-predicted ref pic sets unsupported")
    num_neg = r.ue()
    num_pos = r.ue()
    for _ in range(num_neg + num_pos):
        r.ue()
        r.flag()


def _skip_vui(r: BitReader):
    if r.flag():  # aspect_ratio_info
        idc = r.u(8)
        if idc == 255:
            r.u(16), r.u(16)
    if r.flag():  # overscan
        r.flag()
    if r.flag():  # video_signal_type
        r.u(3), r.flag()
        if r.flag():
            r.u(8), r.u(8), r.u(8)
    if r.flag():  # chroma_loc
        r.ue(), r.ue()
    r.flag()  # neutral_chroma
    r.flag()  # field_seq
    r.flag()  # frame_field_info
    if r.flag():  # default_display_window
        r.ue(), r.ue(), r.ue(), r.ue()
    if r.flag():  # timing_info
        r.u(32), r.u(32)
        if r.flag():
            r.ue()
        if r.flag():
            raise ValueError("HRD parameters unsupported")
    if r.flag():  # bitstream_restriction
        r.flag(), r.flag(), r.flag()
        r.ue(), r.ue(), r.ue(), r.ue(), r.ue()


# ------------------------------------------------------------------- PPS ----

@dataclass
class Pps:
    sign_data_hiding: bool = True
    init_qp: int = 26
    constrained_intra_pred: bool = False
    transform_skip_enabled: bool = True
    cu_qp_delta_enabled: bool = False
    diff_cu_qp_delta_depth: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    slice_chroma_qp_offsets_present: bool = False
    transquant_bypass_enabled: bool = False
    tiles_enabled: bool = False
    entropy_coding_sync: bool = False
    loop_filter_across_slices: bool = True
    deblocking_control_present: bool = False
    deblocking_override_enabled: bool = False
    deblocking_disabled: bool = False
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    slice_header_extension: bool = False
    output_flag_present: bool = False
    num_extra_slice_header_bits: int = 0
    cabac_init_present: bool = False
    lists_modification_present: bool = False


def parse_pps(rbsp: bytes) -> Pps:
    r = BitReader(rbsp)
    p = Pps()
    r.ue()  # pps id
    r.ue()  # sps id
    if r.flag():
        raise ValueError("dependent slice segments unsupported")
    p.output_flag_present = bool(r.flag())
    p.num_extra_slice_header_bits = r.u(3)
    p.sign_data_hiding = bool(r.flag())
    p.cabac_init_present = bool(r.flag())
    r.ue(), r.ue()  # num_ref_idx defaults
    p.init_qp = 26 + r.se()
    p.constrained_intra_pred = bool(r.flag())
    p.transform_skip_enabled = bool(r.flag())
    p.cu_qp_delta_enabled = bool(r.flag())
    if p.cu_qp_delta_enabled:
        p.diff_cu_qp_delta_depth = r.ue()
    p.cb_qp_offset = r.se()
    p.cr_qp_offset = r.se()
    p.slice_chroma_qp_offsets_present = bool(r.flag())
    r.flag(), r.flag()  # weighted pred flags
    p.transquant_bypass_enabled = bool(r.flag())
    p.tiles_enabled = bool(r.flag())
    p.entropy_coding_sync = bool(r.flag())
    if p.tiles_enabled:
        raise ValueError("tiles unsupported")
    p.loop_filter_across_slices = bool(r.flag())
    p.deblocking_control_present = bool(r.flag())
    if p.deblocking_control_present:
        p.deblocking_override_enabled = bool(r.flag())
        p.deblocking_disabled = bool(r.flag())
        if not p.deblocking_disabled:
            p.beta_offset_div2 = r.se()
            p.tc_offset_div2 = r.se()
    if r.flag():
        raise ValueError("PPS scaling lists unsupported")
    p.lists_modification_present = bool(r.flag())
    r.ue()  # log2_parallel_merge_level_minus2
    p.slice_header_extension = bool(r.flag())
    r.flag()  # pps_extension_present
    return p


# ---------------------------------------------------------- slice header ----

@dataclass
class SliceHeader:
    slice_type: int = 2  # 2 = I
    qp: int = 32
    sao_luma: bool = False
    sao_chroma: bool = False
    deblocking_disabled: bool = False
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    first_slice: bool = True
    slice_data: bytes = b""


def parse_slice_header(rbsp: bytes, nal_type: int, sps: Sps, pps: Pps) -> SliceHeader:
    r = BitReader(rbsp)
    sh = SliceHeader()
    sh.first_slice = bool(r.flag())
    if nal_type in IRAP_TYPES:
        r.flag()  # no_output_of_prior_pics
    r.ue()        # slice_pic_parameter_set_id
    if not sh.first_slice:
        raise ValueError("multi-slice pictures unsupported")
    for _ in range(pps.num_extra_slice_header_bits):
        r.flag()
    sh.slice_type = r.ue()
    if pps.output_flag_present:
        r.flag()
    if nal_type not in (NAL_IDR_W_RADL, NAL_IDR_N_LP):
        raise ValueError("only IDR slices supported (All-Intra)")
    if sh.slice_type != 2:
        raise ValueError("only I slices supported")
    if sps.sao_enabled:
        sh.sao_luma = bool(r.flag())
        if sps.chroma_format_idc != 0:
            sh.sao_chroma = bool(r.flag())
    sh.qp = pps.init_qp + r.se()
    if pps.slice_chroma_qp_offsets_present:
        r.se(), r.se()
    sh.deblocking_disabled = pps.deblocking_disabled
    sh.beta_offset_div2 = pps.beta_offset_div2
    sh.tc_offset_div2 = pps.tc_offset_div2
    if pps.deblocking_control_present:
        override = r.flag() if pps.deblocking_override_enabled else 0
        if override:
            sh.deblocking_disabled = bool(r.flag())
            if not sh.deblocking_disabled:
                sh.beta_offset_div2 = r.se()
                sh.tc_offset_div2 = r.se()
    if pps.loop_filter_across_slices and (
            sh.sao_luma or sh.sao_chroma or not sh.deblocking_disabled):
        r.flag()  # slice_loop_filter_across_slices_enabled_flag
    if pps.tiles_enabled or pps.entropy_coding_sync:
        n = r.ue()
        if n:
            raise ValueError("entry points unsupported")
    if pps.slice_header_extension:
        for _ in range(r.ue()):
            r.u(8)
    r.byte_align()  # byte_alignment(): alignment_bit_equal_to_one + zeros
    sh.slice_data = r.remaining_bytes()
    return sh


# ------------------------------------------------------------------- SEI ----

def parse_decoded_picture_hash(units: List[NalUnit]) -> Optional[Tuple[int, List[int]]]:
    """Returns (hash_type, per-plane values) from the suffix SEI, if present.

    hash_type 2 = checksum (HM SEIDecodedPictureHash: 3 -> checksum), value is
    the 32-bit picture checksum per colour plane (Rec. H.265 D.3.19).
    """
    for nal in units:
        if nal.nal_type != NAL_SUFFIX_SEI:
            continue
        r = BitReader(nal.rbsp)
        payload_type = 0
        while True:
            b = r.u(8)
            payload_type += b
            if b != 0xFF:
                break
        payload_size = 0
        while True:
            b = r.u(8)
            payload_size += b
            if b != 0xFF:
                break
        if payload_type != 132:
            continue
        hash_type = r.u(8)
        values = []
        remaining = payload_size - 1
        if hash_type == 0:      # MD5: 16 bytes per plane
            while remaining >= 16:
                values.append(int.from_bytes(
                    bytes(r.u(8) for _ in range(16)), "big"))
                remaining -= 16
        elif hash_type == 1:    # CRC: 2 bytes per plane
            while remaining >= 2:
                values.append(r.u(16))
                remaining -= 2
        else:                   # checksum: 4 bytes per plane
            while remaining >= 4:
                values.append(r.u(32))
                remaining -= 4
        return hash_type, values
    return None


def picture_checksum(plane: np.ndarray) -> int:
    """Rec. H.265 (D.3.19) picture checksum of one 8-bit plane."""
    h, w = plane.shape
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    xor_mask = ((xx & 0xFF) ^ ((xx >> 8) & 0xFF) ^ (yy & 0xFF) ^ ((yy >> 8) & 0xFF))
    return int(np.sum(plane.astype(np.uint32) ^ xor_mask).astype(np.uint32)
               & np.uint32(0xFFFFFFFF))


# --------------------------------------------------------------- streams ----

@dataclass
class HmStream:
    sps: Sps
    pps: Pps
    slice_header: SliceHeader
    nal_units: List[NalUnit] = field(default_factory=list)
    picture_hash: Optional[Tuple[int, List[int]]] = None


def parse_stream(annexb: bytes) -> HmStream:
    units = split_annexb(annexb)
    sps = pps = None
    sh = None
    for nal in units:
        if nal.nal_type == NAL_SPS:
            sps = parse_sps(nal.rbsp)
        elif nal.nal_type == NAL_PPS:
            pps = parse_pps(nal.rbsp)
        elif nal.nal_type in SLICE_TYPES:
            if sps is None or pps is None:
                raise ValueError("slice before parameter sets")
            sh = parse_slice_header(nal.rbsp, nal.nal_type, sps, pps)
    if sh is None:
        raise ValueError("no slice found")
    return HmStream(sps=sps, pps=pps, slice_header=sh, nal_units=units,
                    picture_hash=parse_decoded_picture_hash(units))
