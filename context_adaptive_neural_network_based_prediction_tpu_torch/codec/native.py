"""ctypes bindings of the native CABAC packer (`native/cabac_pack.cpp`),
HM's deblocking and slice parser (`native/hm_parse.cpp`), RDOQ
(`native/rdoq.cpp`) and the port's coefficient bit count
(`codec/csrc/count_bits.cpp`).

The port's own bindings of `pack_grid`, `pack_tree_grids`,
`deblock_luma_native`, `deblock_chroma_native`, `rdoq_tu`,
`hm_decode_slice` and `count_coefficient_bits`: it compiles the
repository's `native/*.cpp` and the port's `codec/csrc/*.cpp` with g++
into one library in the port's build directory (`_build/`, keyed by a
hash of the sources) at first use and never writes into `native/`.  No
caller catches their failures: if g++ fails, the build raises, and a
failed call raises.
"""

from __future__ import annotations

import ctypes
import glob
import os
import threading

import numpy as np

from .. import _build_dir
from ..utils.profiling import span

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE = os.path.join(_REPO_ROOT, "native")
_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_lock = threading.Lock()
_lib = None
POLICY_IDS = {"regular": 0, "substitution": 1, "switch": 2}


def sources() -> list[str]:
    return (sorted(glob.glob(os.path.join(_NATIVE, "*.cpp")))
            + sorted(glob.glob(os.path.join(_CSRC, "*.cpp"))))


def build() -> str:
    """Compiles the packer library (if this source hash is not built yet)
    and returns its path."""
    return _build_dir.build_once(
        "cabac_pack", sources(),
        lambda out: ["g++", "-O3", "-shared", "-fPIC", "-o", out]
        + sources())


def load_library():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            i32p = ctypes.c_void_p
            lib.pack_grid.restype = ctypes.c_int64
            lib.pack_grid.argtypes = (
                [i32p] * 2 + [ctypes.c_int32] * 4
                + [ctypes.c_void_p, ctypes.c_int64])
            lib.pack_tree_grids.restype = ctypes.c_int64
            lib.pack_tree_grids.argtypes = (
                [i32p] * 14 + [ctypes.c_int32] * 6
                + [ctypes.c_void_p, ctypes.c_int64])
            for name in ("deblock_luma_native", "deblock_chroma_native"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [i32p, ctypes.c_int, ctypes.c_int, i32p,
                               ctypes.c_int, ctypes.c_int]
            lib.rdoq_tu.restype = ctypes.c_int
            lib.rdoq_tu.argtypes = [
                i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_double, i32p, ctypes.c_int, ctypes.c_int, i32p]
            lib.count_coefficient_bits.restype = ctypes.c_int64
            lib.count_coefficient_bits.argtypes = (
                [i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
                + [i32p] * 3 + [ctypes.c_int] * 8 + [i32p] * 4)
            lib.hm_decode_slice.restype = ctypes.c_int64
            lib.hm_decode_slice.argtypes = (
                [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_int] * 18
                + [i32p] * 6 + [ctypes.c_int64, i32p, ctypes.c_int64, i32p,
                                ctypes.c_void_p])
            _lib = lib
    return _lib


def pack_grid_payload(modes: np.ndarray, qcoeffs: np.ndarray, n: int,
                      qp: int) -> bytes:
    """CABAC payload for a uniform-grid frame (no header): modes (nby,
    nbx), qcoeffs (nby, nbx, n, n), every block a CTU of size n with one
    2Nx2N PU and one TU, no sign hiding (`pack_grid`,
    `native/cabac_pack.cpp:553`, span `pack.native`)."""
    modes = np.ascontiguousarray(modes, dtype=np.int32)
    qcoeffs = np.ascontiguousarray(qcoeffs, dtype=np.int32)
    nby, nbx = modes.shape
    if qcoeffs.shape != (nby, nbx, n, n):
        raise ValueError(f"qcoeffs {qcoeffs.shape} != {(nby, nbx, n, n)}")
    lib = load_library()
    cap = max(qcoeffs.size * 4 + 1024, 1 << 16)
    out = np.empty(cap, dtype=np.uint8)
    with span("pack.native"):
        size = lib.pack_grid(modes.ctypes.data, qcoeffs.ctypes.data, nby,
                             nbx, n, qp, out.ctypes.data, cap)
    if size < 0:
        raise RuntimeError(f"pack_grid failed with code {size}")
    return bytes(out[:size])


def serialize_grid(modes: np.ndarray, qcoeffs: np.ndarray, *, width: int,
                   height: int, n: int, qp: int) -> bytes:
    """The container stream of a uniform-grid frame: the header (CTB = n,
    regular policy, no sign hiding, no loop filters) and
    `pack_grid_payload`.  Span `pack.grid` (children `pack.header` and
    `pack.native`)."""
    from .encoder import stream_header

    with span("pack.grid"):
        with span("pack.header"):
            header = stream_header(
                width=width, height=height, qp=qp, policy="regular",
                ctu_size=n, sign_hiding=False)
        return header + pack_grid_payload(modes, qcoeffs, n, qp)


def pack_tree_payload(grids, *, width: int, height: int, qp: int,
                      ctu_size: int, policy: str,
                      sign_hiding: bool = True) -> bytes:
    """CABAC payload for a wavefront2 decided-grid frame (no header).

    `grids` is the `_assemble_arrays` tuple (m8, q8, s8, m4, q4, m16, q16,
    s16, m32, q32, s32), with (m64, q64, s64) after it at CTB 64."""
    if len(grids) != (14 if ctu_size == 64 else 11):
        raise ValueError(f"CTB {ctu_size} packs "
                         f"{14 if ctu_size == 64 else 11} grids, got "
                         f"{len(grids)}")
    (m8, q8, s8, m4, q4, m16, q16, s16, m32, q32, s32) = grids[:11]
    lib = load_library()
    keep = [np.ascontiguousarray(a, dtype=np.int32)
            for a in (m4, q4, m8, q8, s8, m16, q16, s16, m32, q32, s32)
            + tuple(grids[11:])]
    ptrs = [a.ctypes.data for a in keep] + [None] * (14 - len(keep))
    cap = max(width * height * 4, 1 << 16)
    out = np.empty(cap, dtype=np.uint8)
    size = lib.pack_tree_grids(
        *ptrs, width, height, qp, ctu_size, POLICY_IDS[policy],
        1 if sign_hiding else 0, out.ctypes.data, cap)
    if size < 0:
        raise RuntimeError(f"pack_tree_grids failed with code {size}")
    return bytes(out[:size])


def deblock_luma(plane: np.ndarray, tu_map: np.ndarray, qp: int
                 ) -> np.ndarray:
    """HM's luma deblocking (`deblock_luma_native`,
    `native/hm_parse.cpp:1554`) of an 8-bit plane: a new array of the
    plane's dtype.  Raises if the library does not build or the call
    fails."""
    h, w = np.shape(plane)
    if np.shape(tu_map) != (h // 4, w // 4):
        raise ValueError(f"tu_map {np.shape(tu_map)} != {(h // 4, w // 4)}")
    return _deblock(plane, tu_map, qp, "deblock_luma_native")


def deblock_chroma(plane: np.ndarray, tu_map_luma: np.ndarray, qp_c: int
                   ) -> np.ndarray:
    """HM's deblocking of one 4:2:0 chroma plane (`deblock_chroma_native`)
    with the luma-resolution 4x4-unit TU map; as `deblock_luma`."""
    return _deblock(plane, tu_map_luma, qp_c, "deblock_chroma_native")


def _deblock(plane, tu_map, qp, name):
    out = np.array(plane, dtype=np.int32, order="C")
    tu = np.ascontiguousarray(tu_map, dtype=np.int32)
    h, w = out.shape
    rc = getattr(load_library(), name)(
        out.ctypes.data, h, w, tu.ctypes.data, tu.shape[1], int(qp))
    if rc != 0:
        raise RuntimeError(f"{name} failed with code {rc}")
    return out.astype(plane.dtype)


def rdoq_tu_native(coeffs: np.ndarray, qp: int, mode: int, lam: float,
                   ctx_states, cbf_ctx_offset: int,
                   sign_hiding: bool) -> np.ndarray:
    """RDOQ of one luma TU (`rdoq_tu`, `native/rdoq.cpp`; equal output to
    `rdoq.rdoq_python`).  Raises if the call fails."""
    n = coeffs.shape[0]
    coeffs = np.ascontiguousarray(coeffs, dtype=np.int32)
    ctx = np.ascontiguousarray(ctx_states, dtype=np.int32)
    out = np.empty((n, n), dtype=np.int32)
    rc = load_library().rdoq_tu(
        coeffs.ctypes.data, n, qp, mode, float(lam), ctx.ctypes.data,
        int(cbf_ctx_offset), 1 if sign_hiding else 0, out.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"rdoq_tu failed with code {rc}")
    return out


def count_coefficient_bits(coeffs: np.ndarray, ctx: np.ndarray,
                           table_ptrs: tuple, params: tuple) -> int:
    """The bits (15-bit fixed point) of one non-empty TU's coefficients,
    as `rdo.BitCounter` counts `syntax.encode_coefficients`' bins
    (`count_coefficient_bits`, `codec/csrc/count_bits.cpp`); `ctx`, an
    int32 array, is advanced in place.  `table_ptrs`: the addresses of
    int32 arrays the caller keeps alive, the scan, the CG scan, the
    (4, n*n) sig_coeff_flag contexts and the entropy and next-state
    tables; `params`: scan_ver, sign_hiding and the channel's context
    offsets (`rdo.BitCounter.count_coefficients`).  Raises if the TU is
    empty or the call fails."""
    if not (isinstance(ctx, np.ndarray) and ctx.dtype == np.int32
            and ctx.flags.c_contiguous and ctx.flags.writeable):
        raise TypeError("ctx must be a writeable contiguous int32 array")
    coeffs = np.ascontiguousarray(coeffs, dtype=np.int32)
    bits = load_library().count_coefficient_bits(
        coeffs.ctypes.data, coeffs.shape[0], *params[:2], *table_ptrs[:3],
        *params[2:], ctx.ctypes.data, *table_ptrs[3:])
    if bits < 0:
        raise RuntimeError(f"count_coefficient_bits failed with code {bits}")
    return int(bits)


def hm_decode_slice_native(slice_data: bytes, *, width: int, height: int,
                           ctu_size: int, log2_min_cb: int, log2_max_tb: int,
                           log2_min_tb: int, max_tr_depth_intra: int,
                           chroma: bool, qp: int, qp_cb: int = 0,
                           qp_cr: int = 0, transform_skip_enabled: bool = True,
                           sign_data_hiding: bool = True,
                           sao_luma: bool = False, sao_chroma: bool = False,
                           strong_intra_smoothing: bool = True,
                           policy: int = 0, reconstruct: bool = True) -> dict:
    """Parses (and for policy 0 optionally reconstructs) one I-slice
    (`hm_decode_slice`, `native/hm_parse.cpp`; JAX package
    `codec/native.py:162`).

    Returns a dict with: recon_y/cb/cr (int32 planes or None), mode_map,
    tu_map ((H+3)//4 x (W+3)//4 int32), tu_meta ((n_tu, 8) int32 records
    [plane, x, y, n, mode, cbf, tskip, coef_off]), coeffs (flat int32), and
    sao ((n_ctu, 3, 6) int32 [mode, aux, o0..o3] per component).  Raises if
    the call fails."""
    data = np.frombuffer(slice_data, dtype=np.uint8)
    uh, uw = (height + 3) // 4, (width + 3) // 4
    n_ctu = ((height + ctu_size - 1) // ctu_size) * \
        ((width + ctu_size - 1) // ctu_size)
    recon_y = np.zeros((height, width), dtype=np.int32)
    recon_cb = (np.zeros((height // 2, width // 2), dtype=np.int32)
                if chroma else np.zeros((1, 1), dtype=np.int32))
    recon_cr = np.zeros_like(recon_cb)
    mode_map = np.empty((uh, uw), dtype=np.int32)
    tu_map = np.empty((uh, uw), dtype=np.int32)
    tu_meta_cap = (width * height) // 8 + 4096
    tu_meta = np.empty((tu_meta_cap, 8), dtype=np.int32)
    coeff_cap = width * height * 2 + 4096
    coeff_buf = np.empty(coeff_cap, dtype=np.int32)
    sao_out = np.zeros((n_ctu, 3, 6), dtype=np.int32)
    counts = np.zeros(2, dtype=np.int64)
    rc = load_library().hm_decode_slice(
        data.ctypes.data, len(data), width, height, ctu_size, log2_min_cb,
        log2_max_tb, log2_min_tb, max_tr_depth_intra, 1 if chroma else 0,
        qp, qp_cb, qp_cr, 1 if transform_skip_enabled else 0,
        1 if sign_data_hiding else 0, 1 if sao_luma else 0,
        1 if sao_chroma else 0, 1 if strong_intra_smoothing else 0,
        int(policy), 1 if reconstruct else 0,
        recon_y.ctypes.data, recon_cb.ctypes.data, recon_cr.ctypes.data,
        mode_map.ctypes.data, tu_map.ctypes.data, tu_meta.ctypes.data,
        tu_meta_cap, coeff_buf.ctypes.data, coeff_cap, sao_out.ctypes.data,
        counts.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"hm_decode_slice failed with code {rc}")
    n_tu, n_coeff = int(counts[0]), int(counts[1])
    return {
        "recon_y": recon_y if reconstruct else None,
        "recon_cb": recon_cb if (reconstruct and chroma) else None,
        "recon_cr": recon_cr if (reconstruct and chroma) else None,
        "mode_map": mode_map,
        "tu_map": tu_map,
        "tu_meta": tu_meta[:n_tu].copy(),
        "coeffs": coeff_buf[:n_coeff].copy(),
        "sao": sao_out,
    }
