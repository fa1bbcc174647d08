"""ctypes bindings of the native CABAC packer (`native/cabac_pack.cpp`)
and of HM's luma deblocking (`native/hm_parse.cpp`).

The port's own bindings of `pack_tree_grids` and `deblock_luma_native`: it
compiles the repository's `native/*.cpp` with g++ into the port's build
directory (`_build/`, keyed by a hash of the sources) at first use and
never writes into `native/`.  There is no Python serializer or
deblocking behind them: if g++ fails, the build raises.
"""

from __future__ import annotations

import ctypes
import glob
import os
import threading

import numpy as np

from .. import _build_dir

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE = os.path.join(_REPO_ROOT, "native")
_lock = threading.Lock()
_lib = None
POLICY_IDS = {"regular": 0, "substitution": 1, "switch": 2}


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_NATIVE, "*.cpp")))


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
            lib.pack_tree_grids.restype = ctypes.c_int64
            lib.pack_tree_grids.argtypes = (
                [i32p] * 14 + [ctypes.c_int32] * 6
                + [ctypes.c_void_p, ctypes.c_int64])
            lib.deblock_luma_native.restype = ctypes.c_int
            lib.deblock_luma_native.argtypes = [
                i32p, ctypes.c_int, ctypes.c_int, i32p, ctypes.c_int,
                ctypes.c_int]
            _lib = lib
    return _lib


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
    out = np.array(plane, dtype=np.int32, order="C")
    tu = np.ascontiguousarray(tu_map, dtype=np.int32)
    h, w = out.shape
    if tu.shape != (h // 4, w // 4):
        raise ValueError(f"tu_map {tu.shape} != {(h // 4, w // 4)}")
    rc = load_library().deblock_luma_native(
        out.ctypes.data, h, w, tu.ctypes.data, tu.shape[1], int(qp))
    if rc != 0:
        raise RuntimeError(f"deblock_luma_native failed with code {rc}")
    return out.astype(plane.dtype)
