"""Builds and loads the CUDA kernels of `csrc/` (nvcc -> plain-C shared
libraries, bound with ctypes).

Each source is compiled by its own nvcc process, for sm_90a, into the
port's build directory at first use; `load` starts all of them together
and waits (a few seconds; nothing includes PyTorch's headers).
`--fmad=false` keeps every float a*b+c rounded twice, as the plain
version computes it.  A failed build raises with the compiler's output;
nothing falls back.

  unit_trial.cu   the fused unit trial (`unit_fused.trial_apply`)
  merger_int.cu   the PNN's integer merger (`merger_int.merger_int_forward`)
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

from .. import _build_dir

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NAMES = ("unit_trial", "merger_int")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")
_lock = threading.Lock()
_libs: dict = {}


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin)")


def build(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    return _build_dir.build_once(
        name, (src,), lambda out: [nvcc(), *NVCC_FLAGS, "-o", out, src])


def _bind(name: str, path: str):
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if name == "unit_trial":
        lib.unit_trial.argtypes = [ci, ci, ci] + [vp] * 30
    else:
        lib.merger_int.argtypes = [ci, ci, ci, ci] + [vp] * 5
    getattr(lib, name).restype = ci
    err = getattr(lib, f"{name}_error_string")
    err.restype = ctypes.c_char_p
    err.argtypes = [ci]
    return lib


def load() -> dict:
    """Every kernel library, built on first use (one nvcc per source, run
    at the same time): {name: ctypes library}."""
    with _lock:
        missing = [n for n in NAMES if n not in _libs]
        paths, errors = {}, []

        def run(name):
            try:
                paths[name] = build(name)
            except Exception as e:  # re-raised below, after every build
                errors.append(e)

        threads = [threading.Thread(target=run, args=(n,)) for n in missing]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        for name in missing:
            _libs[name] = _bind(name, paths[name])
        return dict(_libs)


def library(name: str):
    """The loaded library of `csrc/<name>.cu`."""
    return load()[name]


def error_string(name: str, err: int) -> str:
    fn = getattr(library(name), f"{name}_error_string")
    return f"{err} ({fn(err).decode()})"
