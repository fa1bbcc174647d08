"""Builds and loads the CUDA kernels of `csrc/` (nvcc -> plain-C shared
libraries, bound with ctypes).

Each source is compiled by its own nvcc process, for sm_90a, into the
port's build directory at first use; `load` starts the ones asked for
(all by default) together and waits (a few seconds; nothing includes
PyTorch's headers), and `library` builds one alone.  Flags are given per
source: the unit trial and the v1 step are built with `--fmad=false`,
which keeps every float a*b+c rounded twice, as their plain versions
compute it (the integer merger keeps the flag it was first built with);
the float PNN kernels are held to a tolerance and keep nvcc's fused
multiply-adds, at twice the rate.  `-Xptxas -v` puts each kernel's
registers and spills in `_build_dir.output`.  A failed build raises with
the compiler's output; nothing falls back.  Only the toolkit's own
headers are included (no CUTLASS or CuTe): the FC kernel writes its
`wgmma`, TMA and `mbarrier` instructions as inline PTX and gets
`cuTensorMapEncodeTiled` through the runtime's driver entry point, so
nothing links against libcuda.

  unit_trial.cu   the fused unit trial (`unit_fused.trial_apply`): one
                  launch per call, modes on warp lanes, the n = 16 / 32
                  transforms on the FP64 tensor cores
  merger_int.cu   the PNN's integer merger (`merger_int.merger_int_forward`):
                  weights laid out (P, M, O) once, vector loads
  fc_forward.cu   the float FC PNN's layers (`fc_forward.fc_forward`):
                  tensor cores, split TF32, TMA ring
  merger.cu       the float channelwise merger (`merger.merger_forward`):
                  weights staged in shared memory, blocks walk slots
  v1_step.cu      one step of the v1 wavefront (`v1_step.stepper`): a
                  thread block a coded block, the 35 modes on teams of
                  n threads, int32 butterflies
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import torch

from .. import _build_dir

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
SOURCE_FLAGS = {"unit_trial": ("--fmad=false",),
                "merger_int": ("--fmad=false",),
                "fc_forward": (),
                "merger": (),
                "v1_step": ("--fmad=false",)}
NAMES = tuple(SOURCE_FLAGS)
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
        name, (src,), lambda out: [nvcc(), *NVCC_FLAGS, *SOURCE_FLAGS[name],
                                   "-o", out, src])


def _bind(name: str, path: str):
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib_args = {"unit_trial": [ci, ci] + [vp] * 9,
                "merger_int": [ci, ci, ci] + [vp] * 5,
                "fc_forward": [ci] * 6 + [vp] * 7,
                "merger": [ci] * 6 + [vp] * 5,
                "v1_step": [ci] * 17 + [ctypes.c_ulonglong, ctypes.c_float]
                + [vp] * 7}
    getattr(lib, name).argtypes = lib_args[name]
    getattr(lib, name).restype = ci
    err = getattr(lib, f"{name}_error_string")
    err.restype = ctypes.c_char_p
    err.argtypes = [ci]
    return lib


def load(names=NAMES) -> dict:
    """The kernel libraries `names` (every one by default), each built on
    first use (one nvcc per source, run at the same time): {name: ctypes
    library} of every library loaded so far."""
    with _lock:
        missing = [n for n in names if n not in _libs]
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
    """The library of `csrc/<name>.cu`, built and loaded alone on first
    use."""
    lib = _libs.get(name)
    return lib if lib is not None else load((name,))[name]


def check_tensor(name, t, shape, dtypes, device):
    """Raises ValueError unless `t` is a contiguous tensor of one of
    `dtypes`, of `shape`, on `device`: what a kernel takes as a pointer."""
    if t.device != device or t.dtype not in dtypes \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtypes} {tuple(shape)} "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device} (contiguous={t.is_contiguous()})")


def refuse_autograd(name, *tensors):
    """Raises RuntimeError when grad mode is on and one of `tensors`
    requires grad: a kernel's output has no `grad_fn`, so training through
    its wrapper would silently train nothing on the card."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward; differentiate its plain "
            f"version (pnn.forward_train) or run under torch.no_grad()")


def error_string(name: str, err: int) -> str:
    fn = getattr(library(name), f"{name}_error_string")
    return f"{err} ({fn(err).decode()})"
