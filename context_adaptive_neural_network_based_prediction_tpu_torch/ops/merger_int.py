"""Integer channelwise merger of the quantized PNN: the plain PyTorch
version and the wrapper of the hand-written CUDA kernel.

out[m, n, o] = b[o, m] + sum_p x[n, p, m] * w[p, o, m], exact int32: the
per-feature-map FC that merges the above and left branches of the
convolutional PNN (`models/pnn_q.forward_q`).  It replaces the JAX
package's TPU kernel `merger_int_forward`
(`ops/pallas/merger_int.py:63`).  Shapes on the codec path: N = 31
wavefront slots, P = 80 context positions, O = 16 outputs, M = 32, 64,
128 or 256 maps (PNN widths 4, 8, 16, 32).

* `merger_plain`: an int64 broadcast product and sum; runs on the CPU and
  the card.
* `merger_int_forward`: CPU tensors take the plain version; CUDA tensors
  launch the kernel of `csrc/merger_int.cu` (a failed build or launch
  raises), or the plain version when `impl="plain"` (for comparing).
  `launches[M]` counts the kernel's launches per map count.

The kernel reads the weights as (P, M, O), each map's 16 outputs of one
position contiguous: `prepare_weight` makes that layout once per weight
tensor, checks the weights and biases then, and keeps it while the tensor
lives and is not changed in place.  Per call the wrapper checks only x.
"""

from __future__ import annotations

import torch
import torch.utils.weak

from . import _cuda_build

O_OUT = 16          # outputs per map, the kernel's only width

# Launches of the CUDA kernel, per map count M, counted where the wrapper
# launches it.  `reset_launch_counts` empties it.
launches: dict = {}
_prepared = torch.utils.weak.WeakIdKeyDictionary()


def reset_launch_counts():
    launches.clear()


def merger_plain(x, w, b):
    """x (N, P, M) int16, w (P, O, M) int16, b (O, M) int32 -> (M, N, O)
    int32, by an int64 broadcast product and sum."""
    acc = (x.to(torch.int64)[:, :, None, :]
           * w.to(torch.int64)[None]).sum(dim=1)          # (N, O, M)
    acc = acc + b.to(torch.int64)[None]
    return acc.permute(2, 0, 1).to(torch.int32).contiguous()


def _check(name, t, shape, dtype, device):
    _cuda_build.check_tensor(name, t, shape, (dtype,), device)


def prepare_weight(w, b):
    """The kernel's weight layout (P, M, O) int16 of `w` (P, O, M), on its
    device.  Checks w and b (O, M) int32 and makes the layout once per
    weight tensor, and again after an in-place change of it or for
    another bias."""
    got = _prepared.get(w)
    if got is not None and got[0] == w._version and got[1] is b \
            and got[2] == b._version:
        return got[3]
    p, o, m = w.shape
    _check("w", w, (p, o, m), torch.int16, w.device)
    _check("b", b, (o, m), torch.int32, w.device)
    if o != O_OUT:
        raise ValueError(f"w: the kernel takes O = {O_OUT}, got O = {o}")
    wp = w.permute(0, 2, 1).contiguous()
    _prepared[w] = (w._version, b, b._version, wp)
    return wp


def _kernel(x, w, b):
    wp = prepare_weight(w, b)
    p, m, o = wp.shape
    n = x.shape[0]
    idx = wp.get_device()
    if not (x.dtype is torch.int16 and x.shape == (n, p, m)
            and x.get_device() == idx and x.is_contiguous()):
        _check("x", x, (n, p, m), torch.int16, wp.device)
    out = torch.empty((m, n, o), dtype=torch.int32, device=wp.device)
    err = _cuda_build.library("merger_int").merger_int(
        n, p, m, x.data_ptr(), wp.data_ptr(), b.data_ptr(), out.data_ptr(),
        torch._C._cuda_getCurrentRawStream(idx))
    if err != 0:
        raise RuntimeError(
            f"merger_int kernel (N={n}, P={p}, O={o}, M={m}) failed: "
            f"{_cuda_build.error_string('merger_int', err)}")
    launches[m] = launches.get(m, 0) + 1
    return out


def merger_int_forward(x, w, b, impl: str = "kernel"):
    """The integer merger: x (N, P, M) int16 activations, w (P, O, M) int16
    weights and b (O, M) int32 biases (the layout `params_from_numpy`
    gives) -> (M, N, O) int32, the JAX package's `pnn_q` convention."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "plain" or x.device.type == "cpu":
        return merger_plain(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _kernel(x, w, b)
