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
"""

from __future__ import annotations

import torch

from . import _cuda_build

# Launches of the CUDA kernel, per map count M, counted where the wrapper
# launches it.  `reset_launch_counts` empties it.
launches: dict = {}


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


def _kernel(x, w, b):
    lib = _cuda_build.library("merger_int")
    n, p, m = x.shape
    o = w.shape[1]
    dev = x.device
    _check("x", x, (n, p, m), torch.int16, dev)
    _check("w", w, (p, o, m), torch.int16, dev)
    _check("b", b, (o, m), torch.int32, dev)
    out = torch.empty((m, n, o), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.merger_int(n, p, o, m, x.data_ptr(), w.data_ptr(),
                         b.data_ptr(), out.data_ptr(), stream)
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
