"""Float channelwise merger of the convolutional PNN: the plain PyTorch
version and the wrapper of the hand-written CUDA kernel.

out[n, o, m] = act(sum_p x[n, p, m] * w[p, o, m] + b[o, m]), with act the
LeakyReLU max(0.1 h, h) or the identity: the per-feature-map FC that merges
the above and left branches (`models/pnn.channelwise_fc_merger`).  It
replaces the JAX package's TPU kernel `merger_forward`
(`ops/pallas/merger.py:69`).  x (N, P, M) is the concatenation of the two
branches' NHWC features; the output (N, O, M) is the NHWC map
(N, h_out, w_out, M) the transpose convolutions read.  Weights are float32
or bfloat16, products and sums float32 (bfloat16 is widened exactly).
Shapes of the frozen models: P = 80, O = 16, M = 32, 64, 128, 256, 512 at
widths 4 and 8 (refconv), 16, 32, 64.

* `merger_plain`: a float32 einsum; runs on the CPU and the card.
* `merger_forward`: CPU tensors take the plain version; CUDA tensors launch
  the kernel of `csrc/merger.cu` (a failed build or launch raises), or the
  plain version when `impl="plain"` (for comparing).  `launches[M]` counts
  the kernel's launches per map count.  The kernel has no backward, so
  `merger_forward` raises on every device when grad mode is on and x, w or
  b requires grad: training differentiates `merger_plain`
  (`pnn.forward_train`).
"""

from __future__ import annotations

import torch

from . import _cuda_build

SLOPE = 0.1
WEIGHT_DTYPES = (torch.float32, torch.bfloat16)

# Launches of the CUDA kernel, per map count M, counted where the wrapper
# launches it.  `reset_launch_counts` empties it.
launches: dict = {}


def reset_launch_counts():
    launches.clear()


def merger_plain(x, w, b, act: bool = False):
    """x (N, P, M) float32, w (P, O, M) float32 or bfloat16, b (O, M)
    float32 -> (N, O, M) float32.  All in float64 computes in float64 (a
    reference for training's gradients)."""
    h = torch.einsum("npm,pom->nom", x, w.to(x.dtype)) + b
    return torch.maximum(SLOPE * h, h) if act else h


def _kernel(x, w, b, act: bool):
    n, p, m = x.shape
    o = w.shape[1]
    dev = x.device
    _cuda_build.check_tensor("x", x, (n, p, m), (torch.float32,), dev)
    _cuda_build.check_tensor("w", w, (p, o, m), WEIGHT_DTYPES, dev)
    _cuda_build.check_tensor("b", b, (o, m), (torch.float32,), dev)
    if m % 8 or w.data_ptr() % 16:
        raise ValueError(f"w: the kernel stages its weights in 16-byte "
                         f"copies and wants M % 8 == 0 and a 16-byte "
                         f"aligned start (M={m}, address {w.data_ptr():#x})")
    lib = _cuda_build.library("merger")
    out = torch.empty((n, o, m), dtype=torch.float32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    err = lib.merger(n, p, o, m, int(w.dtype == torch.bfloat16), int(act),
                     x.data_ptr(), w.data_ptr(), b.data_ptr(),
                     out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"merger kernel (N={n}, P={p}, O={o}, M={m}, {w.dtype}) failed: "
            f"{_cuda_build.error_string('merger', err)}")
    launches[m] = launches.get(m, 0) + 1
    return out


def merger_forward(x, w, b, act: bool = False, impl: str = "kernel"):
    """The float merger: x (N, P, M) float32, w (P, O, M) float32 or
    bfloat16, b (O, M) float32 (the layout `zoo.params_from_numpy` gives)
    -> (N, O, M) float32."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    _cuda_build.refuse_autograd("merger_forward", x, w, b)
    if impl == "plain" or x.device.type == "cpu":
        return merger_plain(x, w, b, act)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _kernel(x.contiguous(), w, b, act)
