"""The float fully-connected PNN forward: the plain PyTorch version and the
wrapper of the hand-written CUDA kernel.

The chain 5w^2 -> 1200 -> 1200 -> 1200 -> w^2 of `models/pnn.fc_forward`:
layers 0-2 compute LeakyReLU(x @ W + b) with LeakyReLU(h) = max(0.1 h, h),
layer 3 computes x @ W + b.  It replaces the JAX package's TPU kernel
`fc_forward_pallas` (`ops/pallas/fc_forward.py:83`).  Weights are float32
or bfloat16; the products and sums are float32 either way (bfloat16 is
widened exactly), so float32 weights compute the normative
`pnn.fc_forward` and bfloat16 weights what the TPU kernel computes.

* `fc_plain`: four `torch.matmul`s with the bias and activation; runs on
  the CPU and the card.
* `fc_forward`: CPU tensors take the plain version; CUDA tensors launch the
  kernel of `csrc/fc_forward.cu` once per layer (a failed build or launch
  raises), or the plain version when `impl="plain"` (for comparing).
  `launches[(K, D)]` counts the kernel's launches per layer shape.
"""

from __future__ import annotations

import torch

from . import _cuda_build

SLOPE = 0.1
WEIGHT_DTYPES = (torch.float32, torch.bfloat16)

# Launches of the CUDA kernel, per layer shape (K, D), counted where the
# wrapper launches it.  `reset_launch_counts` empties it.
launches: dict = {}


def reset_launch_counts():
    launches.clear()


def _layer_plain(x, w, b, act: bool):
    h = torch.matmul(x, w.to(torch.float32)) + b
    return torch.maximum(SLOPE * h, h) if act else h


def fc_plain(x, weights, biases):
    """x (N, K0) float32, four weights (K_i, D_i) float32 or bfloat16 and
    biases (D_i,) float32 -> (N, D_3) float32."""
    for i, (w, b) in enumerate(zip(weights, biases)):
        x = _layer_plain(x, w, b, i < len(weights) - 1)
    return x


def _kernel_layer(x, w, b, act: bool):
    n, k = x.shape
    d = w.shape[1]
    dev = x.device
    _cuda_build.check_tensor("x", x, (n, k), (torch.float32,), dev)
    _cuda_build.check_tensor("w", w, (k, d), WEIGHT_DTYPES, dev)
    _cuda_build.check_tensor("b", b, (d,), (torch.float32,), dev)
    lib = _cuda_build.library("fc_forward")
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fc_forward(n, k, d, int(w.dtype == torch.bfloat16), int(act),
                         x.data_ptr(), w.data_ptr(), b.data_ptr(),
                         out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"fc_forward kernel (N={n}, K={k}, D={d}, {w.dtype}) failed: "
            f"{_cuda_build.error_string('fc_forward', err)}")
    launches[(k, d)] = launches.get((k, d), 0) + 1
    return out


def fc_forward(x, weights, biases, impl: str = "kernel"):
    """The FC chain: x (N, K0) float32, weights (K_i, D_i) float32 or
    bfloat16, biases (D_i,) float32 -> (N, D_3) float32."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "plain" or x.device.type == "cpu":
        return fc_plain(x, weights, biases)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    x = x.contiguous()
    for i, (w, b) in enumerate(zip(weights, biases)):
        x = _kernel_layer(x, w, b, i < len(weights) - 1)
    return x
