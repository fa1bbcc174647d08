"""The float fully-connected PNN forward: the plain PyTorch version and the
wrapper of the hand-written CUDA kernel.

The chain 5w^2 -> 1200 -> 1200 -> 1200 -> w^2 of `models/pnn.fc_forward`:
layers 0-2 compute LeakyReLU(x @ W + b) with LeakyReLU(h) = max(0.1 h, h),
layer 3 computes x @ W + b.  It replaces the JAX package's TPU kernel
`fc_forward_pallas` (`ops/pallas/fc_forward.py:83`).  Weights are float32
or bfloat16 (bfloat16 is widened exactly), so float32 weights compute the
normative `pnn.fc_forward` and bfloat16 weights what the TPU kernel
computes.

* `fc_plain`: four `torch.matmul`s with the bias and activation, in
  float32; runs on the CPU and the card.
* `fc_forward`: CPU tensors take the plain version; CUDA tensors launch the
  kernel of `csrc/fc_forward.cu` once per layer (a failed build or launch
  raises), or the plain version when `impl="plain"` (for comparing).
  `launches[(K, D)]` counts the layer calls that launched the kernel, per
  layer shape.  The kernel has no backward, so `fc_forward` raises on every
  device when grad mode is on and x, a weight or a bias requires grad:
  training differentiates `fc_plain` (`pnn.forward_train`).

The kernel runs on the tensor cores in split TF32 (three TF32 products per
float32 product, two for bfloat16 weights; see the source).  It takes each
weight transposed and split, w_hi = tf32(w^T), w_lo = tf32(w^T - w_hi):
`prepare_weight` makes that pair on the weight's device once per weight
tensor and keeps it while the tensor lives and is not changed in place
(about 27 MB on the card for the w8 chain in float32).  `plan` picks the
kernel's tile width and K splits from the shape.
"""

from __future__ import annotations

import functools

import torch
import torch.utils.weak

from . import _cuda_build

SLOPE = 0.1
WEIGHT_DTYPES = (torch.float32, torch.bfloat16)
TILE_ROWS = 64                    # rows of x per block (one warpgroup)
TILE_DEPTH = 32                   # K per pipeline stage
# Tile widths of the kernel, and the cost of a column of each relative to
# the widest (a narrow tile re-reads its x fragment for fewer products).
TILE_COLUMNS = {192: 1.0, 128: 1.05, 96: 1.1, 64: 1.2, 32: 1.5}
MAX_SPLITS = 8
MIN_STAGES_PER_SPLIT = 6
SMEM_BYTES = 227 * 1024           # shared memory a block may use
MAX_STAGES = 4

# Launches of the CUDA kernel, per layer shape (K, D), counted where the
# wrapper launches it.  `reset_launch_counts` empties it.
launches: dict = {}
_prepared = torch.utils.weak.WeakIdKeyDictionary()
_sm_counts: dict = {}


def reset_launch_counts():
    launches.clear()


def _layer_plain(x, w, b, act: bool):
    h = torch.matmul(x, w.to(x.dtype)) + b
    return torch.maximum(SLOPE * h, h) if act else h


def fc_plain(x, weights, biases):
    """x (N, K0) float32, four weights (K_i, D_i) float32 or bfloat16 and
    biases (D_i,) float32 -> (N, D_3) float32.  All in float64 computes in
    float64 (a reference for training's gradients)."""
    for i, (w, b) in enumerate(zip(weights, biases)):
        x = _layer_plain(x, w, b, i < len(weights) - 1)
    return x


def tf32_round(t):
    """float32 `t` rounded to TF32 (10 mantissa bits; to nearest, ties away
    from zero, as the kernel's `cvt.rna.tf32.f32`), still float32."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def prepare_weight(w):
    """(w_hi, w_lo) of weight `w` (K, D): float32 (D, K) tensors on its
    device, w_hi = tf32(w^T) and w_lo = tf32(w^T - w_hi); w_lo is None for
    a bfloat16 weight, which TF32 holds exactly.  Made once per tensor and
    again after an in-place change of it."""
    got = _prepared.get(w)
    if got is not None and got[0] == w._version:
        return got[1], got[2]
    wt = w.t().to(torch.float32).contiguous()
    hi = tf32_round(wt)
    lo = tf32_round(wt - hi) if w.dtype == torch.float32 else None
    _prepared[w] = (w._version, hi, lo)
    return hi, lo


@functools.lru_cache(maxsize=1024)
def plan(n: int, k: int, d: int, sms: int, split_w: bool = True):
    """(tile columns, K splits) of the kernel for an (N, K) x (K, D) layer
    on a card of `sms` SMs (`split_w`: float32 weights, hi and lo tiles).
    The tile width is the one whose busiest SM has the least work (ties to
    the wider tile).  Then the K range is split so that the blocks about
    fill the SMs, as many per SM as shared memory holds (at most two), each
    split at least `MIN_STAGES_PER_SPLIT` stages of 32.  Set from a sweep
    of every width and split on an H100 (`kernel_variants.py fc-sweep`,
    PERF.md)."""
    rows = -(-n // TILE_ROWS)
    bn = min(TILE_COLUMNS, key=lambda c: (
        -(-rows * -(-d // c) // sms) * c * TILE_COLUMNS[c], -c))
    tiles = rows * -(-d // bn)
    stage_bytes = (TILE_ROWS + bn * (2 if split_w else 1)) * TILE_DEPTH * 4
    stages = min(MAX_STAGES, (SMEM_BYTES - 1088) // stage_bytes)
    per_sm = min(2, SMEM_BYTES // (stages * stage_bytes + 1088))
    k_stages = -(-k // TILE_DEPTH)
    splits = max(1, min(MAX_SPLITS, k_stages // MIN_STAGES_PER_SPLIT,
                        round(sms * per_sm / tiles)))
    # Every split owns at least one stage.
    while splits > 1 and (splits - 1) * -(-k_stages // splits) >= k_stages:
        splits -= 1
    return bn, splits


def _sm_count(dev):
    if dev not in _sm_counts:
        _sm_counts[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _sm_counts[dev]


def _kernel_layer(x, w, b, act: bool):
    n, k = x.shape
    d = w.shape[1]
    dev = x.device
    _cuda_build.check_tensor("x", x, (n, k), (torch.float32,), dev)
    _cuda_build.check_tensor("w", w, (k, d), WEIGHT_DTYPES, dev)
    _cuda_build.check_tensor("b", b, (d,), (torch.float32,), dev)
    if k % 4 or x.data_ptr() % 16:
        raise ValueError(f"x: the kernel's TMA wants K % 4 == 0 and a "
                         f"16-byte aligned start (K={k}, "
                         f"address {x.data_ptr():#x})")
    lib = _cuda_build.library("fc_forward")
    w_hi, w_lo = prepare_weight(w)
    bn, splits = plan(n, k, d, _sm_count(dev), w_lo is not None)
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    part = (torch.empty((splits, n, d), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    err = lib.fc_forward(n, k, d, int(act), bn, splits, x.data_ptr(),
                         w_hi.data_ptr(),
                         None if w_lo is None else w_lo.data_ptr(),
                         b.data_ptr(), out.data_ptr(),
                         None if part is None else part.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"fc_forward kernel (N={n}, K={k}, D={d}, {w.dtype}, tile "
            f"{bn}, {splits} splits) failed: "
            f"{_cuda_build.error_string('fc_forward', err)}")
    launches[(k, d)] = launches.get((k, d), 0) + 1
    return out


def fc_forward(x, weights, biases, impl: str = "kernel"):
    """The FC chain: x (N, K0) float32, weights (K_i, D_i) float32 or
    bfloat16, biases (D_i,) float32 -> (N, D_3) float32."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    _cuda_build.refuse_autograd("fc_forward", x, *weights, *biases)
    if impl == "plain" or x.device.type == "cpu":
        return fc_plain(x, weights, biases)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    x = x.contiguous()
    for i, (w, b) in enumerate(zip(weights, biases)):
        x = _kernel_layer(x, w, b, i < len(weights) - 1)
    return x
