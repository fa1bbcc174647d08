"""The float PNN model family: context -> block prediction networks.

The port of the JAX package's `models/pnn.py` forward (`leaky_relu` :49,
`conv2d_same` :63, `conv2d_transpose_same` :76, `fc_forward` :104,
`_branch_forward` :177, `channelwise_fc_merger` :184, `conv_forward` :206,
`forward` :234, `predict_uint8` :244) and its initialisation
(`init_fc_params` :91, `init_conv_params` :125, `init_params` :228), in
float32:

* **Fully-connected PNN** (widths 4, 8): 5w^2 -> 1200 -> 1200 -> 1200 ->
  w^2, LeakyReLU(0.1) on the first three layers.  The four layers go
  through `ops/fc_forward.fc_forward` (on the card the CUDA kernel of
  `ops/csrc/fc_forward.cu`).
* **Convolutional PNN** (widths 4 and 8 "refconv", 16, 32, 64): two
  convolutional branches with TF-SAME padding, the channelwise FC merger
  through `ops/merger.merger_forward` (on the card the CUDA kernel of
  `ops/csrc/merger.cu`, LeakyReLU in its epilogue), then the mirrored
  transpose convolutions.  The convolutions are `F.conv2d` /
  `F.conv_transpose2d`, as the JAX package leaves them to XLA.

Params are the nested dicts of the JAX package (the TF variable scopes),
carried onto a device by `zoo.params_from_numpy`, which lays the weights
out for PyTorch: conv weights (out, in, k, k), transpose-conv weights (in,
out, k, k), FC weights (K, D), merger weights (P, O, M) and biases (O, M).
Activations are NHWC at the public functions, as in the JAX package;
`conv2d_same` and `conv2d_transpose_same` work on NCHW tensors.  cuDNN's and
cuBLAS's TF32 is turned off around the forward, so the card's
convolutions run in full float32 (`full_f32`).

Training (`models/training.py`) runs `forward_train`: the same functions
with the two kernels' plain versions (`fc_ops.fc_plain`,
`merger_ops.merger_plain`) in their place, so autograd reaches every
weight on the CPU and on the card (the kernel wrappers refuse tensors
that require grad).  `init_params` draws a new net from a
`torch.Generator` in the JAX package's layout (numpy), which
`zoo.params_from_numpy` carries onto a device.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import fc_forward as fc_ops
from ..ops import merger as merger_ops

LEAKY_SLOPE = 0.1
HIDDEN_FC = 1200
BRANCH_BASE_MAPS = 32
# Per-width convolutional branch strides (JAX package models/pnn.py:35-41).
STRIDES_BRANCH = {
    4: (1, 1),
    8: (2, 1),
    16: (2, 1, 2, 1),
    32: (2, 2, 1, 2, 1),
    64: (2, 2, 2, 2, 1),
}


def leaky_relu(x):
    return torch.maximum(LEAKY_SLOPE * x, x)


@contextlib.contextmanager
def full_f32():
    """cuDNN convolutions (TF32 is their default on the card) and cuBLAS
    products in float32, not TF32, for the duration of the block; the
    caller's flags are back afterwards."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


# ------------------------------------------------------------------ conv ----

def _tf_same_pads(in_size: int, stride: int, kernel: int):
    """TF 'SAME' padding (beg, end) for one spatial dim."""
    out_size = -(-in_size // stride)
    pad_total = max((out_size - 1) * stride + kernel - in_size, 0)
    beg = pad_total // 2
    return beg, pad_total - beg


def conv2d_same(x, weights_oihw, stride: int):
    """NCHW conv with TF-SAME padding (possibly asymmetric); weights (out,
    in, k, k)."""
    k = weights_oihw.shape[2]
    ph = _tf_same_pads(x.shape[2], stride, k)
    pw = _tf_same_pads(x.shape[3], stride, k)
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), weights_oihw,
                    stride=stride)


def conv2d_transpose_same(y, weights_iohw, stride: int):
    """TF `conv2d_transpose` with SAME padding, NCHW: the linear transpose
    (vjp) of `conv2d_same` from (N, C_out, h*s, w*s) to y's shape.
    `weights_iohw` is (in = y's channels, out, k, k).

    The transpose of the strided conv over the padded input is
    `F.conv_transpose2d` at stride s, whose output covers the padded
    input from its first row; rows the conv never read are zero; the crop
    at the SAME conv's `lo` pad drops the padding."""
    n, _, h, w = y.shape
    k = weights_iohw.shape[2]
    full = F.conv_transpose2d(y, weights_iohw, stride=stride)
    out = []
    for size, axis in ((h * stride, 2), (w * stride, 3)):
        lo, hi = _tf_same_pads(size, stride, k)
        short = size + lo + hi - full.shape[axis]
        if short < 0:
            raise ValueError(f"transpose conv longer than its padded input "
                             f"({full.shape[axis]} > {size + lo + hi})")
        out.append((lo, size, short))
    (lo_h, size_h, short_h), (lo_w, size_w, short_w) = out
    if short_h or short_w:
        full = F.pad(full, (0, short_w, 0, short_h))
    return full[:, :, lo_h:lo_h + size_h, lo_w:lo_w + size_w]


def _real(t):
    """Inputs in float32, or float64 where given so (training's float64
    reference runs the whole forward in float64)."""
    return t if t.dtype == torch.float64 else t.to(torch.float32)


# ------------------------------------------------------------ FC network ----

def init_fc_params(generator: torch.Generator, width_target: int) -> dict:
    """A new fully-connected PNN (the reference's init distributions: the
    pixel-facing layers N(0, 0.01), the middle ones N(0, 0.029), zero
    biases), JAX layout, numpy float32."""
    w2 = width_target ** 2
    dims = [(5 * w2, HIDDEN_FC), (HIDDEN_FC, HIDDEN_FC),
            (HIDDEN_FC, HIDDEN_FC), (HIDDEN_FC, w2)]
    stddevs = [0.01, 0.029, 0.029, 0.01]
    params = {}
    for i, ((d_in, d_out), sd) in enumerate(zip(dims, stddevs)):
        params[f"weights_{i}"] = _normal(generator, (d_in, d_out), sd)
        params[f"biases_{i}"] = np.zeros((d_out,), np.float32)
    return params


def _normal(generator, shape, sd):
    """sd x N(0, 1) draws from `generator` (on the CPU), numpy float32."""
    z = torch.randn(shape, generator=generator, dtype=torch.float32)
    return (np.float32(sd) * z.numpy()).astype(np.float32)


def fc_forward(params: dict, flattened_contexts, width_target: int,
               chain=None):
    """FC PNN forward: (N, 5w^2) float32 -> (N, w, w, 1) float32, the four
    layers through `chain`: the kernel's wrapper `fc_ops.fc_forward` (looked
    up at the call, None) or its plain version."""
    x = (chain or fc_ops.fc_forward)(
        _real(flattened_contexts),
        [params[f"weights_{i}"] for i in range(4)],
        [params[f"biases_{i}"] for i in range(4)])
    return x.reshape(x.shape[0], width_target, width_target, 1)


# ---------------------------------------------------------- conv network ----

def _branch_layer_maps(strides):
    maps, out = BRANCH_BASE_MAPS, []
    for s in strides:
        maps *= s
        out.append(maps)
    return out


def init_conv_params(generator: torch.Generator, width_target: int) -> dict:
    """A new convolutional PNN for one target width, JAX layout (conv
    weights (k, k, in, out), transpose-conv weights (k, k, out, in), merger
    (M, P, O) and (M, O)), numpy float32: pixel-facing layers N(0, 0.01),
    the others N(0, 1 / fan-in), zero biases."""
    strides = STRIDES_BRANCH[width_target]
    maps_per_layer = _branch_layer_maps(strides)
    params: dict = {}
    for branch in ("branch_above", "branch_left"):
        bp = {}
        c_in = 1
        for i, (s, c_out) in enumerate(zip(strides, maps_per_layer)):
            k = 2 * s + 1
            sd = 0.01 if i == 0 else 1.0 / math.sqrt(c_in * k * k)
            bp[f"convolution_{i}"] = {
                "weights": _normal(generator, (k, k, c_in, c_out), sd),
                "biases": np.zeros((c_out,), np.float32),
            }
            c_in = c_out
        params[branch] = bp

    prod = math.prod(strides)
    h0, w0 = width_target // prod, 3 * width_target // prod
    h1, w1 = 2 * width_target // prod, width_target // prod
    maps = maps_per_layer[-1]
    n_in = h0 * w0 + h1 * w1
    w_out_ch = width_target // prod
    merger: dict = {
        "channelwise_fully_connected_merger": {
            "weights": _normal(generator, (maps, n_in, w_out_ch * w_out_ch),
                               1.0 / math.sqrt(n_in)),
            "biases": np.zeros((maps, w_out_ch * w_out_ch), np.float32),
        }
    }
    strides_merger = strides[::-1]
    c_in = maps
    for i, s in enumerate(strides_merger):
        k = 2 * s + 1
        last = i == len(strides_merger) - 1
        c_out = 1 if last else c_in // s
        sd = 0.01 if last else 1.0 / math.sqrt(c_in * k * k)
        merger[f"transpose_convolution_{i}"] = {
            "weights": _normal(generator, (k, k, c_out, c_in), sd),
            "biases": np.zeros((c_out,), np.float32),
        }
        c_in = c_out
    params["merger"] = merger
    return params


def _branch_forward(bp: dict, x, strides):
    """One convolutional branch, NCHW in and out."""
    for i, s in enumerate(strides):
        layer = bp[f"convolution_{i}"]
        x = leaky_relu(conv2d_same(x, layer["weights"], s)
                       + layer["biases"][:, None, None])
    return x


def channelwise_fc_merger(weights, biases, x0, x1, h_out: int, w_out: int,
                          act: bool = False, merger_op=None):
    """Per-feature-map FC from both branches' spatial positions to the
    merged map.

    x0 (N, h0, w0, M), x1 (N, h1, w1, M) NHWC; weights (P, O, M) with P =
    h0 w0 + h1 w1, O = h_out w_out; biases (O, M).  `act` applies the
    LeakyReLU (in the kernel's epilogue on the card).  `merger_op` is the
    kernel's wrapper `merger_ops.merger_forward` (looked up at the call,
    None) or its plain version.  Returns (N, h_out, w_out, M)."""
    n, m = x0.shape[0], x0.shape[3]
    xc = torch.cat([x0.reshape(n, -1, m), x1.reshape(n, -1, m)], dim=1)
    out = (merger_op or merger_ops.merger_forward)(xc, weights, biases,
                                                   act=act)
    return out.reshape(n, h_out, w_out, m)


def conv_forward(params: dict, portions_above, portions_left,
                 width_target: int, merger_op=None):
    """Convolutional PNN forward: above (N, w, 3w, 1) + left (N, 2w, w, 1)
    NHWC -> (N, w, w, 1), the channelwise merger through `merger_op`."""
    strides = STRIDES_BRANCH[width_target]
    nchw = lambda t: _real(t).permute(0, 3, 1, 2)
    nhwc = lambda t: t.permute(0, 2, 3, 1)
    x0 = nhwc(_branch_forward(params["branch_above"], nchw(portions_above),
                              strides))
    x1 = nhwc(_branch_forward(params["branch_left"], nchw(portions_left),
                              strides))
    w_out_ch = width_target // math.prod(strides)
    merger = params["merger"]
    cm = merger["channelwise_fully_connected_merger"]
    x = channelwise_fc_merger(cm["weights"], cm["biases"], x0, x1, w_out_ch,
                              w_out_ch, act=True, merger_op=merger_op)
    x = x.permute(0, 3, 1, 2)
    strides_merger = strides[::-1]
    for i, s in enumerate(strides_merger):
        layer = merger[f"transpose_convolution_{i}"]
        x = conv2d_transpose_same(x, layer["weights"], s) \
            + layer["biases"][:, None, None]
        if i != len(strides_merger) - 1:
            x = leaky_relu(x)
    return nhwc(x)


# ------------------------------------------------------------- dispatch ----

def init_params(generator: torch.Generator, width_target: int,
                is_fully_connected: bool) -> dict:
    """A new PNN, JAX layout, numpy float32.  The draws come from
    `generator` (a CPU `torch.Generator`), so a seed gives the same net on
    every device; the JAX package's `PRNGKey`s give other draws."""
    if is_fully_connected:
        return {"fully_connected": init_fc_params(generator, width_target)}
    return {"convolutional": init_conv_params(generator, width_target)}


def forward(params: dict, inputs, width_target: int,
            is_fully_connected: bool):
    """Unified forward.  `inputs` is a flattened-context tensor for FC nets
    or an (above, left) tuple for conv nets, on the params' device.
    Returns (N, w, w, 1) float32."""
    with full_f32():
        if is_fully_connected:
            return fc_forward(params["fully_connected"], inputs,
                              width_target)
        above, left = inputs
        return conv_forward(params["convolutional"], above, left,
                            width_target)


def forward_train(params: dict, inputs, width_target: int,
                  is_fully_connected: bool):
    """The forward that training differentiates (the JAX package's
    `pnn.forward` under `jax.value_and_grad`): `forward` with the plain
    versions of the FC and merger kernels, every operation an autograd
    one.  The caller sets the flags (`training.exact_steps`: TF32 and
    cuDNN off)."""
    if is_fully_connected:
        return fc_forward(params["fully_connected"], inputs, width_target,
                          chain=fc_ops.fc_plain)
    above, left = inputs
    return conv_forward(params["convolutional"], above, left, width_target,
                        merger_op=merger_ops.merger_plain)


def predict_uint8(params: dict, inputs, width_target: int,
                  is_fully_connected: bool, mean_training: float):
    """Inference to pixel space: forward + mean add + clip + round -> uint8
    (N, w, w).  The mean is rounded to float32, as the JAX package rounds
    its weak-typed Python float."""
    pred = forward(params, inputs, width_target, is_fully_connected)
    mean = float(np.float32(mean_training))
    pred = torch.clamp(pred[..., 0] + mean, 0.0, 255.0)
    return torch.round(pred).to(torch.uint8)
