"""The float PNN model family: context -> block prediction networks.

The port of the JAX package's `models/pnn.py` forward (`leaky_relu` :49,
`conv2d_same` :63, `conv2d_transpose_same` :76, `fc_forward` :104,
`_branch_forward` :177, `channelwise_fc_merger` :184, `conv_forward` :206,
`forward` :234, `predict_uint8` :244), in float32:

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
`conv2d_same` and `conv2d_transpose_same` work on NCHW tensors.  cuDNN's
TF32 is turned off around the forward, so the card's convolutions run in
full float32 (`full_f32`).
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
    """cuDNN convolutions in float32, not TF32 (its default on the card),
    for the duration of the block."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


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


# ------------------------------------------------------------ FC network ----

def fc_forward(params: dict, flattened_contexts, width_target: int):
    """FC PNN forward: (N, 5w^2) float32 -> (N, w, w, 1) float32."""
    x = fc_ops.fc_forward(
        flattened_contexts.to(torch.float32),
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


def _branch_forward(bp: dict, x, strides):
    """One convolutional branch, NCHW in and out."""
    for i, s in enumerate(strides):
        layer = bp[f"convolution_{i}"]
        x = leaky_relu(conv2d_same(x, layer["weights"], s)
                       + layer["biases"][:, None, None])
    return x


def channelwise_fc_merger(weights, biases, x0, x1, h_out: int, w_out: int,
                          act: bool = False):
    """Per-feature-map FC from both branches' spatial positions to the
    merged map.

    x0 (N, h0, w0, M), x1 (N, h1, w1, M) NHWC; weights (P, O, M) with P =
    h0 w0 + h1 w1, O = h_out w_out; biases (O, M).  `act` applies the
    LeakyReLU (in the kernel's epilogue on the card).  Returns (N, h_out,
    w_out, M)."""
    n, m = x0.shape[0], x0.shape[3]
    xc = torch.cat([x0.reshape(n, -1, m), x1.reshape(n, -1, m)], dim=1)
    out = merger_ops.merger_forward(xc, weights, biases, act=act)
    return out.reshape(n, h_out, w_out, m)


def conv_forward(params: dict, portions_above, portions_left,
                 width_target: int):
    """Convolutional PNN forward: above (N, w, 3w, 1) + left (N, 2w, w, 1)
    NHWC -> (N, w, w, 1)."""
    strides = STRIDES_BRANCH[width_target]
    nchw = lambda t: t.to(torch.float32).permute(0, 3, 1, 2)
    nhwc = lambda t: t.permute(0, 2, 3, 1)
    x0 = nhwc(_branch_forward(params["branch_above"], nchw(portions_above),
                              strides))
    x1 = nhwc(_branch_forward(params["branch_left"], nchw(portions_left),
                              strides))
    w_out_ch = width_target // math.prod(strides)
    merger = params["merger"]
    cm = merger["channelwise_fully_connected_merger"]
    x = channelwise_fc_merger(cm["weights"], cm["biases"], x0, x1, w_out_ch,
                              w_out_ch, act=True)
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


def predict_uint8(params: dict, inputs, width_target: int,
                  is_fully_connected: bool, mean_training: float):
    """Inference to pixel space: forward + mean add + clip + round -> uint8
    (N, w, w).  The mean is rounded to float32, as the JAX package rounds
    its weak-typed Python float."""
    pred = forward(params, inputs, width_target, is_fully_connected)
    mean = float(np.float32(mean_training))
    pred = torch.clamp(pred[..., 0] + mean, 0.0, 255.0)
    return torch.round(pred).to(torch.uint8)
