"""Quantized normative PNN inference: the codec's deterministic NN path.

The port of the integer forward of the JAX package's `models/pnn_q.py`
(`load_quantized` :432, `_requant` :264, `_quant_in` :275, `_conv_q` :283,
`_conv_transpose_q` :297, `forward_q` :327, `predict_pixels_q` :412).  A
frozen model is a dict of numpy arrays (int16 weights, int32 biases,
float32 per-channel multipliers and integer activation caps);
`params_from_numpy` carries it onto a device.

Every contraction is an exact integer sum.  PyTorch has no int32
convolution or matmul on CUDA, so the port computes them as im2col
(`unfold`) followed by a float64 matmul, on the CPU and the card alike:
the freeze-time budget keeps every sum of products under 2^31, far below
2^53, so each float64 partial sum is an exact integer whatever the order.
cuDNN convolutions are not used (their algorithm is not under control,
and FFT or Winograd would round).  The channelwise merger, the one
contraction the JAX package also wrote as a TPU kernel, goes through
`ops/merger_int.merger_int_forward` (on the card the CUDA kernel of
`ops/csrc/merger_int.cu`).

Requantisation repeats the JAX package's float32 steps in its order:
int32 -> float32, max(0.1 x, x), times the multiplier, round half to
even, clip to the cap.  `_quant_in` divides by `in_scale` on the tensor's
own device: a division by a CPU scalar would let PyTorch's CUDA kernel
multiply by the reciprocal instead, which is not the same float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import merger_int
from . import pnn

_SLOPE = float(np.float32(pnn.LEAKY_SLOPE))


def load_quantized(path: str) -> dict:
    """A frozen quantized model (.npz) as a dict of numpy arrays; `kind`
    ("fc" or "conv") as a str."""
    with np.load(path) as data:
        out = {}
        for k in data.files:
            v = data[k]
            out[k] = v.item() if k == "kind" else v
        return out


def _kind(q) -> str:
    if "kind" not in q:
        raise ValueError("a quantized model needs its 'kind' (fc or conv)")
    return str(np.asarray(q["kind"]))


def _conv_matrix(w_hwio):
    """(k, k, in, out) weights -> (in*k*k, out) float64 in `unfold`'s
    column order (channel, kernel row, kernel column)."""
    w = np.asarray(w_hwio, np.float64)
    k, _, cin, cout = w.shape
    return np.ascontiguousarray(w.transpose(2, 0, 1, 3).reshape(cin * k * k,
                                                                 cout))


def params_from_numpy(q: dict, device="cuda") -> dict:
    """A frozen (or JAX-quantized) model dict of numpy arrays -> the port's
    tensors on `device`.

    Conv weights become (in*k*k, out) float64 matrices for the im2col
    product; transpose-conv weights are flipped and swapped first (the
    input-dilated conv form); FC weights become float64 matrices; the
    merger weights are laid out (P, O, M) int16 and its biases (O, M)
    int32 for `merger_int_forward`.  Biases stay int32, multipliers and
    scales float32 (0-d tensors on `device`), caps Python ints."""
    dev = torch.device(device)
    kind = _kind(q)
    t = lambda a, dt=None: torch.from_numpy(
        np.ascontiguousarray(a if dt is None else np.asarray(a, dt))).to(dev)
    out = {"kind": kind, "width": int(np.asarray(q["width"]))}
    for k, v in q.items():
        if k in ("kind", "width"):
            continue
        name = k.rsplit("/", 1)[-1]
        a = np.asarray(v)
        if k == "merger/w":
            out[k] = t(a.transpose(1, 2, 0), np.int16)       # (P, O, M)
        elif k == "merger/b":
            out[k] = t(a.T, np.int32)                        # (O, M)
        elif name.startswith("t_w_"):
            # (k, k, out, in) -> flipped, (k, k, in, out): the stride-1 conv
            # over the input dilated by the stride.
            out[k] = t(_conv_matrix(np.flip(a, (0, 1)).swapaxes(2, 3)))
        elif name.startswith("w_"):
            out[k] = t(a.astype(np.float64) if kind == "fc"
                       else _conv_matrix(a))
        elif k == "strides":
            out[k] = [int(s) for s in a]
        elif name.startswith(("c_", "t_c_")) or k in ("in_cap", "merge_cap",
                                                      "merger/c"):
            out[k] = int(a)
        elif a.dtype == np.float32:
            out[k] = t(a)
        elif a.dtype == np.int32:
            out[k] = t(a)
        else:
            raise ValueError(f"unexpected entry {k!r} ({a.dtype})")
    if kind == "conv":
        out["_k"] = {k: int(np.asarray(v).shape[0]) for k, v in q.items()
                     if "w_" in k.rsplit("/", 1)[-1]}
    return out


def _requant(acc_i32, mult, cap, leaky: bool):
    """int32 accumulator -> int16 activation (elementwise float32)."""
    x = acc_i32.to(torch.float32)
    if leaky:
        x = torch.maximum(x * _SLOPE, x)
    cap = float(cap)
    return torch.clamp(torch.round(x * mult), -cap, cap).to(torch.int16)


def _quant_in(x_f32, in_scale, cap):
    cap = float(cap)
    return torch.clamp(torch.round(x_f32 / in_scale), -cap,
                       cap).to(torch.int16)


def _contract(cols_f64, wmat_f64):
    """Exact integer contraction of float64-held integers -> int32."""
    return torch.matmul(cols_f64, wmat_f64).to(torch.int32)


def _conv_cols(x_nchw_f64, k, stride, pads_h, pads_w):
    """Padded im2col of an NCHW float64 input: (N, Ho*Wo, C*k*k), Ho, Wo."""
    x = F.pad(x_nchw_f64, (pads_w[0], pads_w[1], pads_h[0], pads_h[1]))
    ho = (x.shape[2] - k) // stride + 1
    wo = (x.shape[3] - k) // stride + 1
    cols = F.unfold(x, k, stride=stride)
    return cols.transpose(1, 2), ho, wo


def _conv_q(x_i16, wmat, k: int, stride: int):
    """Integer conv, TF-SAME padding, NHWC in and out, exact int32."""
    n = x_i16.shape[0]
    pads_h = pnn._tf_same_pads(x_i16.shape[1], stride, k)
    pads_w = pnn._tf_same_pads(x_i16.shape[2], stride, k)
    x = x_i16.permute(0, 3, 1, 2).to(torch.float64)
    cols, ho, wo = _conv_cols(x, k, stride, pads_h, pads_w)
    return _contract(cols, wmat).reshape(n, ho, wo, -1)


def _conv_transpose_q(y_i16, wmat_t, k: int, stride: int):
    """Integer transpose conv (TF semantics), as the JAX package writes it:
    a stride-1 conv with the flipped kernel (`wmat_t`, laid out by
    `params_from_numpy`) over the input dilated by the stride, with the
    vjp padding of the strided SAME conv."""
    n, h, w, c = y_i16.shape
    pads = []
    for size in (h * stride, w * stride):
        lo, hi = pnn._tf_same_pads(size, stride, k)
        extra = (size + lo + hi - k) % stride
        pads.append((k - 1 - lo, k - 1 - hi + extra))
    if min(min(p) for p in pads) < 0:
        raise ValueError(f"negative transpose-conv padding {pads}")
    x = torch.zeros((n, c, (h - 1) * stride + 1, (w - 1) * stride + 1),
                    dtype=torch.float64, device=y_i16.device)
    x[:, :, ::stride, ::stride] = y_i16.permute(0, 3, 1, 2).to(torch.float64)
    cols, ho, wo = _conv_cols(x, k, 1, pads[0], pads[1])
    return _contract(cols, wmat_t).reshape(n, ho, wo, -1)


def forward_q(q: dict, inputs, width: int, is_fully_connected: bool,
              impl: str = "kernel"):
    """Deterministic quantized forward of `params_from_numpy` params.

    Inputs are the mean-subtracted float32 contexts: (N, 5w^2) for FC,
    (above (N, w, 3w, 1), left (N, 2w, w, 1)) for conv; output (N, w, w, 1)
    float32 in mean-subtracted space.  `impl` goes to the merger ("plain"
    runs its plain version on the card, for comparing)."""
    if is_fully_connected:
        x = _quant_in(inputs.to(torch.float32), q["in_scale"], q["in_cap"])
        for i in range(4):
            acc = _contract(x.to(torch.float64), q[f"w_{i}"]) + q[f"b_{i}"]
            if i < 3:
                x = _requant(acc, q[f"m_{i}"], q[f"c_{i}"], leaky=True)
            else:
                out = acc.to(torch.float32) * q[f"m_{i}"]
        return out.reshape(out.shape[0], width, width, 1)

    above, left = inputs
    strides = q["strides"]
    outs = {}
    for bname, xin in (("branch_above", above), ("branch_left", left)):
        x = _quant_in(xin.to(torch.float32), q["in_scale"], q["in_cap"])
        for i, s in enumerate(strides):
            key = f"{bname}/w_{i}"
            acc = _conv_q(x, q[key], q["_k"][key], s) + q[f"{bname}/b_{i}"]
            x = _requant(acc, q[f"{bname}/m_{i}"], q[f"{bname}/c_{i}"],
                         leaky=True)
        outs[bname] = x
    x0 = outs["branch_above"]
    # Rescale the left branch onto the above branch's activation scale.
    x1f = outs["branch_left"].to(torch.float32) * q["left_rescale"]
    cap = float(q["merge_cap"])
    x1 = torch.clamp(torch.round(x1f), -cap, cap).to(torch.int16)

    n, m = x0.shape[0], x0.shape[3]
    xc = torch.cat([x0.reshape(n, -1, m), x1.reshape(n, -1, m)],
                   dim=1).contiguous()                    # (N, P, M) int16
    acc = merger_int.merger_int_forward(xc, q["merger/w"], q["merger/b"],
                                        impl=impl)        # (M, N, O) int32
    x = _requant(acc, q["merger/m"][:, None, None], q["merger/c"],
                 leaky=True)
    w_out_ch = width // int(np.prod(strides))
    x = x.permute(1, 2, 0).reshape(n, w_out_ch, w_out_ch, m)

    strides_merger = strides[::-1]
    for i, s in enumerate(strides_merger):
        last = i == len(strides_merger) - 1
        key = f"merger/t_w_{i}"
        acc = _conv_transpose_q(x, q[key], q["_k"][key], s) \
            + q[f"merger/t_b_{i}"]
        if not last:
            x = _requant(acc, q[f"merger/t_m_{i}"], q[f"merger/t_c_{i}"],
                         leaky=True)
        else:
            out = acc.to(torch.float32) * q[f"merger/t_m_{i}"]
    return out


def predict_pixels_q(q: dict, inputs, width: int, is_fully_connected: bool,
                     mean_training: float, impl: str = "kernel"):
    """Normative pixel prediction: forward + mean + clip + round -> int32
    (N, w, w).  The mean is rounded to float32, as the JAX package rounds
    its weak-typed Python float."""
    pred = forward_q(q, inputs, width, is_fully_connected, impl=impl)[..., 0]
    mean = float(np.float32(mean_training))
    return torch.round(torch.clamp(pred + mean, 0.0, 255.0)).to(torch.int32)
