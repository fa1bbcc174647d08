"""The quantized PNN's normative integer forward in plain PyTorch (conv
models: two branches of convolutions, the channelwise integer merger,
transpose convolutions), and the pixel prediction the NN policies use.

A frozen copy of the port's `models/pnn_q.py` forward (with `pnn.py`'s
TF-SAME padding and `ops/merger_int.py`'s plain merger), as the
benchmark's reference runs it.  Every contraction is an exact integer
sum (below 2^31 by the freeze-time budget), computed as im2col and a
float64 product; `precision` (one of `precision.PRECISIONS`) gives a
lower precision for the control.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import precision as prec


LEAKY_SLOPE = 0.1
_SLOPE = float(np.float32(LEAKY_SLOPE))


def _tf_same_pads(in_size: int, stride: int, kernel: int):
    """TF 'SAME' padding (beg, end) for one spatial dim."""
    out_size = -(-in_size // stride)
    pad_total = max((out_size - 1) * stride + kernel - in_size, 0)
    beg = pad_total // 2
    return beg, pad_total - beg



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


def _contract(cols_f64, wmat_f64, precision="float64"):
    """Integer contraction of float64-held integers -> int32: exact in
    float64; the lower precisions are the control's (`precision.matmul`)."""
    return prec.matmul(cols_f64, wmat_f64, precision).to(torch.int32)


def _conv_cols(x_nchw_f64, k, stride, pads_h, pads_w):
    """Padded im2col of an NCHW float64 input: (N, Ho*Wo, C*k*k), Ho, Wo."""
    x = F.pad(x_nchw_f64, (pads_w[0], pads_w[1], pads_h[0], pads_h[1]))
    ho = (x.shape[2] - k) // stride + 1
    wo = (x.shape[3] - k) // stride + 1
    cols = F.unfold(x, k, stride=stride)
    return cols.transpose(1, 2), ho, wo


def _conv_q(x_i16, wmat, k: int, stride: int, precision="float64"):
    """Integer conv, TF-SAME padding, NHWC in and out, exact int32."""
    n = x_i16.shape[0]
    pads_h = _tf_same_pads(x_i16.shape[1], stride, k)
    pads_w = _tf_same_pads(x_i16.shape[2], stride, k)
    x = x_i16.permute(0, 3, 1, 2).to(torch.float64)
    cols, ho, wo = _conv_cols(x, k, stride, pads_h, pads_w)
    return _contract(cols, wmat, precision).reshape(n, ho, wo, -1)


def _conv_transpose_q(y_i16, wmat_t, k: int, stride: int,
                      precision="float64"):
    """Integer transpose conv (TF semantics), as the JAX package writes it:
    a stride-1 conv with the flipped kernel (`wmat_t`, laid out by
    `params_from_numpy`) over the input dilated by the stride, with the
    vjp padding of the strided SAME conv."""
    n, h, w, c = y_i16.shape
    pads = []
    for size in (h * stride, w * stride):
        lo, hi = _tf_same_pads(size, stride, k)
        extra = (size + lo + hi - k) % stride
        pads.append((k - 1 - lo, k - 1 - hi + extra))
    if min(min(p) for p in pads) < 0:
        raise ValueError(f"negative transpose-conv padding {pads}")
    x = torch.zeros((n, c, (h - 1) * stride + 1, (w - 1) * stride + 1),
                    dtype=torch.float64, device=y_i16.device)
    x[:, :, ::stride, ::stride] = y_i16.permute(0, 3, 1, 2).to(torch.float64)
    cols, ho, wo = _conv_cols(x, k, 1, pads[0], pads[1])
    return _contract(cols, wmat_t, precision).reshape(n, ho, wo, -1)


def forward_q(q: dict, inputs, width: int, precision="float64"):
    """Deterministic quantized forward of a conv model's
    `params_from_numpy` params: inputs (above (N, w, 3w, 1), left (N, 2w,
    w, 1)) mean-subtracted float32 contexts; output (N, w, w, 1) float32
    in mean-subtracted space."""
    if q["kind"] != "conv":
        raise ValueError("the reference runs the conv PNNs of the zoo")
    above, left = inputs
    strides = q["strides"]
    outs = {}
    for bname, xin in (("branch_above", above), ("branch_left", left)):
        x = _quant_in(xin.to(torch.float32), q["in_scale"], q["in_cap"])
        for i, s in enumerate(strides):
            key = f"{bname}/w_{i}"
            acc = _conv_q(x, q[key], q["_k"][key], s, precision) \
                + q[f"{bname}/b_{i}"]
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
    acc = merger_plain(xc, q["merger/w"], q["merger/b"])  # (M, N, O) int32
    x = _requant(acc, q["merger/m"][:, None, None], q["merger/c"],
                 leaky=True)
    w_out_ch = width // int(np.prod(strides))
    x = x.permute(1, 2, 0).reshape(n, w_out_ch, w_out_ch, m)

    strides_merger = strides[::-1]
    for i, s in enumerate(strides_merger):
        last = i == len(strides_merger) - 1
        key = f"merger/t_w_{i}"
        acc = _conv_transpose_q(x, q[key], q["_k"][key], s, precision) \
            + q[f"merger/t_b_{i}"]
        if not last:
            x = _requant(acc, q[f"merger/t_m_{i}"], q[f"merger/t_c_{i}"],
                         leaky=True)
        else:
            out = acc.to(torch.float32) * q[f"merger/t_m_{i}"]
    return out


def predict_pixels_q(q: dict, inputs, width: int, mean_training: float,
                     precision="float64"):
    """Normative pixel prediction: forward + mean + clip + round -> int32
    (N, w, w).  The mean is rounded to float32, as the JAX package rounds
    its weak-typed Python float."""
    pred = forward_q(q, inputs, width, precision)[..., 0]
    mean = float(np.float32(mean_training))
    return torch.round(torch.clamp(pred + mean, 0.0, 255.0)).to(torch.int32)



def merger_plain(x, w, b):
    """x (N, P, M) int16, w (P, O, M) int16, b (O, M) int32 -> (M, N, O)
    int32, by an int64 broadcast product and sum."""
    acc = (x.to(torch.int64)[:, :, None, :]
           * w.to(torch.int64)[None]).sum(dim=1)          # (N, O, M)
    acc = acc + b.to(torch.int64)[None]
    return acc.permute(2, 0, 1).to(torch.int32).contiguous()

