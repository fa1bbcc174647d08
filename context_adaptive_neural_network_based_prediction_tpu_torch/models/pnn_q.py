"""Quantized normative PNN inference: the codec's deterministic NN path.

The port of the integer forward of the JAX package's `models/pnn_q.py`
(`save_quantized` :428, `load_quantized` :432, `_requant` :264,
`_quant_in` :275, `_conv_q` :283, `_conv_transpose_q` :297, `forward_q`
:327, `predict_pixels_q` :412).  A
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

Freezing (`quantize_pnn` :98, `calibration_contexts` :443, and their
helpers `_layer_budget` :53, `_wq_per_out` :64, `_act_scale` :77, `_bq`
:81): a float model and calibration contexts -> a frozen model dict.  The
integer ranges come from the per-layer overflow budget (every contraction
of length K has act_max * w_max * K <= 2^30, the bias the other 2^30 of
int32) and the per-output-channel weight scales from the weights alone,
in numpy, so the quantized weights and caps equal the JAX package's.  The
activation scales come from the maxima of a float32 forward on the
calibration set, run with the port's float PNN pieces on the caller's
device (the FC layers one at a time through `ops/fc_forward`, the float
merger through `ops/merger`: on the card the CUDA kernels of
`fc_forward.cu` and `merger.cu`): its roundings differ from XLA's, so the
scales, multipliers and biases agree with the JAX package's to float
rounding, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import fc_forward as fc_ops
from ..ops import merger_int
from . import pnn

_SLOPE = float(np.float32(pnn.LEAKY_SLOPE))
ACT_CAP = 2047          # max activation magnitude (int16 payload)
W_CAP = 511             # max weight magnitude
BUDGET = 1 << 30        # per-contraction int32 budget (bias gets the rest)
CALIB_MARGIN = 1.10     # headroom over calibration max activations


def save_quantized(path: str, q: dict) -> None:
    """Writes a quantized model dict (`quantize_pnn`'s, or one read by
    `load_quantized`) as the compressed `.npz` the NN policies load (the
    JAX package's :428): every value as a numpy array, `kind` as a 0-d
    string array.  A tensor value is copied to the host first."""
    np.savez_compressed(path, **{
        k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
        else np.asarray(v) for k, v in q.items()})


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


# ----------------------------------------------------------- quantization --

def _layer_budget(k: int):
    """(act_max, w_max) for a contraction of length k: act*w*k <= BUDGET."""
    prod_cap = max(BUDGET // max(k, 1), 8)
    act = min(ACT_CAP, int((4.0 * prod_cap) ** 0.5))
    w = min(W_CAP, max(prod_cap // act, 1))
    return act, w


def _wq_per_out(w, out_axis: int, w_max: int):
    """Per-output-channel weight quantization -> (int16 weights, float32
    scales)."""
    w = np.asarray(w, np.float32)
    red = tuple(i for i in range(w.ndim) if i != out_axis)
    amax = np.maximum(np.abs(w).max(axis=red), 1e-12)
    scale = amax / w_max
    shape = [1] * w.ndim
    shape[out_axis] = -1
    q = np.clip(np.round(w / scale.reshape(shape)), -w_max, w_max)
    return q.astype(np.int16), scale.astype(np.float32)


def _act_scale(calib_max: float, act_max: int) -> float:
    return float(max(calib_max, 1e-6) * CALIB_MARGIN / act_max)


def _bq(b, scale) -> np.ndarray:
    """Bias -> int32, with the 2^30 headroom of the overflow argument
    checked: a degenerate calibration (near-zero activation maxima, tiny
    scales) raises instead of freezing a model that wraps int32."""
    q = np.round(np.asarray(b, np.float32) / scale)
    amax = float(np.abs(q).max()) if q.size else 0.0
    if amax > BUDGET:
        raise ValueError(
            f"quantized bias magnitude {amax:.3g} exceeds the int32 headroom "
            f"budget {BUDGET}; calibration activation scales are degenerate")
    return q.astype(np.int32)


def _abs_max(x) -> float:
    return float(x.abs().max().item())


def _fc_quantize(params, inputs_calib, width, device):
    from . import zoo

    fp = params["fully_connected"]
    tp = zoo.params_from_numpy(params, device)["fully_connected"]
    x = np.asarray(inputs_calib, np.float32)
    maxima = [float(np.abs(x).max())]
    acts = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    for i in range(3):
        acts = pnn.leaky_relu(fc_ops.fc_forward(
            acts, [tp[f"weights_{i}"]], [tp[f"biases_{i}"]]))
        maxima.append(_abs_max(acts))
    dims_k = [5 * width * width] + [pnn.HIDDEN_FC] * 3
    q = {"kind": "fc", "width": np.int32(width)}
    a0, _ = _layer_budget(dims_k[0])
    s_prev = _act_scale(maxima[0], a0)
    q["in_scale"] = np.float32(s_prev)
    q["in_cap"] = np.int32(a0)
    for i in range(4):
        _, w_max = _layer_budget(dims_k[i])
        wq, sw = _wq_per_out(fp[f"weights_{i}"], 1, w_max)
        q[f"w_{i}"] = wq
        q[f"b_{i}"] = _bq(fp[f"biases_{i}"], s_prev * sw)
        if i < 3:
            a_next, _ = _layer_budget(dims_k[i + 1])
            s_next = _act_scale(maxima[i + 1], a_next)
            q[f"m_{i}"] = (s_prev * sw / s_next).astype(np.float32)
            q[f"c_{i}"] = np.int32(a_next)
            s_prev = s_next
        else:
            q[f"m_{i}"] = (s_prev * sw).astype(np.float32)
    return q


def _conv_quantize(params, inputs_calib, width, device):
    from . import zoo

    cp = params["convolutional"]
    tp = zoo.params_from_numpy(params, device)["convolutional"]
    above, left = (np.asarray(a, np.float32) for a in inputs_calib)
    strides = pnn.STRIDES_BRANCH[width]
    maps_per_layer = pnn._branch_layer_maps(strides)
    q = {"kind": "conv", "width": np.int32(width),
         "strides": np.asarray(strides, np.int32)}
    in_max = max(float(np.abs(above).max()), float(np.abs(left).max()))

    # Contraction lengths per consumer layer.
    k_branch = []
    c_in = 1
    for i, s in enumerate(strides):
        k_branch.append((2 * s + 1) ** 2 * c_in)
        c_in = maps_per_layer[i]
    prod = int(np.prod(strides))
    w_out_ch = width // prod
    h0, w0 = width // prod, 3 * width // prod
    h1, w1 = 2 * width // prod, width // prod
    k_merger = h0 * w0 + h1 * w1
    strides_merger = strides[::-1]
    k_tconv = []
    c_in = maps_per_layer[-1]
    for i, s in enumerate(strides_merger):
        k_tconv.append((2 * s + 1) ** 2 * c_in)
        c_in = 1 if i == len(strides_merger) - 1 else c_in // s

    a_in, _ = _layer_budget(k_branch[0])
    s_in = _act_scale(in_max, a_in)
    q["in_scale"] = np.float32(s_in)
    q["in_cap"] = np.int32(a_in)

    # The float forward, layer by layer, for the activation maxima (NCHW).
    branch_scale, branch_outs = {}, {}
    for bname, xin in (("branch_above", above), ("branch_left", left)):
        x = torch.from_numpy(np.ascontiguousarray(xin)).to(device).permute(
            0, 3, 1, 2)
        s_prev = s_in
        for i, s in enumerate(strides):
            layer = tp[bname][f"convolution_{i}"]
            x = pnn.leaky_relu(pnn.conv2d_same(x, layer["weights"], s)
                               + layer["biases"][:, None, None])
            last = i == len(strides) - 1
            a_next, _ = _layer_budget(k_merger if last else k_branch[i + 1])
            s_next = _act_scale(_abs_max(x), a_next)
            _, w_max = _layer_budget(k_branch[i])
            npl = cp[bname][f"convolution_{i}"]
            wq, sw = _wq_per_out(npl["weights"], 3, w_max)
            q[f"{bname}/w_{i}"] = wq
            q[f"{bname}/b_{i}"] = _bq(npl["biases"], s_prev * sw)
            q[f"{bname}/m_{i}"] = (s_prev * sw / s_next).astype(np.float32)
            q[f"{bname}/c_{i}"] = np.int32(a_next)
            s_prev = s_next
        branch_scale[bname] = s_prev
        branch_outs[bname] = x.permute(0, 2, 3, 1)

    # Channelwise merger: the left branch is requantized onto the above
    # branch's scale first.
    s_merge_in = branch_scale["branch_above"]
    q["left_rescale"] = np.float32(branch_scale["branch_left"] / s_merge_in)
    q["merge_cap"] = q["branch_above/c_%d" % (len(strides) - 1)]
    cm = cp["merger"]["channelwise_fully_connected_merger"]
    tcm = tp["merger"]["channelwise_fully_connected_merger"]
    x = pnn.channelwise_fc_merger(
        tcm["weights"], tcm["biases"], branch_outs["branch_above"],
        branch_outs["branch_left"], w_out_ch, w_out_ch, act=True)
    a_next, _ = _layer_budget(k_tconv[0])
    s_next = _act_scale(_abs_max(x), a_next)
    _, w_max = _layer_budget(k_merger)
    wq, sw = _wq_per_out(cm["weights"], 0, w_max)   # per map
    q["merger/w"] = wq
    q["merger/b"] = _bq(cm["biases"], s_merge_in * sw[:, None])
    q["merger/m"] = (s_merge_in * sw / s_next).astype(np.float32)
    q["merger/c"] = np.int32(a_next)
    s_prev = s_next

    x = x.permute(0, 3, 1, 2)
    for i, s in enumerate(strides_merger):
        layer = tp["merger"][f"transpose_convolution_{i}"]
        last = i == len(strides_merger) - 1
        x = pnn.conv2d_transpose_same(x, layer["weights"], s) \
            + layer["biases"][:, None, None]
        if not last:
            x = pnn.leaky_relu(x)
        _, w_max = _layer_budget(k_tconv[i])
        npl = cp["merger"][f"transpose_convolution_{i}"]
        # TF layout (k, k, out, in): out axis 2.
        wq, sw = _wq_per_out(npl["weights"], 2, w_max)
        q[f"merger/t_w_{i}"] = wq
        q[f"merger/t_b_{i}"] = _bq(npl["biases"], s_prev * sw)
        if not last:
            a_next, _ = _layer_budget(k_tconv[i + 1])
            s_next = _act_scale(_abs_max(x), a_next)
            q[f"merger/t_m_{i}"] = (s_prev * sw / s_next).astype(np.float32)
            q[f"merger/t_c_{i}"] = np.int32(a_next)
            s_prev = s_next
        else:
            q[f"merger/t_m_{i}"] = (s_prev * sw).astype(np.float32)
    return q


def quantize_pnn(params: dict, inputs_calib, width: int,
                 is_fully_connected: bool, device="cuda") -> dict:
    """Float params + calibration inputs -> frozen quantized model dict
    (numpy arrays, np.savez-able; `params_from_numpy` carries it onto a
    device).

    `params` is the JAX package's nested dict of numpy arrays
    (`zoo.load_frozen_params`); `inputs_calib` has the `pnn.forward` input
    convention as numpy (flattened contexts for FC, the (above, left)
    portion pair for conv).  The float forward that sets the activation
    scales runs on `device` ("cuda" by default)."""
    device = torch.device(device)
    with torch.no_grad(), pnn.full_f32():
        if is_fully_connected:
            return _fc_quantize(params, inputs_calib, width, device)
        return _conv_quantize(params, inputs_calib, width, device)


# ----------------------------------------------------------- calibration --

def calibration_contexts(width: int, is_fully_connected: bool,
                         images=None, n_samples: int = 512,
                         seed: int = 0):
    """Calibration inputs (numpy): seeded crops of natural luma `images`,
    or with `images=None` synthetic patches (a level, a gradient and
    noise).  Masked variants are mixed in (the codec feeds zero-masked
    strips), so the activation maxima cover the masked regime too.
    Returns the `pnn.forward` input convention."""
    rng = np.random.default_rng(seed)
    w = width
    above = np.zeros((n_samples, w, 3 * w), np.float32)
    left = np.zeros((n_samples, 2 * w, w), np.float32)
    if images is None:
        for i in range(n_samples):
            base = rng.uniform(0, 255)
            grad = rng.normal(0, 2.0, 2)
            noise = rng.normal(0, rng.uniform(1, 25))
            yy, xx = np.mgrid[0:2 * w, 0:3 * w]
            patch = base + grad[0] * yy + grad[1] * xx \
                + noise * rng.standard_normal((2 * w, 3 * w))
            patch = np.clip(patch, 0, 255) - 128.0
            above[i] = patch[:w, :]
            left[i] = patch[:, :w]
    else:
        mean = 128.0
        for i in range(n_samples):
            img = images[rng.integers(len(images))]
            h_img, w_img = img.shape
            y = rng.integers(w, h_img - 2 * w)
            x = rng.integers(w, w_img - 2 * w)
            above[i] = img[y - w:y, x - w:x + 2 * w].astype(np.float32) - mean
            left[i] = img[y:y + 2 * w, x - w:x].astype(np.float32) - mean
    # Random strip masking (codec regime).
    n_units = (2 * w) // 4
    for i in range(n_samples):
        if rng.random() < 0.5:
            ka = rng.integers(0, n_units + 1)
            kl = rng.integers(0, n_units + 1)
            if ka:
                above[i, :, 3 * w - 4 * ka:] = 0.0
            if kl:
                left[i, 2 * w - 4 * kl:, :] = 0.0
    if is_fully_connected:
        return np.concatenate(
            [above.reshape(n_samples, -1), left.reshape(n_samples, -1)],
            axis=1)
    return above[..., None], left[..., None]
