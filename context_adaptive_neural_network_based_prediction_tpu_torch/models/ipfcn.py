"""IPFCN-S baseline (Li et al., "Fully Connected Network-Based Intra
Prediction for Image Coding", TIP 2018) in PyTorch.

The port of the JAX package's `models/ipfcn.py`
(`extract_pair_groups_lines_from_channel` :28, `preprocess_pair_groups`
:45, `init_params` :62, `prelu` :76, `forward` :80, `predict_uint8` :93,
`load_npz_params` :102, the protobuf reader `_walk_protobuf` :117,
`_parse_blob` :165, `parse_caffemodel` :201, `import_caffemodel` :222,
`convert_caffemodel_to_npz` :243):

* input: two groups of 4 + 4 = 8 reference lines, above (8, 2w + 8) and
  left (2w, 8), flattened (above first) into a 32w + 64 vector;
* each example's mean over both groups is subtracted on the host and
  added back to the output;
* net: fc1 (1024) -> PReLU -> fc2 (1024) -> PReLU -> fc3 (1024) -> PReLU
  -> fc4 (w^2), learned per-channel PReLU slopes.  The four products are
  `torch.matmul` in float32 (the JAX package leaves them to XLA; no
  kernel of the port is involved);
* weights from a caffemodel read by a schema-less protobuf parser (no
  pycaffe), from an `.npz` with keys fc{i}_weights / fc{i}_biases /
  prelu{i}_slopes, or drawn from a `torch.Generator`.

Params are dicts of numpy float32 arrays, (in, out) weights; `forward`
takes them as tensors on its device (`params_to_device`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import pnn

HIDDEN = 1024


def extract_pair_groups_lines_from_channel(channel_single_or_pair_uint8,
                                           width_target: int,
                                           row_1st: int, col_1st: int):
    """(above (8, 2w+8, 1), left (2w, 8, 1)) uint8 reference-line groups."""
    ch = channel_single_or_pair_uint8
    if ch.dtype != np.uint8:
        raise TypeError("channel dtype must be uint8")
    h, w_ch, nc = ch.shape
    w = width_target
    if row_1st < 0 or col_1st < 0 or row_1st + 2 * w + 8 > h \
            or col_1st + 2 * w + 8 > w_ch:
        raise ValueError("extraction exceeds channel bounds")
    i = nc - 1
    above = ch[row_1st:row_1st + 8, col_1st:col_1st + 2 * w + 8, i:i + 1]
    left = ch[row_1st + 8:row_1st + 2 * w + 8, col_1st:col_1st + 8, i:i + 1]
    return above, left


def preprocess_pair_groups(groups_above_uint8, groups_left_uint8):
    """Flattens and subtracts each example's mean.  Inputs (N, 8, 2w+8, 1)
    and (N, 2w, 8, 1); returns (flattened (N, 32w+64) float32, means (N,)
    float32)."""
    a = groups_above_uint8.astype(np.float32)
    l = groups_left_uint8.astype(np.float32)
    n = a.shape[0]
    size = a[0].size + l[0].size
    means = (a.sum(axis=(1, 2, 3)) + l.sum(axis=(1, 2, 3))) / size
    a = a - means[:, None, None, None]
    l = l - means[:, None, None, None]
    flat = np.concatenate([a.reshape(n, -1), l.reshape(n, -1)], axis=1)
    return flat, means


def init_params(generator: torch.Generator, width_target: int) -> dict:
    """A new net: weights N(0, 1 / fan-in) from `generator` (on the CPU),
    zero biases, PReLU slopes 0.25; numpy float32."""
    w2 = width_target ** 2
    d_in = 32 * width_target + 64
    dims = [(d_in, HIDDEN), (HIDDEN, HIDDEN), (HIDDEN, HIDDEN), (HIDDEN, w2)]
    params = {}
    for i, (a, b) in enumerate(dims, start=1):
        z = torch.randn((a, b), generator=generator, dtype=torch.float32)
        params[f"fc{i}_weights"] = (np.float32(1.0 / math.sqrt(a))
                                    * z.numpy()).astype(np.float32)
        params[f"fc{i}_biases"] = np.zeros((b,), np.float32)
        if i < 4:
            params[f"prelu{i}_slopes"] = np.full((b,), 0.25, np.float32)
    return params


def params_to_device(params: dict, device) -> dict:
    """The params as float32 tensors on `device`."""
    return {k: torch.tensor(np.asarray(v, np.float32)).to(device)
            for k, v in params.items()}


def prelu(x, slopes):
    return torch.where(x >= 0, x, slopes * x)


def forward(params: dict, flattened, width_target: int):
    """(N, 32w+64) float32 -> (N, w, w, 1) mean-removed prediction; params
    and input tensors on one device."""
    x = flattened
    with pnn.full_f32():
        for i in range(1, 4):
            x = prelu(torch.matmul(x, params[f"fc{i}_weights"])
                      + params[f"fc{i}_biases"], params[f"prelu{i}_slopes"])
        x = torch.matmul(x, params["fc4_weights"]) + params["fc4_biases"]
    return x.reshape(x.shape[0], width_target, width_target, 1)


def predict_uint8(params: dict, groups_above_uint8, groups_left_uint8,
                  width_target: int, device="cuda") -> np.ndarray:
    """IPFCN-S inference to pixel space (the mean added back, rounded,
    clipped) on `device` -> (N, w, w) uint8 numpy."""
    flat, means = preprocess_pair_groups(groups_above_uint8,
                                         groups_left_uint8)
    dev = torch.device(device)
    pred = forward(params_to_device(params, dev),
                   torch.from_numpy(flat).to(dev), width_target)
    pred = pred.cpu().numpy()[..., 0]
    out = np.clip(np.round(pred + means[:, None, None]), 0, 255)
    return out.astype(np.uint8)


def load_npz_params(path: str) -> dict:
    with np.load(path) as data:
        return {k: np.asarray(data[k]) for k in data.files}


# ------------------------------------------------ caffemodel import ----
#
# The shipped IPFCN-S weights are a Caffe NetParameter protobuf, read here
# without pycaffe by a minimal schema-less wire parser:
# NetParameter.layer = field 100, LayerParameter.{name = 1, type = 2,
# blobs = 7}, BlobProto.{data = 5 (packed floats), shape = 7
# (BlobShape.dim = 1)}.

def _varint(data: bytes, pos: int):
    """(value, position after it) of the varint at `pos`."""
    v = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return v, pos


def _walk_protobuf(data: bytes):
    """Yields (field_number, wire_type, value) over one message's fields."""
    pos = 0
    n = len(data)
    while pos < n:
        key, pos = _varint(data, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, pos = _varint(data, pos)
            yield field, wt, v
        elif wt == 1:
            yield field, wt, data[pos:pos + 8]
            pos += 8
        elif wt == 2:
            ln, pos = _varint(data, pos)
            yield field, wt, data[pos:pos + ln]
            pos += ln
        elif wt == 5:
            yield field, wt, data[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")


def _parse_blob(data: bytes) -> np.ndarray:
    dims = []
    floats = []
    legacy = {}
    for field, wt, v in _walk_protobuf(data):
        if field == 5 and wt in (2, 5):     # packed or unpacked floats
            floats.append(np.frombuffer(v, dtype="<f4"))
        elif field == 7 and wt == 2:        # BlobShape
            for f2, w2, v2 in _walk_protobuf(v):
                if f2 == 1 and w2 == 0:
                    dims.append(int(v2))
                elif f2 == 1 and w2 == 2:   # packed varints
                    pos2 = 0
                    while pos2 < len(v2):
                        d, pos2 = _varint(v2, pos2)
                        dims.append(d)
        elif field in (1, 2, 3, 4) and wt == 0:  # legacy num/chan/h/w
            legacy[field] = int(v)
    arr = np.concatenate(floats) if floats else np.zeros(0, np.float32)
    if not dims and legacy:
        dims = [legacy.get(i, 1) for i in (1, 2, 3, 4)]
    if dims:
        arr = arr.reshape([d for d in dims if d > 0] or (-1,))
    return arr


def parse_caffemodel(path_to_caffemodel: str) -> dict:
    """{layer_name: (layer_type, [blob arrays])} from a caffemodel file."""
    with open(path_to_caffemodel, "rb") as f:
        data = f.read()
    layers = {}
    for field, wt, v in _walk_protobuf(data):
        if field == 100 and wt == 2:    # LayerParameter
            name = ltype = None
            blobs = []
            for f2, w2, v2 in _walk_protobuf(v):
                if f2 == 1 and w2 == 2:
                    name = v2.decode("utf-8", "replace")
                elif f2 == 2 and w2 == 2:
                    ltype = v2.decode("utf-8", "replace")
                elif f2 == 7 and w2 == 2:
                    blobs.append(_parse_blob(v2))
            if name is not None:
                layers[name] = (ltype, blobs)
    return layers


def import_caffemodel(path_to_caffemodel: str) -> dict:
    """IPFCN-S caffemodel -> this module's param dict (Caffe InnerProduct
    weights are (out, in), transposed to (in, out))."""
    layers = parse_caffemodel(path_to_caffemodel)
    params = {}
    for i in range(1, 5):
        ltype, blobs = layers[f"fc{i}"]
        if ltype not in (None, "InnerProduct"):
            raise ValueError(f"fc{i} is {ltype}, expected InnerProduct")
        w, b = blobs[0], blobs[1]
        if w.ndim > 2:
            w = w.reshape(w.shape[-2], w.shape[-1])
        params[f"fc{i}_weights"] = np.ascontiguousarray(w.T)
        params[f"fc{i}_biases"] = b.reshape(-1)
        if i < 4:
            params[f"prelu{i}_slopes"] = layers[f"relu{i}"][1][0].reshape(-1)
    return params


def convert_caffemodel_to_npz(path_to_caffemodel: str, path_to_npz: str,
                              width_target: int = 4) -> None:
    """Converts a caffemodel to the `.npz` layout (no pycaffe)."""
    del width_target
    np.savez(path_to_npz, **import_caffemodel(path_to_caffemodel))
