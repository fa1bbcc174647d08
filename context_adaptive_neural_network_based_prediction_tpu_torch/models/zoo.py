"""The PNN zoo: frozen models, loading onto a device, batched inference.

The port's copy of `parse_manifest` (JAX package `cli/export_pnn.py:36`)
and of `load_codec_bundle` (`models/zoo.py:77`): the three-key manifests
("width,is_pair,channel,path" lines, the reference's
`paths_to_graphs_output/*.txt` format) name one frozen model per (width,
single | pair), float (`load_codec_bundle`, with an optional quantized
manifest beside it) or integer (`load_quantized_bundle`).  Entries are
read from the manifest's own directory by file name.  `load_bundle_npz`
reads a bundle kept in one file (the test bundle of
`tests/golden_torch/`).

Float models: `load_frozen_params` (`models/zoo.py:60`) reads a frozen
float `.npz` into the JAX package's nested dict of numpy arrays,
`params_from_numpy` carries such a dict onto a device in the port's
layouts, `params_to_numpy` is its exact inverse (checkpoints and exports
are written in the JAX layout, so either package reads them), and
`predict_by_batch` (`models/zoo.py:40`) runs `pnn.forward` over any
number of examples in chunks of 1024, returning numpy.
`model_directory` (`models/zoo.py:22`) is the trained models' directory
convention.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import pnn, pnn_q


def model_directory(root: str, width_target: int, is_fully_connected: bool,
                    is_pair: bool, channel: str, coeff_l2: float,
                    coeff_grad: float, tuple_width_height_masks_tr) -> str:
    """<root>/width_target_<w>/<fully_connected|convolutional>/<single|pair>/
    <channel>/<coeff_l2>_<coeff_grad>/masks_tr_<wa_hl | random>/."""
    arch = "fully_connected" if is_fully_connected else "convolutional"
    pair = "pair" if is_pair else "single"

    def fmt(c):
        return f"{c:g}".replace(".", "_")
    coeffs = f"{fmt(coeff_l2)}_{fmt(coeff_grad)}"
    if tuple_width_height_masks_tr:
        masks = "masks_tr_{}_{}".format(*tuple_width_height_masks_tr)
    else:
        masks = "masks_tr_random"
    return os.path.join(root, f"width_target_{width_target}", arch, pair,
                        channel, coeffs, masks)


def parse_manifest(path: str) -> dict:
    """Parses "width,is_pair,channel,path" lines -> {(width, is_pair): path}."""
    table = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            width, is_pair, _channel, model_path = line.split(",", 3)
            table[(int(width), bool(int(is_pair)))] = model_path
    return table


def load_quantized_bundle(manifest_path: str, mean_training, *,
                          use_pair: bool = True, widths=None):
    """Quantized manifest -> `PnnBundle` (numpy model dicts).

    Each entry is read from the manifest's own directory by its file name
    (the manifests name absolute paths of the machine that wrote them); a
    missing file raises.  `use_pair=False` drops the pair entries (the
    QP >= 32 pair selection, an encoder and decoder config); `widths`
    limits the widths read (None: all)."""
    from ..codec.nn_intra import PnnBundle

    quantized, pair_quantized = _read_manifest(
        manifest_path, pnn_q.load_quantized, use_pair, widths)
    return PnnBundle(quantized, mean_training,
                     pair_quantized=pair_quantized or None)


def _read_manifest(manifest_path, load, use_pair, widths=None):
    """({width: single model}, {width: pair model}) of a manifest, each
    entry read by `load` from the manifest's directory by its file name
    (the manifests name absolute paths of the machine that wrote them); a
    missing file raises."""
    root = os.path.dirname(os.path.abspath(manifest_path))
    singles, pairs = {}, {}
    for (width, is_pair), path in parse_manifest(manifest_path).items():
        if (is_pair and not use_pair) or (widths is not None
                                          and width not in widths):
            continue
        local = os.path.join(root, os.path.basename(path))
        if not os.path.isfile(local):
            raise FileNotFoundError(f"{manifest_path}: model {path!r} is "
                                    f"not at {local}")
        (pairs if is_pair else singles)[width] = load(local)
    return singles, pairs


def load_codec_bundle(manifest_path: str, mean_training,
                      quantized_manifest_path: str = None,
                      use_pair: bool = True, widths=None):
    """Float manifest (and optionally a quantized one) -> `PnnBundle`
    (JAX package `models/zoo.py:77`).  The float models are the JAX
    package's nested dicts of numpy arrays; `bundle.quantize()` freezes
    them.  `quantized_manifest_path` adds frozen integer models, the
    codec's normative forward at their widths (a path that is not a file
    raises).  `use_pair=False` drops the pair entries of both manifests
    (the QP >= 32 pair selection, an encoder and decoder config);
    `widths` limits the widths read (None: all)."""
    from ..codec.nn_intra import PnnBundle

    params, pair_params = _read_manifest(
        manifest_path, lambda p: load_frozen_params(p)[0], use_pair, widths)
    quantized = pair_quantized = None
    if quantized_manifest_path is not None:
        if not os.path.isfile(quantized_manifest_path):
            raise FileNotFoundError(quantized_manifest_path)
        quantized, pair_quantized = _read_manifest(
            quantized_manifest_path, pnn_q.load_quantized, use_pair, widths)
    return PnnBundle(quantized, mean_training,
                     pair_quantized=pair_quantized or None,
                     params=params, pair_params=pair_params or None)


def load_bundle_npz(path: str):
    """A `PnnBundle` saved as one .npz: entries "<width>/<name>" of each
    quantized model and "mean" (one float for every width)."""
    from ..codec.nn_intra import PnnBundle

    quantized = {}
    with np.load(path) as data:
        for key in data.files:
            if key == "mean":
                continue
            width, name = key.split("/", 1)
            v = data[key]
            quantized.setdefault(int(width), {})[name] = \
                v.item() if name == "kind" else v
        mean = float(data["mean"])
    return PnnBundle(quantized, mean)


# ------------------------------------------------------------ float zoo ----

def load_frozen_params(path: str):
    """A frozen float .npz ("scope/.../name" keys) -> (nested dict of numpy
    arrays, is_fully_connected)."""
    with np.load(path) as data:
        params: dict = {}
        for key in data.files:
            node = params
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = np.asarray(data[key])
    return params, "fully_connected" in params


def _leaf_to_tensor(path, a, device, weight_dtype, dtype=torch.float32):
    """One float parameter in the port's layout: conv weights TF (k, k, in,
    out) and transpose-conv weights TF (k, k, out, in) both become (dim 3,
    dim 2, k, k), i.e. (out, in, k, k) and (in, out, k, k); merger weights
    (M, P, O) -> (P, O, M) and biases (M, O) -> (O, M); FC and merger
    weights in `weight_dtype`, everything else in `dtype` (float64: every
    leaf)."""
    wide = dtype == torch.float64
    a = np.asarray(a, np.float64 if wide else np.float32)
    name, scope = path[-1], path[-2] if len(path) > 1 else ""
    weight_dtype = dtype if wide else weight_dtype
    if scope == "channelwise_fully_connected_merger":
        a = a.transpose(1, 2, 0) if name == "weights" else a.T
        dtype = weight_dtype if name == "weights" else dtype
    elif name == "weights" and a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    elif name.startswith("weights_"):
        dtype = weight_dtype
    # A copy: training updates params in place, which must not write
    # into the caller's arrays.
    return torch.tensor(np.ascontiguousarray(a)).to(device=device,
                                                    dtype=dtype)


def params_from_numpy(params: dict, device="cuda",
                      weight_dtype=torch.float32,
                      dtype=torch.float32) -> dict:
    """The JAX package's nested float params (numpy arrays, or anything
    `np.asarray` takes) -> the same nesting of tensors on `device`, laid out
    for `pnn.forward`.  `weight_dtype` (float32 or bfloat16) is the storage
    of the two kernels' weights (the FC layers and the merger); the
    convolutions stay float32.  `dtype` float64 stores every leaf in
    float64 (a float64 training run, the reference of a float32 one)."""
    if weight_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"weight_dtype must be float32 or bfloat16, got "
                         f"{weight_dtype}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    dev = torch.device(device)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return _leaf_to_tensor(path, node, dev, weight_dtype, dtype)

    return walk(params, ())


def _leaf_to_numpy(path, t):
    """The inverse of `_leaf_to_tensor`: one parameter tensor back in the
    JAX layout, numpy float32 (bfloat16 widens exactly), or float64 from
    float64."""
    a = t.detach().to(device="cpu", dtype=torch.float64
                      if t.dtype == torch.float64 else torch.float32).numpy()
    name, scope = path[-1], path[-2] if len(path) > 1 else ""
    if scope == "channelwise_fully_connected_merger":
        a = a.transpose(2, 0, 1) if name == "weights" else a.T
    elif name == "weights" and a.ndim == 4:
        a = a.transpose(2, 3, 1, 0)
    return np.ascontiguousarray(a)


def params_to_numpy(params: dict) -> dict:
    """Tensors in the port's layouts (`params_from_numpy`'s output, or
    trained params) -> the JAX package's nested dict of numpy float32
    arrays (float64 where the tensors are): HWIO conv weights, HWOI
    transpose-conv weights, merger (M, P, O) weights and (M, O) biases."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return _leaf_to_numpy(path, node)

    return walk(params, ())


def _params_device(params) -> torch.device:
    node = params
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return node.device


def predict_by_batch(params: dict, inputs, width_target: int,
                     is_fully_connected: bool,
                     batch_size: int = 1024) -> np.ndarray:
    """Chunked inference of `params_from_numpy` params over numpy inputs
    (a flattened-context array for FC nets, an (above, left) tuple for
    conv nets) -> (N, w, w, 1) float32 numpy.  Each chunk is copied to the
    params' device and back."""
    dev = _params_device(params)
    if is_fully_connected:
        n = inputs.shape[0]
        get = lambda lo, hi: torch.from_numpy(
            np.ascontiguousarray(inputs[lo:hi], np.float32)).to(dev)
    else:
        above, left = inputs
        n = above.shape[0]
        get = lambda lo, hi: tuple(
            torch.from_numpy(np.ascontiguousarray(a[lo:hi], np.float32)).to(
                dev) for a in (above, left))
    outs = []
    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        outs.append(pnn.forward(params, get(lo, hi), width_target,
                                is_fully_connected).cpu().numpy())
    return np.concatenate(outs, axis=0)
