"""Loading the frozen quantized PNN zoo into a `PnnBundle`.

The port's copy of `parse_manifest` (JAX package `cli/export_pnn.py:36`)
and of the quantized half of `load_codec_bundle` (`models/zoo.py:77`):
the three-key manifests ("width,is_pair,channel,path" lines, the
reference's `paths_to_graphs_output/*.txt` format) name one frozen integer
model per (width, single | pair).  Float models are not read here.
`load_bundle_npz` reads a bundle kept in one file (the test bundle of
`tests/golden_torch/`).
"""

from __future__ import annotations

import os

import numpy as np

from . import pnn_q


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

    root = os.path.dirname(os.path.abspath(manifest_path))
    quantized, pair_quantized = {}, {}
    for (width, is_pair), path in parse_manifest(manifest_path).items():
        if (is_pair and not use_pair) or (widths is not None
                                          and width not in widths):
            continue
        local = os.path.join(root, os.path.basename(path))
        if not os.path.isfile(local):
            raise FileNotFoundError(f"{manifest_path}: model {path!r} is "
                                    f"not at {local}")
        (pair_quantized if is_pair else quantized)[width] = \
            pnn_q.load_quantized(local)
    return PnnBundle(quantized, mean_training,
                     pair_quantized=pair_quantized or None)


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
