"""Freezes a trained PNN checkpoint for inference and writes manifests.

    python -m context_adaptive_neural_network_based_prediction_tpu_torch.cli.export_pnn \\
        pnn/results/.../model_800000.ckpt.pkl artifacts/frozen/pnn_w8.npz

The port of the JAX package's `cli/export_pnn.py` (`freeze_checkpoint`
:20, `write_manifest` :49, `main` :55).  Freezing turns a checkpoint of
either package (`training.read_checkpoint`, no jax or optax) into an
inference `.npz` of flat "scope/name" arrays in the JAX layout, params
only, which `zoo.load_frozen_params` and the JAX package's
`importer.load_npz_params` both read.  Manifests are the three-key
"width,is_pair,channel,path" files (`zoo.parse_manifest` reads them).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..models import training
from ..models.zoo import parse_manifest  # noqa: F401  (the CLI's reader)


def freeze_checkpoint(path_to_ckpt: str, path_to_npz: str) -> None:
    params = training.read_checkpoint(path_to_ckpt)["params"]
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(params, "")
    os.makedirs(os.path.dirname(path_to_npz) or ".", exist_ok=True)
    np.savez(path_to_npz, **flat)


def write_manifest(table: dict, path: str) -> None:
    """{(width, is_pair): path} -> "width,is_pair,0,path" lines."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for (width, is_pair), model_path in sorted(table.items()):
            f.write(f"{width},{int(is_pair)},0,{model_path}\n")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("checkpoint", help="path to model_<step>.ckpt.pkl")
    p.add_argument("output", help="output .npz path")
    args = p.parse_args(argv)
    freeze_checkpoint(args.checkpoint, args.output)
    print(f"froze {args.checkpoint} -> {args.output}")


if __name__ == "__main__":
    main()
