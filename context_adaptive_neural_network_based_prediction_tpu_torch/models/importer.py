"""Loading float PNN parameters saved as `.npz`.

The port of the TF-free half of the JAX package's `models/importer.py`
(`arrays_to_params` :33, `load_npz_params` :55): flat "scope/path/name"
arrays become the nested param dict of `models/pnn.py` (numpy, float32),
which `zoo.params_from_numpy` carries onto a device.  The port has no
TensorFlow, so `import_tf_checkpoint` raises: convert a checkpoint to
`.npz` with the JAX package's `convert_checkpoint_to_npz` first.
"""

from __future__ import annotations

import numpy as np


def arrays_to_params(arrays: dict) -> dict:
    """Converts flat {scope/path/name: array} into the nested param dict."""
    params: dict = {}
    for name, arr in arrays.items():
        node = params
        parts = name.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.asarray(arr).astype(np.float32)
    return params


def load_npz_params(path_to_npz: str) -> dict:
    with np.load(path_to_npz) as data:
        return arrays_to_params({k: data[k] for k in data.files})


def import_tf_checkpoint(path_to_checkpoint: str) -> dict:
    raise NotImplementedError(
        f"{path_to_checkpoint}: the PyTorch port reads .npz parameters only "
        f"(it has no TensorFlow); convert the checkpoint to .npz first")
