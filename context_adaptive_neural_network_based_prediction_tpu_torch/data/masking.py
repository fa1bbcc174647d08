"""Context preprocessing: mean subtraction, masking, flattening (numpy, on
the host).

The port's copy of the JAX package's `data/masking.py`
(`check_mask_sizes` :31, `mask_portions` :37,
`preprocess_context_portions_targets` :59, `flatten_portions` :86), numpy
only:

* preprocess = float32(x) - mean_training;
* the rightmost `width_mask_above` columns of the above portion and the
  bottom `height_mask_left` rows of the left portion are zeroed (after the
  mean subtraction); valid mask sizes are {0, 4, 8, ..., w};
* fully-connected nets take the two portions flattened and concatenated
  (above first) into a 5w^2 vector.
"""

from __future__ import annotations

import numpy as np


def check_mask_sizes(width_target: int, width_mask_above: int,
                     height_mask_left: int) -> None:
    for v, name in ((width_mask_above, "width_mask_above"),
                    (height_mask_left, "height_mask_left")):
        if v < 0 or v > width_target or v % 4 != 0:
            raise ValueError(f"`{name}` does not belong to "
                             f"{{0, 4, ..., {width_target}}}.")


def mask_portions(portions_above, portions_left, width_mask_above,
                  height_mask_left):
    """Zeroes the masked region of batched (N, w, 3w, 1) / (N, 2w, w, 1)
    float portions.  The mask sizes are ints, or arrays of shape (N,) for a
    mask per example."""
    w3 = portions_above.shape[2]
    h2 = portions_left.shape[1]
    cols = np.arange(w3).reshape(1, 1, w3, 1)
    rows = np.arange(h2).reshape(1, h2, 1, 1)
    wa = np.asarray(width_mask_above)
    hl = np.asarray(height_mask_left)
    if wa.ndim == 1:
        wa = wa.reshape(-1, 1, 1, 1)
    if hl.ndim == 1:
        hl = hl.reshape(-1, 1, 1, 1)
    above = np.where(cols >= w3 - wa, 0.0, portions_above)
    left = np.where(rows >= h2 - hl, 0.0, portions_left)
    return above, left


def preprocess_context_portions_targets(portions_above_uint8,
                                        portions_left_uint8, targets_uint8,
                                        mean_training: float,
                                        tuple_width_height_masks,
                                        is_fully_connected: bool):
    """Mean-subtracts, masks and (for FC nets) flattens batched extraction
    triplets.

    Returns (flattened_contexts (N, 5w^2), targets (N, w, w, 1)) if FC,
    else (above (N, w, 3w, 1), left (N, 2w, w, 1), targets (N, w, w, 1)),
    all float32."""
    width_target = targets_uint8.shape[1]
    width_mask_above, height_mask_left = tuple_width_height_masks
    if isinstance(width_mask_above, int) and isinstance(height_mask_left,
                                                        int):
        check_mask_sizes(width_target, width_mask_above, height_mask_left)

    above = portions_above_uint8.astype(np.float32) - mean_training
    left = portions_left_uint8.astype(np.float32) - mean_training
    above, left = mask_portions(above, left, width_mask_above,
                                height_mask_left)
    targets = targets_uint8.astype(np.float32) - mean_training
    if is_fully_connected:
        return flatten_portions(above, left), targets
    return above, left, targets


def flatten_portions(portions_above, portions_left):
    """Concatenates batched (N, w, 3w, 1) / (N, 2w, w, 1) portions into
    (N, 5w^2) vectors, above first."""
    n = portions_above.shape[0]
    return np.concatenate((portions_above.reshape(n, -1),
                           portions_left.reshape(n, -1)), axis=1)
