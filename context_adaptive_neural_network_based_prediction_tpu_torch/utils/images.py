"""Image loading (PIL, imported when called).

The port's copy of `read_image_mode` (:13) of the JAX package's
`utils/images.py`.
"""

from __future__ import annotations

import numpy as np


def read_image_mode(path: str, mode: str) -> np.ndarray:
    """Loads an image, raising if its PIL mode differs from `mode`."""
    import PIL.Image

    image = PIL.Image.open(path)
    if image.mode != mode:
        raise ValueError(f"The image mode is {image.mode} whereas the given "
                         f"mode is {mode}.")
    return np.asarray(image)
