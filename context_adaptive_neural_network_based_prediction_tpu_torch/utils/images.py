"""Image loading, saving and cropping (PIL, imported when called).

The port's copy of the JAX package's `utils/images.py` (`read_image_mode`
:13, `save_image` :23, `crop_option_2d` :35, `crop_to_multiple` :54).
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


def save_image(path: str, array_uint8: np.ndarray,
               coefficient_enlargement: int | None = None) -> None:
    """Saves a uint8 array (H, W) or (H, W, 3) as an image, optionally
    enlarged by pixel repetition."""
    import PIL.Image

    if array_uint8.dtype != np.uint8:
        raise TypeError("`array_uint8.dtype` is not uint8.")
    arr = array_uint8
    if coefficient_enlargement is not None:
        arr = np.repeat(np.repeat(arr, coefficient_enlargement, axis=0),
                        coefficient_enlargement, axis=1)
    PIL.Image.fromarray(arr).save(path)


def crop_option_2d(channel_uint8: np.ndarray, is_random: bool,
                   width_crop: int,
                   rng: np.random.Generator | None = None) -> np.ndarray:
    """Crops a (H, W) channel to (width_crop, width_crop), at a random
    position drawn from `rng` or centered."""
    h, w = channel_uint8.shape
    if h < width_crop or w < width_crop:
        raise ValueError("the channel is too small for the crop.")
    if is_random:
        rng = rng or np.random.default_rng()
        r = int(rng.integers(0, h - width_crop + 1))
        c = int(rng.integers(0, w - width_crop + 1))
    else:
        r = (h - width_crop) // 2
        c = (w - width_crop) // 2
    return channel_uint8[r:r + width_crop, c:c + width_crop]


def crop_to_multiple(channel: np.ndarray, multiple: int) -> np.ndarray:
    """Crops the bottom and right of a (H, W) channel so both dims are
    multiples of `multiple`."""
    h, w = channel.shape[:2]
    return channel[: (h // multiple) * multiple, : (w // multiple) * multiple]
