"""Colored intra-mode maps (numpy, on the host).

The port's copy of the JAX package's `evaluation/maps.py` (the
reference's PPM mode maps, `TEncSlice.cpp:1092-1180`,
`comparing_maps_modes.py`): each prediction block painted with a color
class, from the encoder's mode map, written as binary PPM:

* red      : Planar or DC,
* sky blue : mode 18 (the mode the substitution codec replaces),
* blue     : PNNS (mode 35, switch codec),
* orange   : other angular modes.
"""

from __future__ import annotations

import os

import numpy as np

COLOR_PLANAR_DC = (255, 0, 0)
COLOR_MODE_18 = (135, 206, 235)
COLOR_PNNS = (0, 0, 255)
COLOR_ANGULAR = (255, 165, 0)
COLOR_UNSET = (0, 0, 0)


def mode_map_to_rgb(mode_map_units: np.ndarray) -> np.ndarray:
    """(Hu, Wu) per-4x4-unit modes -> (Hu*4, Wu*4, 3) uint8 color image."""
    hu, wu = mode_map_units.shape
    rgb = np.zeros((hu, wu, 3), dtype=np.uint8)
    m = mode_map_units
    rgb[(m == 0) | (m == 1)] = COLOR_PLANAR_DC
    rgb[m == 18] = COLOR_MODE_18
    rgb[m == 35] = COLOR_PNNS
    angular = (m >= 2) & (m <= 34) & (m != 18)
    rgb[angular] = COLOR_ANGULAR
    rgb[m < 0] = COLOR_UNSET
    return np.repeat(np.repeat(rgb, 4, axis=0), 4, axis=1)


def write_ppm(path: str, rgb_uint8: np.ndarray) -> None:
    """Binary P6 PPM writer."""
    h, w = rgb_uint8.shape[:2]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(rgb_uint8.astype(np.uint8).tobytes())


def read_ppm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        if f.readline().strip() != b"P6":
            raise ValueError(f"{path} is not a binary PPM")
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = map(int, line.split())
        if f.readline().strip() != b"255":
            raise ValueError(f"{path}: only 8-bit PPM is read")
        data = np.frombuffer(f.read(w * h * 3), dtype=np.uint8)
    return data.reshape(h, w, 3)


def write_mode_map(encode_result, path_to_ppm: str) -> None:
    write_ppm(path_to_ppm, mode_map_to_rgb(encode_result.mode_map))
