"""Raw YUV 4:0:0 / 4:2:0 planar file IO (numpy, on the host).

The port's copy of the JAX package's `utils/yuv.py` (`read_400_or_420`
:20, `write_400_or_420` :47), the reference's `hevc/running.py:286-428`:

* videos are arrays of shape (H, W, C, T) with C in {1, 3};
* writing 4:2:0 subsamples chroma by taking every other row and column;
* reading 4:2:0 upsamples chroma back by pixel repetition;
* writing refuses to overwrite an existing file.
"""

from __future__ import annotations

import os

import numpy as np


def read_400_or_420(height_video: int, width_video: int, nb_frames: int,
                    data_type, is_400: bool, path_to_video: str) -> np.ndarray:
    """Reads a 4:0:0 luma or 4:2:0 YCbCr planar video from a raw file.

    Returns (H, W, 1, T) for 4:0:0 or (H, W, 3, T) for 4:2:0, chroma
    upsampled by pixel repetition."""
    if data_type not in (np.uint8, np.uint16):
        raise TypeError("`data_type` must be numpy.uint8 or numpy.uint16.")
    if height_video % 2 or width_video % 2:
        raise ValueError("video dimensions must be even.")
    n_px = height_video * width_video
    nb_channels = 1 if is_400 else 3
    video = np.zeros((height_video, width_video, nb_channels, nb_frames),
                     dtype=data_type)
    with open(path_to_video, "rb") as f:
        for t in range(nb_frames):
            y = np.fromfile(f, dtype=data_type, count=n_px)
            video[:, :, 0, t] = y.reshape(height_video, width_video)
            if not is_400:
                for c in (1, 2):
                    plane = np.fromfile(f, dtype=data_type, count=n_px // 4)
                    plane = plane.reshape(height_video // 2, width_video // 2)
                    video[:, :, c, t] = np.repeat(np.repeat(plane, 2, axis=0),
                                                  2, axis=1)
    return video


def write_400_or_420(video_uint8or16: np.ndarray, path_to_video: str) -> None:
    """Writes a (H, W, C, T) video as raw planar 4:0:0 (C=1) or 4:2:0
    (C=3)."""
    if video_uint8or16.dtype not in (np.uint8, np.uint16):
        raise TypeError("video dtype must be uint8 or uint16.")
    height_video, width_video, nb_channels, nb_frames = video_uint8or16.shape
    if height_video % 2 or width_video % 2:
        raise ValueError("video dimensions must be even.")
    if nb_channels not in (1, 3):
        raise ValueError("channel count must be 1 or 3.")
    if os.path.isfile(path_to_video):
        raise IOError(f'"{path_to_video}" already exists.')
    with open(path_to_video, "wb") as f:
        for t in range(nb_frames):
            video_uint8or16[:, :, 0, t].flatten().tofile(f)
            if nb_channels == 3:
                video_uint8or16[::2, ::2, 1, t].flatten().tofile(f)
                video_uint8or16[::2, ::2, 2, t].flatten().tofile(f)
