"""Dataset builders: test sets, sharded training sets, channel means.

The port of the JAX package's `data/datasets.py` (`build_test_set` :36,
`compute_luminance_mean` :57, `_load_channel` :71,
`_compress_channel_pair` :90, `create_training_shards` :103,
`save_mean_training` :176, `load_mean_training` :184), numpy on the host:

* test sets: RGB images -> (N, H, W, 3) uint8 with portrait images
  rotated to landscape, and the rotation flags;
* training sets: per image, YCbCr conversion, one random 320x320 crop of
  a channel (`width_target` None: the crops; 4 or 8: random (above, left,
  target) triplets from it), written as `thread_i/data_j.npz` shards.
  The numpy generator is called in the JAX package's order, so a seed
  writes the same shards;
* "pair" mode compresses each crop with the port's v1 wavefront encoder
  (`parallel/wavefront.encode_frame_wavefront`, block size 16, equal to
  the JAX package's) at a QP drawn from {32, 37, 42}, on `device`;
* the mean of a channel over the training images.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional, Sequence

import numpy as np

from ..utils import color, images
from . import extraction

WIDTH_CROP = 320
PAIR_QPS = (32, 37, 42)


def build_test_set(paths_to_images: Sequence[str], height: int, width: int):
    """Stacks RGB images into (N, height, width, 3), rotating portrait
    images.  Returns (array, rotation_flags), rotation_flags[i] True where
    image i was rotated by 90 degrees."""
    out = []
    rotated = []
    for path in paths_to_images:
        arr = images.read_image_mode(path, "RGB")
        if arr.shape[0] > arr.shape[1]:
            arr = np.rot90(arr)
            rotated.append(True)
        else:
            rotated.append(False)
        if arr.shape[0] < height or arr.shape[1] < width:
            raise ValueError(f"{path} is smaller than {height}x{width}")
        out.append(arr[:height, :width])
    return np.stack(out), np.array(rotated)


def compute_luminance_mean(paths_to_images: Sequence[str],
                           channel: int = 0) -> float:
    """Mean intensity of one YCbCr channel over a set of RGB images."""
    total, count = 0.0, 0
    for path in paths_to_images:
        ch = _load_channel(path, channel)
        if ch is None:
            continue
        total += float(ch.sum())
        count += ch.size
    if count == 0:
        raise ValueError("no usable images")
    return total / count


def _load_channel(path: str, channel: int):
    """One YCbCr channel of an RGB image, or the plane of a grayscale image
    when `channel` is luminance; None for unusable images (CMYK, or chroma
    asked of a grayscale image)."""
    try:
        rgb = images.read_image_mode(path, "RGB")
        return color.rgb_to_ycbcr(rgb)[:, :, channel]
    except ValueError:
        pass
    if channel != 0:
        return None
    try:
        return images.read_image_mode(path, "L")
    except ValueError:
        return None


def _compress_channel_pair(channel_uint8: np.ndarray, qp: int,
                           device="cuda") -> np.ndarray:
    """The channel with the v1 encoder's compression artifacts on its
    whole 16x16 blocks (the rest unchanged)."""
    from ..parallel import wavefront

    h, w = channel_uint8.shape
    h16, w16 = (h // 16) * 16, (w // 16) * 16
    res = wavefront.encode_frame_wavefront(channel_uint8[:h16, :w16], qp,
                                           serialize=False, device=device)
    out = channel_uint8.copy()
    out[:h16, :w16] = res.reconstruction
    return out


def create_training_shards(paths_to_images: Sequence[str],
                           path_to_directory: str,
                           *,
                           width_target: Optional[int] = None,
                           nb_shards: int = 4,
                           triplets_per_image: int = 10,
                           is_pair: bool = False,
                           channel: int = 0,
                           seed: int = 0,
                           images_per_file: int = 100,
                           device="cuda") -> int:
    """Writes sharded training data under <dir>/thread_i/data_j.npz and
    returns the number of examples written.

    `width_target` None: 320x320 channel crops ("crops"; the training
    pipeline extracts from them on the fly).  4 or 8: offline (above,
    left, target) triplets.  `device` runs the pair mode's encoder."""
    rng = np.random.default_rng(seed)
    n_written = 0
    shard_buffers: List[list] = [[] for _ in range(nb_shards)]
    shard_file_idx = [0] * nb_shards

    def flush(shard):
        nonlocal n_written
        if not shard_buffers[shard]:
            return
        d = os.path.join(path_to_directory, f"thread_{shard}")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"data_{shard_file_idx[shard]}.npz")
        if width_target is None:
            np.savez_compressed(path, crops=np.stack(shard_buffers[shard]))
        else:
            above = np.stack([b[0] for b in shard_buffers[shard]])
            left = np.stack([b[1] for b in shard_buffers[shard]])
            target = np.stack([b[2] for b in shard_buffers[shard]])
            np.savez_compressed(path, above=above, left=left, target=target)
        n_written += len(shard_buffers[shard])
        shard_buffers[shard] = []
        shard_file_idx[shard] += 1

    for i, path in enumerate(paths_to_images):
        ch = _load_channel(path, channel)
        if ch is None:
            continue
        if ch.shape[0] < WIDTH_CROP or ch.shape[1] < WIDTH_CROP:
            continue
        r = int(rng.integers(0, ch.shape[0] - WIDTH_CROP + 1))
        c = int(rng.integers(0, ch.shape[1] - WIDTH_CROP + 1))
        crop = ch[r:r + WIDTH_CROP, c:c + WIDTH_CROP]
        if is_pair:
            qp = int(rng.choice(PAIR_QPS))
            pair_plane = _compress_channel_pair(crop, qp, device)
            stacked = np.stack([crop, pair_plane], axis=-1)
        else:
            stacked = crop[..., None]
        shard = i % nb_shards
        if width_target is None:
            shard_buffers[shard].append(stacked)
        else:
            w = width_target
            hi = WIDTH_CROP - 3 * w
            rows = rng.integers(0, hi + 1, triplets_per_image)
            cols = rng.integers(0, hi + 1, triplets_per_image)
            for rr, cc in zip(rows, cols):
                shard_buffers[shard].append(
                    extraction.extract_context_portions_target_from_channel(
                        stacked, w, int(rr), int(cc)))
        if len(shard_buffers[shard]) >= images_per_file:
            flush(shard)
    for shard in range(nb_shards):
        flush(shard)
    return n_written


def save_mean_training(mean: float, path_to_directory: str) -> str:
    os.makedirs(path_to_directory, exist_ok=True)
    path = os.path.join(path_to_directory, "mean_training.pkl")
    with open(path, "wb") as f:
        pickle.dump(mean, f)
    return path


def load_mean_training(path: str) -> float:
    with open(path, "rb") as f:
        return float(pickle.load(f))
