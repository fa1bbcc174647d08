"""Training input pipeline: sharded files -> shuffled uint8 batches.

The port of the JAX package's `data/pipeline.py` (`TrainingPipeline`
:27-98), numpy on the host, so the same seed gives the same batches:
shard files are read round-robin in a shuffled order, examples land in a
shuffle buffer (at least `shuffle_buffer` examples before each draw), and
batches are yielded as uint8 numpy arrays; `models/training.py` does the
float work on the device.  Small datasets are decompressed into RAM once.

For target widths >= 16 (`is_extraction_on_the_fly`) the triplets are
extracted from 320x320 crops with a random rot90, left-right flip and
position.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from ..utils import paths as path_utils
from . import extraction


class TrainingPipeline:
    def __init__(self, path_to_directory_shards: str, batch_size: int,
                 width_target: int, *, is_extraction_on_the_fly: bool = False,
                 shuffle_buffer: int = 1000, seed: int = 0,
                 ram_cache_bytes: int = 1 << 29):
        self.files = path_utils.collect_paths_to_files_in_subdirectories(
            path_to_directory_shards, ".npz")
        if not self.files:
            raise ValueError(
                f"no .npz shards under {path_to_directory_shards}")
        self.batch_size = batch_size
        self.w = width_target
        self.on_the_fly = is_extraction_on_the_fly
        self.shuffle_buffer = shuffle_buffer
        self.rng = np.random.default_rng(seed)
        # Decompressing an .npz on every pass would dominate the host's
        # batch production; small datasets are decompressed once.
        self._ram_cache = None
        total_bytes = sum(os.path.getsize(p) for p in self.files)
        if total_bytes <= ram_cache_bytes:
            self._ram_cache = [dict(np.load(p)) for p in self.files]

    def _load(self, index: int) -> dict:
        if self._ram_cache is not None:
            return self._ram_cache[index]
        return dict(np.load(self.files[index]))

    def _example_stream(self) -> Iterator[tuple]:
        file_order = list(range(len(self.files)))
        while True:
            self.rng.shuffle(file_order)
            for index in file_order:
                data = self._load(index)
                if self.on_the_fly:
                    crops = data["crops"]
                    for i in range(crops.shape[0]):
                        yield self._extract_random(crops[i])
                else:
                    above, left, target = (data["above"], data["left"],
                                           data["target"])
                    for i in range(above.shape[0]):
                        yield above[i], left[i], target[i]

    def _extract_random(self, crop: np.ndarray):
        """Random rot90 k, left-right flip and position, on views; the
        batch's np.stack copies the small portions, never the crop."""
        k = int(self.rng.integers(0, 4))
        chan = np.rot90(crop, k)
        if self.rng.integers(0, 2):
            chan = chan[:, ::-1]
        h, w_ch = chan.shape[:2]
        w = self.w
        r = int(self.rng.integers(0, h - 3 * w + 1))
        c = int(self.rng.integers(0, w_ch - 3 * w + 1))
        return extraction.extract_context_portions_target_from_channel(
            chan, w, r, c)

    def batches(self) -> Iterator[tuple]:
        """Yields (above (B, w, 3w, 1), left (B, 2w, w, 1), target
        (B, w, w, 1)) uint8."""
        buf = []
        stream = self._example_stream()
        while True:
            while len(buf) < max(self.shuffle_buffer, self.batch_size):
                buf.append(next(stream))
            idx = self.rng.choice(len(buf), self.batch_size, replace=False)
            chosen = [buf[i] for i in idx]
            for i in sorted(idx, reverse=True):
                buf.pop(i)
            above = np.stack([c[0] for c in chosen])
            left = np.stack([c[1] for c in chosen])
            target = np.stack([c[2] for c in chosen])
            yield above, left, target
