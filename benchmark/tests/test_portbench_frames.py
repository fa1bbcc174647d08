"""The seeded frame generator: the same frames for the same seed,
other frames for another, one size and range for all."""

import numpy as np

import portbench_toy  # noqa: F401  (the checkout root on sys.path)
from benchmark import frames


def test_same_seed_same_frames_other_seed_other_frames():
    a = frames.make_frames(2 ** 31 + 5, 3, 64, 96, "cpu")
    b = frames.make_frames(2 ** 31 + 5, 3, 64, 96, "cpu")
    c = frames.make_frames(2 ** 31 + 6, 3, 64, 96, "cpu")
    assert a.shape == (3, 64, 96) and a.dtype == np.uint8
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    # Frames of one seed differ from each other, and use the range.
    assert not np.array_equal(a[0], a[1])
    assert a.std() > 10 and a.min() < 60 and a.max() > 190


def test_chunks_do_not_change_the_frames():
    many = frames.make_frames(7, frames.CHUNK + 2, 32, 32, "cpu")
    assert many.shape == (frames.CHUNK + 2, 32, 32)
    assert len({f.tobytes() for f in many}) == len(many)
