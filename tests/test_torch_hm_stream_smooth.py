"""The port's `encode_frame_wavefront2_hm` of the smooth 64x128 frame at
CTB 64 (`tests/golden_torch/w2_hm.json`: the three policies with the
random bundle, loop filters on) against the JAX package's digests; the
slice serialiser of both packages on the regular trees; stock HM on the
regular stream.

Checks, fixtures and helpers come from `test_torch_hm_stream.py`; a file
of its own, so that these encodes run beside the other parts.
"""

import pytest

from test_torch_hm_stream import (check_digests,  # noqa: F401
                                  check_serialize_hm_slice, check_stock_hm,
                                  few_threads, hm_encodes, keys)

PREFIX = "smooth64x128/"


@pytest.mark.parametrize("key", keys(PREFIX))
def test_hm_stream_matches_jax_digests(hm_encodes, key):
    check_digests(hm_encodes, key)


@pytest.mark.parametrize("key", ['smooth64x128/regular/ctb64/lf'])
def test_serialize_hm_slice_matches_jax(hm_encodes, key):
    check_serialize_hm_slice(hm_encodes, key)


@pytest.mark.parametrize("key", keys(PREFIX, lambda k: "/regular/" in k))
def test_stock_hm_decodes_port_regular_stream(hm_encodes, key, tmp_path):
    check_stock_hm(hm_encodes, key, tmp_path)
