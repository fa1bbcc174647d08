"""The port's `encode_frame_wavefront2_hm` of the natural 128x128 frame at
CTB 64 (`tests/golden_torch/w2_hm.json`: the three policies, loop filters
on and off) against the JAX package's digests; the slice serialiser of
both packages on its trees; stock HM on the regular streams; the JAX
package's `hm_decoder` on the NN streams.

Checks, fixtures and helpers come from `test_torch_hm_stream.py`; a file
of its own, so that these encodes run beside the other parts.
"""

import pytest

from test_torch_hm_stream import (check_digests,  # noqa: F401
                                  check_jax_hm_decoder,
                                  check_serialize_hm_slice, check_stock_hm,
                                  few_threads, hm_encodes, jax_bundles, keys)

PREFIX = "natural128/"
CTB = "/ctb64/"


@pytest.mark.parametrize("key", keys(PREFIX, lambda k: CTB in k))
def test_hm_stream_matches_jax_digests(hm_encodes, key):
    check_digests(hm_encodes, key)


@pytest.mark.parametrize("key", ['natural128/switch/ctb64/lf'])
def test_serialize_hm_slice_matches_jax(hm_encodes, key):
    check_serialize_hm_slice(hm_encodes, key)


@pytest.mark.parametrize("key", keys(PREFIX, lambda k: CTB in k
                                    and "/regular/" in k))
def test_stock_hm_decodes_port_regular_stream(hm_encodes, key, tmp_path):
    check_stock_hm(hm_encodes, key, tmp_path)


@pytest.mark.parametrize("key", keys(PREFIX, lambda k: CTB in k
                                    and "/regular/" not in k))
def test_jax_hm_decoder_reads_port_nn_stream(hm_encodes, jax_bundles, key):
    check_jax_hm_decoder(hm_encodes, jax_bundles, key)
