"""The NN-policy cases of `test_torch_host_encoder.py`: the port's host
RDO encoder against the JAX package's, live on the CPU, with zero
tolerance, under `switch` (QP 22, 37) and `substitution` (QP 27, 32) with
the whole quantized zoo (w4-w64, singles and pairs), each stream decoded
back by the port's decoder.  A file of its own, so that it runs beside
the regular half; helpers and fixtures come from that file.
"""

import pytest

from test_torch_host_encoder import check_encode, few_threads, zoos  # noqa: F401


@pytest.mark.parametrize("policy,qp", [("switch", 22), ("switch", 37),
                                       ("substitution", 27),
                                       ("substitution", 32)])
def test_encode_matches_jax(zoos, policy, qp):
    check_encode(zoos, policy, qp)
