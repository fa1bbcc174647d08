"""The port's CTB-64 encodes of the 128x128 natural crop against the JAX
package's digests (`tests/golden_torch/w2_ctb64.json`), with zero
tolerance: QP 32, rate evolution off, `regular`, `switch` and
`substitution` with the frozen singles zoo
(`artifacts/frozen/qpnn_w{4,8,16,32}_single.npz`, one mean), one frame a
call and a batch of two (the frame and its mirror); each batched frame
equals its own b = 1 encode.  The port runs on the CPU (plain trial,
plain merger).  `test_torch_wavefront2_ctb64.py` holds the smooth frame,
the tables and the live JAX comparison.
"""

import pytest
import torch

from test_torch_wavefront2_ctb64 import (ITEMS, POLICIES, RUNS, check_golden,
                                         port_encodes)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def port_natural():
    return port_encodes("natural128")


@pytest.mark.parametrize("item", ITEMS)
@pytest.mark.parametrize("nf,f", RUNS)
@pytest.mark.parametrize("policy", POLICIES)
def test_natural_encode_matches_jax_digests(port_natural, policy, nf, f,
                                            item):
    check_golden(port_natural, "natural128", policy, nf, f, item)


@pytest.mark.parametrize("f", [0, 1])
@pytest.mark.parametrize("policy", POLICIES)
def test_natural_batched_frame_equals_single(port_natural, policy, f):
    assert port_natural[policy][(2, f)] == port_natural[policy][("single",
                                                                 f)]
