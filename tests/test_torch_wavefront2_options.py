"""The port's encode options beside the defaults, against the JAX package.

`encode_arrays_wavefront2` takes `enable_nxn` (the 4x4 NxN PUs of 8x8
CUs) and `lam_scale` (a factor on the QP's lambda); the other tests run
only their defaults.  Here each is held against the JAX package's
`_jitted_wavefront2` with the same option: regular policy, QP 32, CTB 32,
rate evolution off, one frame, on the synthetic 64x96 frame of
`tests/test_torch_wavefront2.py`.  The port runs on the CPU (plain trial).
The reconstruction, each of the 11 grids of `_assemble_arrays` and the
stream bytes must be equal, each item its own case.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from context_adaptive_neural_network_based_prediction_tpu.parallel import (
    wavefront2 as j_wavefront2)
from context_adaptive_neural_network_based_prediction_tpu_torch.parallel import (
    wavefront2 as t_wavefront2)

from test_torch_wavefront2 import ITEMS, QP, as_items, assert_item_equal, frames

OPTIONS = {"no_nxn": dict(enable_nxn=False), "lam_scale_0.7":
           dict(lam_scale=0.7)}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def port_encode(frame, opts):
    recon, grids = t_wavefront2.encode_arrays_wavefront2(
        frame, QP, rate_evolve=False, device="cpu", **opts)
    res = t_wavefront2._arrays_to_result(frame, QP, (recon,) + grids,
                                         "regular", True)
    return as_items(recon, grids, res.bitstream)


def jax_encode(frame, opts):
    h, w = frame.shape
    j_wavefront2._W2_CACHE.clear()   # the fused impl is not in its key
    run = j_wavefront2._jitted_wavefront2(
        h, w, QP, lam_scale=opts.get("lam_scale", 1.0), ctb=32,
        enable_nxn=opts.get("enable_nxn", True), rate_evolve=False)
    recon, ys = run(jnp.asarray(frame))
    recon = np.asarray(recon)
    grids = j_wavefront2._assemble_arrays(ys, h, w, 32)
    res = j_wavefront2._arrays_to_result(frame, QP, (recon,) + grids,
                                         "regular", True)
    j_wavefront2._W2_CACHE.clear()
    return as_items(recon, grids, res.bitstream)


@pytest.fixture(scope="module")
def encodes():
    frame = frames()["synth64x96"]
    return {name: (port_encode(frame, opts), jax_encode(frame, opts))
            for name, opts in OPTIONS.items()}


@pytest.mark.parametrize("item", ITEMS)
@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_matches_jax(encodes, option, item):
    got, want = encodes[option]
    assert_item_equal(got[item], want[item], f"{option} {item}")


def test_options_change_the_encode(encodes):
    """Neither option is inert: each stream differs from the default
    encode's, and without NxN no 8x8 CU is split."""
    frame = frames()["synth64x96"]
    default = port_encode(frame, {})
    for option, (got, _) in encodes.items():
        assert got["stream"] != default["stream"], option
    assert not np.asarray(encodes["no_nxn"][0]["s8"]).any()
