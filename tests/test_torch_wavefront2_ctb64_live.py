"""The JAX package's default CPU encode (jitted, rate evolution off) of
the smooth 64x128 frame at CTB 64 under switch with the random bundle,
live against the port's (`test_torch_wavefront2_ctb64.py` holds the
digests, tables and refused configurations, and its helpers serve here);
a file of its own, so that it runs beside that one.
"""

import numpy as np

import jax.numpy as jnp

from context_adaptive_neural_network_based_prediction_tpu.parallel import (
    wavefront2 as j_wavefront2)
from context_adaptive_neural_network_based_prediction_tpu_torch.parallel import (
    wavefront2 as t_wavefront2)

from test_torch_wavefront2_ctb64 import (GRIDS, few_threads,  # noqa: F401
                                         frames, golden, port_bundle, sha)
from test_torch_wavefront_nn import jax_random_bundle


def test_live_jax_switch_encode():
    """The JAX package's default CPU encode (jitted, rate evolution off)
    of the smooth frame under switch with the random bundle, live."""
    e = golden()["encodes"]["smooth64x128/switch/b1/0"]
    frame = frames()["smooth64x128"]
    j_bundle = jax_random_bundle()
    h, w = frame.shape
    j_wavefront2._W2_CACHE.clear()
    run = j_wavefront2._jitted_wavefront2(h, w, e["qp"], policy="switch",
                                          bundle=j_bundle, ctb=64,
                                          enable_nxn=True, rate_evolve=False)
    recon, ys = run(jnp.asarray(frame))
    j_wavefront2._W2_CACHE.clear()
    j_grids = j_wavefront2._assemble_arrays(ys, h, w, 64)
    j_res = j_wavefront2._arrays_to_result(frame, e["qp"],
                                           (np.asarray(recon),) + j_grids,
                                           "switch", True, ctb=64)
    t_recon, t_grids = t_wavefront2.encode_arrays_wavefront2(
        frame, e["qp"], policy="switch",
        pnn=port_bundle("random"), ctb=64, device="cpu")
    t_res = t_wavefront2._arrays_to_result(frame, e["qp"],
                                           (t_recon,) + t_grids, "switch",
                                           True, ctb=64)
    np.testing.assert_array_equal(t_recon, np.asarray(recon))
    for name, a, b in zip(GRIDS, t_grids, j_grids):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    assert t_res.bitstream == j_res.bitstream
    np.testing.assert_array_equal(t_res.mode_map, j_res.mode_map)
    assert sha(t_res.bitstream) == e["stream"]
