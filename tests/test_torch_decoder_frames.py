"""Whole decodes of the port's decoder against the JAX package's, with
zero tolerance (on the CPU): the port's regular, switch and substitution
streams of the 128x128 natural crop at QP 32 (frozen singles zoo, which
codes PNN PUs there), single-frame and from a 2-frame batch, decode to
the encoder's reconstruction and to the JAX decoder's reconstruction and
mode map.  A header with deblocking or SAO set decodes as the JAX decoder
decodes it (`test_torch_loop_filters.py` holds the loop filters).  The
pieces of the decoder are held in `test_torch_decoder.py`, whose helpers
this file uses; a file of its own, so that it runs beside that one.
"""

import os
import struct

import numpy as np
import pytest

from context_adaptive_neural_network_based_prediction_tpu.codec import (
    decoder as j_decoder, nn_intra as j_nn_intra)
from context_adaptive_neural_network_based_prediction_tpu.models import (
    pnn_q as j_pnn_q)
from context_adaptive_neural_network_based_prediction_tpu_torch.codec import (
    decoder as t_decoder, encoder as t_encoder)
from context_adaptive_neural_network_based_prediction_tpu_torch.models import (
    zoo as t_zoo)
from context_adaptive_neural_network_based_prediction_tpu_torch.parallel import (
    wavefront2 as t_wavefront2)

from test_torch_decoder import (FROZEN, MANIFEST, QP, REPO,  # noqa: F401
                                few_threads, mean_training)


# ------------------------------------------------------- whole frames ----

@pytest.fixture(scope="module")
def bundles():
    quantized = {w: j_pnn_q.load_quantized(os.path.join(
        FROZEN, f"qpnn_w{w}_single.npz")) for w in (4, 8, 16, 32)}
    j_bundle = j_nn_intra.PnnBundle(
        {}, {w: str(q["kind"]) == "fc" for w, q in quantized.items()},
        mean_training(), quantized=quantized)
    t_bundle = t_zoo.load_quantized_bundle(MANIFEST, mean_training(),
                                           use_pair=False,
                                           widths=(4, 8, 16, 32))
    return j_bundle, t_bundle


def natural():
    return np.load(os.path.join(REPO, "tests", "golden_hm",
                                "128_full_q32_src.npy"))


@pytest.fixture(scope="module")
def streams(bundles):
    """{case: EncodeResult} of the port's encodes on the CPU: each policy
    single-frame, and frame 1 of a 2-frame batch (natural, natural flipped
    left-right) under substitution and regular."""
    _, t_bundle = bundles
    f = natural()
    out = {}
    for policy in ("regular", "switch", "substitution"):
        out[policy] = t_wavefront2.encode_frame_wavefront2(
            f, QP, policy=policy,
            pnn=t_bundle if policy != "regular" else None, device="cpu")
    pair = np.stack([f, np.ascontiguousarray(f[:, ::-1])])
    for policy in ("regular", "substitution"):
        out[policy + "_batch"] = t_wavefront2.encode_frames_wavefront2_batch(
            pair, QP, policy=policy,
            pnn=t_bundle if policy != "regular" else None, serialize=True,
            device="cpu")[1]
    return out


CASES = ("regular", "switch", "substitution", "regular_batch",
         "substitution_batch")


@pytest.mark.parametrize("case", CASES)
def test_decode_frame_matches_encoder_and_jax_decoder(bundles, streams,
                                                      case):
    j_bundle, t_bundle = bundles
    res = streams[case]
    nn = not case.startswith("regular")
    got = t_decoder.decode_frame(res.bitstream, pnn=t_bundle if nn else None,
                                 device="cpu")
    want = j_decoder.decode_frame(
        res.bitstream, pnn=j_nn_intra.PnnPredictor(j_bundle) if nn else None)
    np.testing.assert_array_equal(got.reconstruction, res.reconstruction)
    np.testing.assert_array_equal(got.reconstruction,
                                  np.asarray(want.reconstruction))
    np.testing.assert_array_equal(got.mode_map, want.mode_map)
    assert (got.qp, got.policy) == (want.qp, want.policy)
    if res.mode_map is not None:
        np.testing.assert_array_equal(got.mode_map, res.mode_map)


@pytest.mark.parametrize("case", ["switch", "substitution",
                                  "substitution_batch"])
def test_decoded_nn_streams_code_pnn_pus(bundles, streams, case):
    """The PNN decides PUs of these streams, and the decoder runs one
    conv forward per PNN-coded PU with an available context (the frozen
    singles are all conv)."""
    _, t_bundle = bundles
    dec = t_decoder.FrameDecoder(streams[case].bitstream, pnn=t_bundle,
                                 device="cpu")
    res = dec.decode()
    mode = 35 if case == "switch" else 18
    assert (res.mode_map == mode).any()
    assert dec.pnn.forwards["fc"] == 0 and dec.pnn.forwards["conv"] > 0


@pytest.mark.parametrize("flag", ["deblocking", "has_sao"])
def test_loop_filter_headers_raise(streams, flag):
    """A header with deblocking or SAO on no longer raises: the decoder
    runs the loop filter as the JAX decoder does (SAO parameters read
    after the last CU, deblocking on the TU map), on the same bytes."""
    payload = streams["regular"].bitstream[struct.calcsize("<4sBBBBBBBBBII"):]
    header = t_encoder.stream_header(width=128, height=128, qp=QP,
                                     policy="regular", ctu_size=32,
                                     sign_hiding=True, **{flag: True})
    got = t_decoder.decode_frame(header + payload, device="cpu")
    want = j_decoder.decode_frame(header + payload)
    np.testing.assert_array_equal(got.reconstruction,
                                  np.asarray(want.reconstruction))
    np.testing.assert_array_equal(got.mode_map, want.mode_map)
    if flag == "deblocking":
        assert not np.array_equal(got.reconstruction,
                                  streams["regular"].reconstruction)


def test_nn_stream_needs_a_predictor(streams):
    with pytest.raises(ValueError):
        t_decoder.decode_frame(streams["switch"].bitstream, device="cpu")
