"""The reference's default zoo configuration through the port's NN encode
and decode, against the JAX package's live encode and decode.

The JAX package's zoo loader selects the pair models at QP >= 32 by
default (`use_pair=True`), and those are FC at widths 4 and 8
(`artifacts/frozen/qpnn_w{4,8}_pair.npz`); its scripts pass a mean per
width.  So this is the port's first encode of an FC quantized model, of a
pair selection and of a mean dict: the frozen quantized zoo at widths
4-32 with `use_pair=True`, and means {4, 8: 117.9, 16, 32: the repo's
training mean 86.8568}.  (The reference's own training mean of the
widths 4 and 8 is not in the repository; 117.9, the random test
bundle's, stands in for it and keeps the two means apart.)

Cases, on the 128x128 natural crop `tests/golden_hm/128_full_q32_src.npy`,
CTB 32, NxN on, rate evolution off: switch at QP 32 and substitution at
QP 37, one frame and a 2-frame batch (the crop and its left-right flip).
The JAX package's batched program on the CPU encodes both frames live;
the port's single-frame encode and each frame of its batch equal it item
by item (reconstruction, the 11 grids, stream), and the port's decoder
and the JAX decoder both turn the port's streams back into the encoder's
reconstruction, with equal mode maps.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from context_adaptive_neural_network_based_prediction_tpu.codec import (
    decoder as j_decoder, nn_intra as j_nn_intra)
from context_adaptive_neural_network_based_prediction_tpu.models import (
    pnn_q as j_pnn_q)
from context_adaptive_neural_network_based_prediction_tpu.parallel import (
    wavefront2 as j_wavefront2)
from context_adaptive_neural_network_based_prediction_tpu_torch.codec import (
    decoder as t_decoder)
from context_adaptive_neural_network_based_prediction_tpu_torch.models import (
    zoo as t_zoo)
from context_adaptive_neural_network_based_prediction_tpu_torch.parallel import (
    wavefront2 as t_wavefront2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FROZEN = os.path.join(REPO, "artifacts", "frozen")
MANIFEST = os.path.join(FROZEN, "manifest_quantized.txt")
MEAN_PKL = os.path.join(REPO, "artifacts", "training_set", "luminance",
                        "means", "mean_training.pkl")
GRIDS = ("m8", "q8", "s8", "m4", "q4", "m16", "q16", "s16", "m32", "q32",
         "s32")
CASES = {"switch": 32, "substitution": 37}


def means():
    with open(MEAN_PKL, "rb") as f:
        own = float(pickle.load(f))
    return {4: 117.9, 8: 117.9, 16: own, 32: own}


def frames():
    f = np.load(os.path.join(REPO, "tests", "golden_hm",
                             "128_full_q32_src.npy"))
    return np.stack([f, np.ascontiguousarray(f[:, ::-1])])


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def port_bundle():
    return t_zoo.load_quantized_bundle(MANIFEST, means(), use_pair=True,
                                       widths=(4, 8, 16, 32))


@pytest.fixture(scope="module")
def jax_bundle():
    def load(kind):
        return {w: j_pnn_q.load_quantized(os.path.join(
            FROZEN, f"qpnn_w{w}_{kind}.npz")) for w in (4, 8, 16, 32)}
    single, pair = load("single"), load("pair")
    return j_nn_intra.PnnBundle(
        {}, {w: str(q["kind"]) == "fc" for w, q in single.items()}, means(),
        quantized=single, pair_quantized=pair)


def frame_ys(ys, f, n_frames=2):
    """Frame f's decisions of a batched JAX run: the (slot, frame) axis at
    -3 for the level arrays, -1 for the others (the JAX package's
    `encode_frames_wavefront2_batch` extraction)."""
    out = {}
    for k, v in ys.items():
        axis = -3 if k.startswith("q") else -1
        out[k] = np.take(v, np.arange(v.shape[axis] // n_frames) * n_frames
                         + f, axis=axis)
    return out


@pytest.fixture(scope="module")
def encodes(port_bundle, jax_bundle):
    """{policy: (jax results, port single-frame items, port batch items)};
    items are (recon, grids, stream)."""
    out = {}
    fr = frames()
    for policy, qp in CASES.items():
        j_wavefront2._W2_CACHE.clear()
        run = j_wavefront2._jitted_wavefront2(
            128, 128, qp, policy=policy, bundle=jax_bundle, ctb=32,
            enable_nxn=True, n_frames=2, rate_evolve=False)
        recon, ys = run(fr)
        recon = np.asarray(recon)
        ys = {k: np.asarray(v) for k, v in ys.items()}
        want = []
        for f in range(2):
            g = j_wavefront2._assemble_arrays(frame_ys(ys, f), 128, 128, 32)
            res = j_wavefront2._arrays_to_result(
                fr[f], qp, (recon[f],) + g, policy, True)
            want.append((recon[f], g, res.bitstream))
        j_wavefront2._W2_CACHE.clear()

        def port_items(frame, recon, grids):
            res = t_wavefront2._arrays_to_result(frame, qp, (recon,) + grids,
                                                 policy, True)
            return recon, grids, res.bitstream

        single = port_items(fr[0], *t_wavefront2.encode_arrays_wavefront2(
            fr[0], qp, policy=policy, pnn=port_bundle, device="cpu"))
        batch = [port_items(fr[f], *rg) for f, rg in enumerate(
            t_wavefront2.encode_arrays_wavefront2_batch(
                fr, qp, policy=policy, pnn=port_bundle, device="cpu"))]
        out[policy] = (want, single, batch)
    return out


def assert_items_equal(got, want, what):
    np.testing.assert_array_equal(got[0], want[0], err_msg=f"{what} recon")
    for name, a, b in zip(GRIDS, got[1], want[1]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"{what} {name}")
    assert got[2] == want[2], f"{what} stream"


@pytest.mark.parametrize("policy", list(CASES))
@pytest.mark.parametrize("case", ["b1", "b2_frame0", "b2_frame1"])
def test_pair_zoo_encode_matches_jax(encodes, policy, case):
    want, single, batch = encodes[policy]
    got = {"b1": single, "b2_frame0": batch[0], "b2_frame1": batch[1]}[case]
    assert_items_equal(got, want[0 if case != "b2_frame1" else 1],
                       f"{policy} {case}")


@pytest.mark.parametrize("policy", list(CASES))
@pytest.mark.parametrize("frame", [0, 1])
def test_pair_zoo_streams_decode(encodes, port_bundle, jax_bundle, policy,
                                 frame):
    _, _, batch = encodes[policy]
    recon, _, stream = batch[frame]
    dec = t_decoder.FrameDecoder(stream, pnn=port_bundle, device="cpu")
    got = dec.decode()
    want = j_decoder.decode_frame(stream,
                                  pnn=j_nn_intra.PnnPredictor(jax_bundle))
    np.testing.assert_array_equal(got.reconstruction, recon)
    np.testing.assert_array_equal(np.asarray(want.reconstruction), recon)
    np.testing.assert_array_equal(got.mode_map, want.mode_map)


def test_pair_selection_runs_fc_models(encodes, port_bundle):
    """At QP >= 32 the widths 4 and 8 are the FC pair models, and the
    switch stream's decode runs some of their forwards (PNNS PUs of those
    widths)."""
    q = port_bundle.quantized_for_qp(32)
    assert [str(q[w]["kind"]) for w in (4, 8, 16, 32)] == [
        "fc", "fc", "conv", "conv"]
    assert port_bundle.mean_for(4) != port_bundle.mean_for(16)
    _, _, batch = encodes["switch"]
    forwards = {"fc": 0, "conv": 0}
    for _, _, stream in batch:
        dec = t_decoder.FrameDecoder(stream, pnn=port_bundle, device="cpu")
        res = dec.decode()
        assert (res.mode_map == 35).any()
        for k in forwards:
            forwards[k] += dec.pnn.forwards[k]
    assert forwards["fc"] > 0, forwards
