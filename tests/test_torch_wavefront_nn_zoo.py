"""The port's NN-policy encodes with the frozen PNN zoo against the JAX
package's, with zero tolerance.

The 128x128 natural crop `tests/golden_hm/128_full_q32_src.npy`, CTB 32,
NxN on, one frame, rate evolution off, policies `switch` and
`substitution`, with the frozen singles zoo
(`artifacts/frozen/qpnn_w{4,8,16,32}_single.npz`, no pair models, the
mean 86.8568 of `artifacts/training_set/luminance/means/mean_training.pkl`
for every width), at the QP of (32, 37) at which the JAX encode codes a PU
with the PNN mode (`tests/golden_torch/w2_nn.json` records it).  The port
reads the zoo through its own loader; the JAX package gets the same
models as a `PnnBundle`.  Reconstruction, grids and stream are equal, the
JAX decoder reproduces the port's reconstruction from the port's stream,
and the JAX encodes equal the digests the card's tests read.  Helpers come
from `test_torch_wavefront_nn.py`.
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
from context_adaptive_neural_network_based_prediction_tpu_torch.models import (
    zoo as t_zoo)

from test_torch_wavefront_nn import (
    GRIDS, ITEMS, REPO, assert_item_equal, golden, jax_live_encode,
    port_encode, sha)

MANIFEST = os.path.join(REPO, "artifacts", "frozen", "manifest_quantized.txt")
MEAN_PKL = os.path.join(REPO, "artifacts", "training_set", "luminance",
                        "means", "mean_training.pkl")
KEYS = ("natural128/switch/live", "natural128/substitution/live")


def mean_training():
    with open(MEAN_PKL, "rb") as f:
        return float(pickle.load(f))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jax_bundle():
    quantized = {w: j_pnn_q.load_quantized(os.path.join(
        REPO, "artifacts", "frozen", f"qpnn_w{w}_single.npz"))
        for w in (4, 8, 16, 32)}
    return j_nn_intra.PnnBundle(
        {}, {w: str(q["kind"]) == "fc" for w, q in quantized.items()},
        mean_training(), quantized=quantized)


@pytest.fixture(scope="module")
def port_bundle():
    return t_zoo.load_quantized_bundle(MANIFEST, mean_training(),
                                       use_pair=False, widths=(4, 8, 16, 32))


@pytest.fixture(scope="module")
def jax_live(jax_bundle):
    return {key: jax_live_encode(key, jax_bundle) for key in KEYS}


@pytest.fixture(scope="module")
def port_runs(port_bundle):
    return {key: port_encode(key, port_bundle) for key in KEYS}


@pytest.mark.parametrize("item", ITEMS)
@pytest.mark.parametrize("key", KEYS)
def test_zoo_encode_matches_jax(jax_live, port_runs, key, item):
    assert_item_equal(port_runs[key][item], jax_live[key][item],
                      f"{key} {item}")


@pytest.mark.parametrize("key", KEYS)
def test_jax_decoder_reads_port_zoo_stream(jax_bundle, port_runs, key):
    dec = j_decoder.decode_frame(port_runs[key]["stream"],
                                 pnn=j_nn_intra.PnnPredictor(jax_bundle))
    np.testing.assert_array_equal(np.asarray(dec.reconstruction),
                                  port_runs[key]["recon"])


@pytest.mark.parametrize("key", KEYS)
def test_natural_frame_codes_pnn_pus(jax_live, port_runs, key):
    """The frozen zoo's PNN wins somewhere on the natural crop, so the PNN
    path decides part of the compared stream."""
    assert golden()["encodes"][key]["qp"] in (32, 37)
    assert jax_live[key]["pnn_pus"] > 0
    assert port_runs[key]["pnn_pus"] == jax_live[key]["pnn_pus"]


@pytest.mark.parametrize("key", KEYS)
def test_zoo_card_digests_match_live_jax(jax_live, key):
    want = golden()["encodes"][key]
    got = {k: sha(np.asarray(v, np.int32)) if k in GRIDS else sha(v)
           for k, v in jax_live[key].items() if k in ITEMS}
    assert got == {k: want[k] for k in ITEMS}
    assert jax_live[key]["pnn_pus"] == want["pnn_pus"]


def test_zoo_loader_resolves_by_file_name(tmp_path):
    """A manifest naming another machine's paths is read from its own
    directory; a missing file raises; use_pair and widths filter."""
    with open(MANIFEST) as f:
        lines = f.read().splitlines()
    bundle = t_zoo.load_quantized_bundle(MANIFEST, 1.0)
    assert set(bundle.quantized) == {4, 8, 16, 32, 64}
    assert set(bundle.pair_quantized) == {4, 8, 16, 32, 64}
    assert bundle.quantized_for_qp(32)[4]["kind"] == "fc"
    assert bundle.quantized_for_qp(31)[4]["kind"] == "conv"
    assert bundle.is_fully_connected == {4: False, 8: False, 16: False,
                                         32: False, 64: False}
    moved = tmp_path / "manifest.txt"
    moved.write_text("\n".join(lines) + "\n")
    with pytest.raises(FileNotFoundError):
        t_zoo.load_quantized_bundle(str(moved), 1.0, use_pair=False)
