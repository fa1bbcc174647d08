"""The port's quantize path (float PNNs -> frozen integer models -> the NN
policies) against the JAX package's.

The quantized weights and caps depend on the weights alone and must equal
the JAX package's; the scales, multipliers and biases follow the maxima of
a float32 forward whose roundings differ between XLA and PyTorch, so they
are held within a relative 1e-5 (biases within 1 + 1e-5 x |bias|).

* `calibration_contexts` equals the JAX package's, synthetic and from
  images, FC and conv.
* `quantize_pnn` against `tests/golden_torch/quantize.*`
  (`scripts/capture_torch_port_golden_v1.py --set quantize`) for the ten
  models of `artifacts/frozen/manifest_trained.txt` and the two FC
  singles (the two w64 models marked slow), and live against the JAX
  package's `quantize_pnn` at widths 4 and 8.
* `PnnBundle.quantize` of the JAX package's random conv bundle
  (`tests/test_wavefront_nn.py`, `n_samples=48`) against
  `w2_nn_random_bundle.npz`, the same bundle quantized by the JAX package.
* `_bq` raises on a bias beyond the int32 headroom.
* The bundle API: `load_codec_bundle`, `params_for_qp`,
  `is_fully_connected`, `quantize`; and a port-quantized bundle through a
  `switch` encode and the port's decoder.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax

from context_adaptive_neural_network_based_prediction_tpu.models import (
    pnn as j_pnn, pnn_q as j_pnn_q, zoo as j_zoo)
from context_adaptive_neural_network_based_prediction_tpu_torch.codec import (
    decoder as t_decoder, nn_intra as t_nn_intra)
from context_adaptive_neural_network_based_prediction_tpu_torch.evaluation \
    import quantize_golden
from context_adaptive_neural_network_based_prediction_tpu_torch.models import (
    pnn_q as t_pnn_q, zoo as t_zoo)
from context_adaptive_neural_network_based_prediction_tpu_torch.parallel import (
    wavefront2 as t_wavefront2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FROZEN = os.path.join(REPO, "artifacts", "frozen")
TRAINED = os.path.join(FROZEN, "manifest_trained.txt")
QUANTIZED = os.path.join(FROZEN, "manifest_quantized.txt")
MEAN_PKL = os.path.join(REPO, "artifacts", "training_set", "luminance",
                        "means", "mean_training.pkl")
RANDOM_BUNDLE = os.path.join(REPO, "tests", "golden_torch",
                             "w2_nn_random_bundle.npz")
REL_TOL = 1e-5
HEAVY = ("pnn_w64_single", "pnn_w64_pair")


def golden():
    return quantize_golden.load(REPO)


def mean_training():
    with open(MEAN_PKL, "rb") as f:
        return float(pickle.load(f))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def assert_close_models(got, want, rel_tol=REL_TOL):
    """Integer entries equal (biases within 1 + rel_tol |b|), float entries
    within rel_tol."""
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        if k == "kind":
            assert str(a) == str(b)
            continue
        assert (a.dtype, a.shape) == (b.dtype, b.shape), k
        leaf = k.rsplit("/", 1)[-1]
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=rel_tol, atol=0, err_msg=k)
        elif leaf.startswith(("b_", "t_b_")) or leaf == "b":
            diff = np.abs(a.astype(np.int64) - b)
            assert np.all(diff <= 1 + rel_tol * np.abs(b)), k
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("width", [4, 8, 16])
@pytest.mark.parametrize("is_fc", [False, True])
@pytest.mark.parametrize("with_images", [False, True])
def test_calibration_contexts_match_jax(width, is_fc, with_images):
    images = None
    if with_images:
        rng = np.random.default_rng(3)
        images = [rng.integers(0, 256, (64, 80)).astype(np.uint8),
                  rng.integers(0, 256, (72, 96)).astype(np.uint8)]
    got = t_pnn_q.calibration_contexts(width, is_fc, images=images,
                                       n_samples=40, seed=5)
    want = j_pnn_q.calibration_contexts(width, is_fc, images=images,
                                        n_samples=40, seed=5)
    for a, b in zip(got if not is_fc else [got], want if not is_fc
                    else [want]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [1, 80, 320, 1200, 2304, 10 ** 7])
def test_layer_budget_matches_jax(k):
    assert t_pnn_q._layer_budget(k) == j_pnn_q._layer_budget(k)
    act, w = t_pnn_q._layer_budget(k)
    assert act * w * k <= t_pnn_q.BUDGET


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=pytest.mark.slow) if n in HEAVY else n
    for n in sorted(quantize_golden.load(REPO)["meta"]["models"])])
def test_quantize_matches_golden(name):
    g = golden()
    q = quantize_golden.quantize(g, name, "cpu")
    rep = quantize_golden.compare(g, name, q, REL_TOL)
    assert rep["ints_equal"], rep["bad"]
    assert rep["keys_ok"], sorted(q)
    assert rep["max_rel"] <= REL_TOL, rep
    assert rep["biases_ok"], rep


@pytest.mark.parametrize("key", ["in_scale", "m_0"])
@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_compare_rejects_non_finite_floats(key, bad):
    """A scale or multiplier that is NaN or inf is never within tolerance,
    however small the other entries' errors."""
    g = golden()
    q = quantize_golden.quantize(g, "pnn_w4_fc_single", "cpu")
    assert quantize_golden.within(quantize_golden.compare(
        g, "pnn_w4_fc_single", q, REL_TOL), REL_TOL)
    vals = np.array(q[key], copy=True)
    vals.reshape(-1)[-1] = bad
    q[key] = vals
    rep = quantize_golden.compare(g, "pnn_w4_fc_single", q, REL_TOL)
    assert key in rep["bad"], rep
    assert not quantize_golden.within(rep, REL_TOL)


@pytest.mark.parametrize("name", ["pnn_w4_fc_single", "pnn_w8_fc_single",
                                  "pnn_w4_refconv_single",
                                  "pnn_w8_refconv_single"])
def test_quantize_matches_live_jax(name):
    path = os.path.join(FROZEN, name + ".npz")
    width = int(name.split("_")[1][1:])
    j_params, is_fc = j_zoo.load_frozen_params(path)
    t_params, t_is_fc = t_zoo.load_frozen_params(path)
    assert is_fc == t_is_fc
    calib = j_pnn_q.calibration_contexts(width, is_fc, n_samples=96, seed=2)
    want = j_pnn_q.quantize_pnn(j_params, calib, width, is_fc)
    got = t_pnn_q.quantize_pnn(t_params, calib, width, is_fc, device="cpu")
    assert_close_models(got, want)


def test_random_bundle_quantize_matches_jax_bundle():
    """The JAX package's random conv bundle, quantized by the port's
    `PnnBundle.quantize`, against the JAX package's quantization of it."""
    params = {8: j_pnn.init_params(jax.random.PRNGKey(1), 8, False),
              16: j_pnn.init_params(jax.random.PRNGKey(2), 16, False)}
    np_params = jax.tree_util.tree_map(np.asarray, params)
    bundle = t_nn_intra.PnnBundle(None, 117.9, params=np_params)
    assert bundle.is_fully_connected == {8: False, 16: False}
    assert bundle.quantized_for_qp(32) == {}
    got = bundle.quantize(n_samples=48, device="cpu")
    want = t_zoo.load_bundle_npz(RANDOM_BUNDLE)
    assert set(got.quantized) == set(want.quantized) == {8, 16}
    for w in (8, 16):
        assert_close_models(got.quantized[w], want.quantized[w])
    assert got.params is np_params and got.pair_quantized is None


def test_bq_raises_on_degenerate_scales():
    b = np.array([0.5, -2.0, 1.0], np.float32)
    np.testing.assert_array_equal(t_pnn_q._bq(b, np.float32(0.5)),
                                  j_pnn_q._bq(b, np.float32(0.5)))
    for mod in (t_pnn_q, j_pnn_q):
        with pytest.raises(ValueError, match="headroom"):
            mod._bq(b, np.float32(1e-10))


def test_wq_per_out_matches_jax():
    rng = np.random.default_rng(4)
    w = rng.normal(0, 0.3, (3, 3, 8, 16)).astype(np.float32)
    w[..., 5] = 0.0                      # a dead channel: the 1e-12 floor
    for axis in (0, 2, 3):
        got, want = t_pnn_q._wq_per_out(w, axis, 511), \
            j_pnn_q._wq_per_out(w, axis, 511)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_load_codec_bundle(tmp_path):
    mean = mean_training()
    b = t_zoo.load_codec_bundle(TRAINED, mean, QUANTIZED,
                                widths=(4, 8, 16, 32))
    assert set(b.params) == set(b.pair_params) == {4, 8, 16, 32}
    assert set(b.quantized) == set(b.pair_quantized) == {4, 8, 16, 32}
    # Float models first: w4 / w8 singles are refconv, their pairs FC.
    assert b.is_fully_connected == {4: False, 8: False, 16: False,
                                    32: False}
    assert "fully_connected" in b.params_for_qp(32)[4]
    assert "convolutional" in b.params_for_qp(31)[4]
    single = t_zoo.load_codec_bundle(TRAINED, mean, use_pair=False,
                                     widths=(16,))
    assert single.pair_params is None and single.quantized is None
    assert set(single.params) == {16}
    with pytest.raises(FileNotFoundError):
        t_zoo.load_codec_bundle(TRAINED, mean,
                                str(tmp_path / "missing.txt"))
    with pytest.raises(ValueError):
        t_nn_intra.PnnBundle(None, mean).quantize(device="cpu")


def test_pair_bundle_quantizes_each_architecture():
    """A width whose single is conv and whose pair is FC (w4 of the trained
    manifest) quantizes each model as its own architecture."""
    b = t_zoo.load_codec_bundle(TRAINED, mean_training(), widths=(4,))
    q = b.quantize(n_samples=16, device="cpu")
    assert str(q.quantized[4]["kind"]) == "conv"
    assert str(q.pair_quantized[4]["kind"]) == "fc"
    assert q.quantized_for_qp(37)[4] is q.pair_quantized[4]


def test_port_quantized_bundle_switch_encode_decodes():
    """Float singles -> the port's quantize -> a switch encode of the
    natural crop's top-left 64x64 -> the port's decoder gives the
    reconstruction back, and the PNN mode is coded."""
    frame = np.ascontiguousarray(np.load(os.path.join(
        REPO, "tests", "golden_hm", "128_full_q32_src.npy"))[:64, :64])
    b = t_zoo.load_codec_bundle(TRAINED, mean_training(), use_pair=False,
                                widths=(4, 8, 16, 32)).quantize(
        n_samples=64, device="cpu")
    assert set(b.quantized) == {4, 8, 16, 32}
    res = t_wavefront2.encode_frame_wavefront2(frame, 32, policy="switch",
                                               pnn=b, device="cpu")
    pnns, stack = 0, list(res.ctu_trees)
    while stack:
        node = stack.pop()
        stack.extend(node.children)
        pnns += sum(pu.mode == 35 for pu in node.pus)
    assert pnns > 0
    dec = t_decoder.decode_frame(res.bitstream, pnn=b, device="cpu")
    np.testing.assert_array_equal(dec.reconstruction, res.reconstruction)
