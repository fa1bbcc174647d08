"""The port's host RDO encoder (`codec/encoder.py` `FrameEncoder`,
`encode_frame`, `serialize_trees`) against the JAX package's, live on the
CPU, with zero tolerance: stream, reconstruction, mode map and bit count.

* `regular` at QP 22 / 27 / 32 / 37 on a 64x64 crop of the natural frame
  `tests/golden_hm/128_full_q32_src.npy`, with the defaults (CTB 64, RDOQ,
  sign hiding, transform skip, deblocking, SAO, 8 full-RD candidates).
* `switch` (QP 22, 37) and `substitution` (QP 27, 32) with the whole
  quantized zoo of `artifacts/frozen/manifest_quantized.txt` (widths 4-64,
  singles and pairs; the pairs are selected at QP >= 32), the mean of
  `artifacts/training_set/luminance/means/mean_training.pkl` (these
  cases run in `test_torch_host_encoder_nn.py`).
* The options `tests/test_codec.py` varies, at QP 32 on a 64x64 crop of
  `96x160_full_q37_src.npy`: `ctu_size` 16 and 32, `sign_hiding=False`,
  `use_rdoq=False`, `transform_skip=False`, HM's candidate counts
  (`rd_candidates`), no loop filters, and a 56x72 frame (partial CTBs).
* The port's decoder (`codec/decoder.py`) gives each stream's
  reconstruction back; `serialize_trees` of both packages gives the same
  bytes on the same trees over its options; an encode asked for the card
  where there is none raises.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from context_adaptive_neural_network_based_prediction_tpu.codec import (
    encoder as j_encoder, nn_intra as j_nn_intra, sao as j_sao)
from context_adaptive_neural_network_based_prediction_tpu.models import (
    pnn_q as j_pnn_q)
from context_adaptive_neural_network_based_prediction_tpu_torch.codec import (
    decoder as t_decoder, encoder as t_encoder, nn_intra as t_nn_intra)
from context_adaptive_neural_network_based_prediction_tpu_torch.models import (
    zoo as t_zoo)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_HM = os.path.join(REPO, "tests", "golden_hm")
FROZEN = os.path.join(REPO, "artifacts", "frozen")
MEAN_PKL = os.path.join(REPO, "artifacts", "training_set", "luminance",
                        "means", "mean_training.pkl")
WIDTHS = (4, 8, 16, 32, 64)


def mean_training():
    with open(MEAN_PKL, "rb") as f:
        return float(pickle.load(f))


def natural64():
    return np.load(os.path.join(GOLDEN_HM, "128_full_q32_src.npy"))[:64, :64]


def wide64():
    return np.load(os.path.join(GOLDEN_HM,
                                "96x160_full_q37_src.npy"))[16:80, 48:112]


def port_zoo():
    """The quantized zoo, singles and pairs, through the port's loader."""
    return t_zoo.load_quantized_bundle(
        os.path.join(FROZEN, "manifest_quantized.txt"), mean_training())


def jax_zoo():
    """The same models as a JAX-package `PnnBundle` (read by file name:
    the manifest names absolute paths)."""
    single = {w: j_pnn_q.load_quantized(os.path.join(
        FROZEN, f"qpnn_w{w}_single.npz")) for w in WIDTHS}
    pair = {w: j_pnn_q.load_quantized(os.path.join(
        FROZEN, f"qpnn_w{w}_pair.npz")) for w in WIDTHS}
    return j_nn_intra.PnnBundle(
        {}, {w: str(q["kind"]) == "fc" for w, q in single.items()},
        mean_training(), quantized=single, pair_quantized=pair)


def assert_same_encode(got, want, what=""):
    assert got.bitstream == want.bitstream, what
    assert got.num_bits == want.num_bits, what
    np.testing.assert_array_equal(got.reconstruction, want.reconstruction,
                                  err_msg=f"{what} recon")
    np.testing.assert_array_equal(got.mode_map, want.mode_map,
                                  err_msg=f"{what} mode map")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def zoos():
    return {"port": port_zoo(), "jax": jax_zoo()}


def check_encode(zoos, policy, qp):
    frame = natural64()
    j_pnn = t_pnn = None
    if policy != "regular":
        j_pnn = j_nn_intra.PnnPredictor(zoos["jax"])
        t_pnn = t_nn_intra.PnnPredictor(zoos["port"], device="cpu")
    want = j_encoder.encode_frame(frame, qp, policy=policy, pnn=j_pnn)
    got = t_encoder.encode_frame(frame, qp, policy=policy, pnn=t_pnn,
                                 device="cpu")
    assert_same_encode(got, want, f"{policy} QP {qp}")
    if policy == "switch":
        assert (got.mode_map == t_encoder.PNNS_MODE).any()
    if policy != "regular":
        assert sum(t_pnn.forwards.values()) > 0
        assert sum(t_pnn.float_forwards.values()) == 0
    dec = t_decoder.decode_frame(got.bitstream, pnn=zoos["port"],
                                 device="cpu")
    np.testing.assert_array_equal(dec.reconstruction, got.reconstruction)


# The NN-policy cases are in `test_torch_host_encoder_nn.py`, so that they
# run beside this file.
@pytest.mark.parametrize("policy,qp", [("regular", 22), ("regular", 27),
                                       ("regular", 32), ("regular", 37)])
def test_encode_matches_jax(zoos, policy, qp):
    check_encode(zoos, policy, qp)


OPTIONS = {
    "ctu16": dict(ctu_size=16),
    "ctu32": dict(ctu_size=32),
    "no_sign_hiding": dict(sign_hiding=False),
    "no_rdoq": dict(use_rdoq=False, sign_hiding=False),
    "no_transform_skip": dict(transform_skip=False),
    "hm_candidates": dict(rd_candidates={16: 3, 32: 3, 64: 3}),
    "no_loop_filters": dict(deblocking=False, sao=False),
}


@pytest.mark.parametrize("name", sorted(OPTIONS) + ["partial_ctbs"])
def test_encode_options_match_jax(name):
    if name == "partial_ctbs":
        frame, kw = wide64()[:56, :72].copy(), {}
    else:
        frame, kw = wide64(), OPTIONS[name]
    want = j_encoder.encode_frame(frame, 32, **kw)
    got = t_encoder.encode_frame(frame, 32, device="cpu", **kw)
    assert_same_encode(got, want, name)
    dec = t_decoder.decode_frame(got.bitstream, device="cpu")
    np.testing.assert_array_equal(dec.reconstruction, got.reconstruction)


def test_serialize_trees_matches_jax():
    frame = natural64()
    fe = t_encoder.FrameEncoder(frame, 27, device="cpu")
    res = fe.encode()
    grid = fe._sao_grid
    j_grid = [[j_sao.SaoParams(p.mode, p.type_aux, p.offsets) for p in row]
              for row in grid]
    for policy in ("regular", "substitution", "switch"):
        for sh, depth, tskip, with_sao in ((True, 2, True, True),
                                           (False, 0, False, False),
                                           (True, 1, False, True)):
            kw = dict(width=64, height=64, qp=27, policy=policy, ctu_size=64,
                      sign_hiding=sh, deblocking=True, max_tu_depth=depth,
                      transform_skip=tskip)
            got = t_encoder.serialize_trees(
                res.ctu_trees, sao_grid=grid if with_sao else None, **kw)
            want = j_encoder.serialize_trees(
                res.ctu_trees, sao_grid=j_grid if with_sao else None, **kw)
            assert got == want, (policy, sh, depth, tskip, with_sao)
    assert t_encoder.serialize_trees(
        res.ctu_trees, width=64, height=64, qp=27, policy="regular",
        ctu_size=64, sign_hiding=True, deblocking=True, max_tu_depth=2,
        sao_grid=grid, transform_skip=True) == res.bitstream


def test_encoder_refuses_what_the_jax_package_refuses():
    frame = natural64()
    for kw in (dict(policy="bogus"), dict(policy="switch"),
               dict(use_rdoq=False)):
        with pytest.raises(ValueError):
            t_encoder.FrameEncoder(frame, 32, device="cpu", **kw)
    with pytest.raises(ValueError):
        t_encoder.FrameEncoder(frame[:60], 32, device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_encode_without_a_card_raises():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_encoder.encode_frame(natural64()[:16, :16], 32)


def test_port_encode_matches_card_goldens():
    """One case of `tests/golden_torch/host_codec.json` (the digests the
    card's smoke reads, captured from the JAX package) from the port on
    the CPU: the natural frame under `regular` at QP 37."""
    import hashlib
    import json

    from context_adaptive_neural_network_based_prediction_tpu_torch \
        .evaluation import host_cases

    def sha(a):
        if isinstance(a, bytes):
            return hashlib.sha256(a).hexdigest()
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    with open(host_cases.GOLDEN) as f:
        want = json.load(f)["encodes"]["natural128/regular/q37"]
    res = t_encoder.encode_frame(host_cases.load_frame("natural128"), 37,
                                 device="cpu")
    assert (sha(res.bitstream), sha(res.reconstruction),
            sha(res.mode_map.astype(np.int32))) == (
        want["stream"], want["recon"], want["mode_map"])
