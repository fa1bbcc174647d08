"""The port's decoder against the JAX package's, with zero tolerance.

Each piece the port's `codec/decoder.py` reads with is held against its
JAX counterpart on seeded inputs: the CABAC decoding engine reads back
the JAX package's `CabacEncoder` bins (context-coded, bypass, terminate),
`decode_coefficients` reads back `encode_coefficients` at n = 4-32 in
every scan with sign hiding on and off, the intra mode syntax and MPM
rules, the reference-sample availability, fill filter and per-mode
choice, the one-mode prediction, dequantisation and inverse transforms,
and the PNN predictor on all ten `artifacts/frozen/qpnn_*.npz`.  The
whole decodes are in `test_torch_decoder_frames.py`.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from context_adaptive_neural_network_based_prediction_tpu.codec import (
    cabac as j_cabac, contexts as j_contexts, encoder as j_encoder,
    nn_intra as j_nn_intra, syntax as j_syntax)
from context_adaptive_neural_network_based_prediction_tpu.models import (
    pnn_q as j_pnn_q)
from context_adaptive_neural_network_based_prediction_tpu.ops import (
    intra as j_intra, reference_samples as j_rs, transform as j_transform)
from context_adaptive_neural_network_based_prediction_tpu_torch.codec import (
    cabac as t_cabac, contexts as t_contexts, encoder as t_encoder,
    nn_intra as t_nn_intra, scans as t_scans, syntax as t_syntax)
from context_adaptive_neural_network_based_prediction_tpu_torch.models import (
    pnn_q as t_pnn_q)
from context_adaptive_neural_network_based_prediction_tpu_torch.ops import (
    intra as t_intra, reference_samples as t_rs, transform as t_transform)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FROZEN = os.path.join(REPO, "artifacts", "frozen")
MANIFEST = os.path.join(FROZEN, "manifest_quantized.txt")
MEAN_PKL = os.path.join(REPO, "artifacts", "training_set", "luminance",
                        "means", "mean_training.pkl")
QP = 32


def mean_training():
    with open(MEAN_PKL, "rb") as f:
        return float(pickle.load(f))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ------------------------------------------------------------- CABAC ----

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cabac_decoder_reads_jax_encoder_bins(seed):
    """A seeded mix of context-coded bins (skewed and even sources over
    six contexts), single and grouped bypass bins and terminate bins."""
    rng = np.random.default_rng(seed)
    init = [107, 139, 126, 154, 63, 200]
    enc_ctx = j_cabac.init_contexts(QP, init)
    dec_ctx = t_cabac.init_contexts(QP, init)
    ops = []
    enc = j_cabac.CabacEncoder()
    for _ in range(3000):
        kind = rng.integers(0, 10)
        if kind < 6:
            c = int(rng.integers(0, 6))
            b = int(rng.random() < (0.1 if c < 3 else 0.5))
            enc.encode_bin(b, enc_ctx, c)
            ops.append(("ctx", c, b))
        elif kind < 8:
            b = int(rng.integers(0, 2))
            enc.encode_bin_ep(b)
            ops.append(("ep", None, b))
        elif kind < 9:
            k = int(rng.integers(1, 17))
            v = int(rng.integers(0, 1 << k))
            enc.encode_bins_ep(v, k)
            ops.append(("eps", k, v))
        else:
            enc.encode_bin_trm(0)
            ops.append(("trm", None, 0))
    data = enc.terminate_and_finish()
    dec = t_cabac.CabacDecoder(data)
    for kind, arg, want in ops:
        if kind == "ctx":
            got = dec.decode_bin(dec_ctx, arg)
        elif kind == "ep":
            got = dec.decode_bin_ep()
        elif kind == "eps":
            got = dec.decode_bins_ep(arg)
        else:
            got = dec.decode_bin_trm()
        assert got == want
    assert dec.decode_bin_trm() == 1
    np.testing.assert_array_equal(np.asarray(dec_ctx), enc_ctx)


def test_cabac_decoder_takes_a_list_of_states():
    enc_ctx = j_contexts.make_context_states(QP)
    enc = j_cabac.CabacEncoder()
    bins = np.random.default_rng(4).integers(0, 2, 400).tolist()
    for i, b in enumerate(bins):
        enc.encode_bin(b, enc_ctx, i % 7)
    data = enc.terminate_and_finish()
    ctx = t_contexts.make_context_states(QP).tolist()
    dec = t_cabac.CabacDecoder(data)
    assert [dec.decode_bin(ctx, i % 7) for i in range(400)] == bins
    assert ctx == enc_ctx.tolist()


# ------------------------------------------------------------ syntax ----

def sbh_consistent(coeffs, n, mode):
    """`coeffs` with the sign of each hiding coefficient group's first
    nonzero (scan order) set by its level parity, as the encoder's RDOQ
    leaves it (negative iff the group's sum of levels is odd)."""
    scan = t_scans.scan_order(n, n, t_scans.select_scan(mode, n))
    flat = coeffs.reshape(-1)
    for cg in range(max(n * n // 16, 1)):
        pos = scan[cg * 16:cg * 16 + 16]
        nz = [p for p in pos if flat[p]]
        if len(nz) < 2:
            continue
        first = list(pos).index(nz[0])
        last = list(pos).index(nz[-1])
        if last - first >= t_syntax.SBH_THRESHOLD:
            odd = int(np.abs(flat[pos]).sum()) & 1
            flat[nz[0]] = -abs(flat[nz[0]]) if odd else abs(flat[nz[0]])
    return coeffs


@pytest.mark.parametrize("sign_hiding", [False, True])
@pytest.mark.parametrize("mode", [0, 10, 26])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_decode_coefficients_reads_jax_encoder(n, mode, sign_hiding):
    """Seeded blocks from sparse to dense (levels up to 3000, escapes and
    Rice updates) in the diagonal, vertical (mode 10) and horizontal (mode
    26) scans (n > 8 is always diagonal)."""
    rng = np.random.default_rng(n * 100 + mode + sign_hiding)
    enc_ctx = j_contexts.make_context_states(QP)
    dec_ctx = t_contexts.make_context_states(QP)
    enc = j_cabac.CabacEncoder()
    blocks = []
    for density in (0.02, 0.1, 0.3, 0.8):
        for _ in range(3):
            c = np.where(rng.random((n, n)) < density,
                         rng.integers(-40, 41, (n, n)), 0)
            c[rng.random((n, n)) < 0.02] = rng.integers(-3000, 3000)
            if not c.any():
                c[0, 0] = 1
            c = c.astype(np.int32)
            if sign_hiding:
                c = sbh_consistent(c, n, mode)
            blocks.append(c)
            j_syntax.encode_coefficients(enc, enc_ctx, c, mode, sign_hiding)
    data = enc.terminate_and_finish()
    dec = t_cabac.CabacDecoder(data)
    for i, c in enumerate(blocks):
        got = t_syntax.decode_coefficients(dec, dec_ctx, n, mode, sign_hiding)
        np.testing.assert_array_equal(got, c, err_msg=f"block {i}")
    np.testing.assert_array_equal(dec_ctx, enc_ctx)


def test_intra_mode_syntax_and_mpms():
    rng = np.random.default_rng(3)
    for left in range(36):
        for above in range(36):
            if left < 35 and above < 35:
                assert (t_syntax.mpm_candidates(left, above)
                        == j_syntax.mpm_candidates(left, above))
            assert (t_encoder.mpms_switch(left, above)
                    == j_encoder.FrameEncoder._mpms_switch(left, above))
    enc_ctx = j_contexts.make_context_states(QP)
    dec_ctx = t_contexts.make_context_states(QP)
    enc = j_cabac.CabacEncoder()
    cases = []
    for _ in range(300):
        mpms = t_syntax.mpm_candidates(*(int(v) for v in
                                         rng.integers(0, 35, 2)))
        mode = int(rng.choice(mpms)) if rng.random() < 0.4 else \
            int(rng.integers(0, 35))
        j_syntax.encode_intra_mode(enc, enc_ctx, mode, mpms)
        cases.append((mode, mpms))
    dec = t_cabac.CabacDecoder(enc.terminate_and_finish())
    assert [t_syntax.decode_intra_mode(dec, dec_ctx, m) for _, m in cases] \
        == [mode for mode, _ in cases]
    assert (t_encoder.PNNS_MODE, t_encoder.MIN_CU, t_encoder.MAX_TU) == (
        j_encoder.PNNS_MODE, j_encoder.MIN_CU, j_encoder.MAX_TU)
    np.testing.assert_array_equal(t_scans.MIN_IN_GROUP,
                                  j_syntax.scans.MIN_IN_GROUP)
    for n in (4, 8, 16, 32):
        for s in range(3):
            np.testing.assert_array_equal(
                t_scans.cg_scan_order(n, n, s),
                j_syntax.scans.cg_scan_order(n, n, s))


# ------------------------------------------------ prediction, transforms ----

def seeded_refs(rng, n, smooth=False):
    if smooth:
        corner = int(rng.integers(40, 200))
        ramp = corner + np.arange(2 * n + 1) * int(rng.integers(-1, 2))
        top = np.clip(ramp + rng.integers(-1, 2, 2 * n + 1), 0, 255)
        left = np.clip(ramp + rng.integers(-1, 2, 2 * n + 1), 0, 255)
    else:
        top = rng.integers(0, 256, 2 * n + 1)
        left = rng.integers(0, 256, 2 * n + 1)
    left[0] = top[0]
    return top.astype(np.int32), left.astype(np.int32)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_prediction_and_reference_filter(n):
    rng = np.random.default_rng(n)
    for case in range(12):
        top, left = seeded_refs(rng, n, smooth=case % 2 == 1)
        for strong in (True, False):
            want = j_rs.filter_reference_samples(
                top, left, n, strong_intra_smoothing=strong)
            got = t_rs.filter_reference_samples(
                top, left, n, strong_intra_smoothing=strong)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        for mode in range(35):
            assert (t_rs.use_filtered_for_mode(mode, n)
                    == j_rs.use_filtered_for_mode(mode, n))
            np.testing.assert_array_equal(
                t_intra.predict_one_mode_np(top, left, mode),
                j_intra.predict_one_mode_np(top, left, mode),
                err_msg=f"mode {mode}")


def test_coded_unit_flags():
    rng = np.random.default_rng(11)
    h, w = 96, 128
    for _ in range(20):
        coded = rng.random((h // 4, w // 4)) < 0.6
        for n in (4, 8, 16, 32):
            for y in range(0, h, n):
                for x in range(0, w, n):
                    np.testing.assert_array_equal(
                        t_rs.coded_unit_flags(coded, x, y, n, h, w),
                        j_rs.neighbor_unit_flags(coded, x, y, n, h, w))


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_dequantize_and_inverse_transform(n):
    rng = np.random.default_rng(n + 1)
    q = rng.integers(-300, 301, (6, n, n)).astype(np.int32)
    q[0] = rng.integers(-32768, 32768, (n, n))
    for qp in range(0, 52, 3):
        np.testing.assert_array_equal(t_transform.dequantize_np(q, qp),
                                      j_transform.dequantize_np(q, qp))
    c = rng.integers(-32768, 32768, (6, n, n)).astype(np.int32)
    for dst in ((False, True) if n == 4 else (False,)):
        np.testing.assert_array_equal(
            t_transform.inverse_transform_np(c, use_dst=dst),
            j_transform.inverse_transform_np(c, use_dst=dst))
    assert t_transform.transform_shift(2) == j_transform.transform_shift(2)


# --------------------------------------------------------------- PNN ----

QPNN = sorted(f[:-4] for f in os.listdir(FROZEN)
              if f.startswith("qpnn_") and f.endswith(".npz"))


def test_all_ten_models_listed():
    assert len(QPNN) == 10


@pytest.mark.parametrize("name", QPNN)
def test_pnn_predictor_matches_jax(name):
    """Seeded reconstruction and coded-unit grid; at positions where the
    context is available (and one where it is not) the port's predictor
    on the CPU equals the JAX package's.  Pair models are bound through
    the QP >= 32 selection."""
    n = int(name.split("_")[1][1:])
    pair = name.endswith("pair")
    q_j = j_pnn_q.load_quantized(os.path.join(FROZEN, name + ".npz"))
    q_t = t_pnn_q.load_quantized(os.path.join(FROZEN, name + ".npz"))
    mean = mean_training()
    fc = str(q_j["kind"]) == "fc"
    j_bundle = j_nn_intra.PnnBundle(
        {}, {n: fc}, mean, quantized={} if pair else {n: q_j},
        pair_quantized={n: q_j} if pair else None)
    t_bundle = t_nn_intra.PnnBundle(
        {} if pair else {n: q_t}, mean,
        pair_quantized={n: q_t} if pair else None)
    qp = 37 if pair else 27
    j_pred = j_nn_intra.PnnPredictor(j_bundle).bind_qp(qp)
    t_pred = t_nn_intra.PnnPredictor(t_bundle, device="cpu").bind_qp(qp)
    rng = np.random.default_rng(n)
    h = w = 4 * n
    recon = rng.integers(0, 256, (h, w)).astype(np.int32)
    coded = np.zeros((h // 4, w // 4), bool)
    coded[: n // 4] = True
    coded[:, : n // 4] = True
    coded[n // 4: 2 * n // 4, n // 4: 3 * n // 4] = rng.random(
        (n // 4, n // 2)) < 0.7
    for (x, y) in ((n, n), (2 * n, n), (n, 2 * n), (0, n)):
        flags = j_rs.neighbor_unit_flags(coded, x, y, n, h, w)
        want = j_pred.predict(recon, x, y, n, flags)
        got = t_pred.predict(recon, x, y, n, flags)
        np.testing.assert_array_equal(got, np.asarray(want),
                                      err_msg=f"{name} at {(x, y)}")
    assert t_pred.forwards == {"fc": 3 * fc, "conv": 3 * (not fc)}


def test_float_only_width_raises():
    """A width with only a float model runs the float forward (the JAX
    package's fallback, `codec/nn_intra.py:225-232`); a float model that
    lacks its layers raises rather than predicting zeros."""
    bundle = t_nn_intra.PnnBundle(None, 100.0, params={8: {}})
    pred = t_nn_intra.PnnPredictor(bundle, device="cpu")
    assert not pred.supports(4)
    assert pred.supports(8)
    with pytest.raises(KeyError, match="convolutional"):
        pred.predict(np.zeros((32, 32), np.int32), 8, 8, 8,
                     np.ones(9, bool))
