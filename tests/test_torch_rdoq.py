"""The port's RD tools of the host codec against the JAX package, with
zero tolerance: RDOQ (`codec/rdoq.py`: the native `rdoq_tu` behind
`rdoq` and `rdoq_python`, luma and chroma), the RD helpers of
`codec/rdo.py` (SATD, the counting CABAC and its native coefficient
count, the fast candidate counts) and
the numpy twins the host encoder runs (`ops/transform.py`
`forward_transform_np` / `quantize_np`, `ops/intra.py`
`predict_all_modes_np`).

RDOQ inputs are seeded: transformed residuals of every TU size (luma 4-32
with the DST at 4, chroma 4-16), scaled up so that every level region
occurs, at QP 22-37, both sign-hiding settings, and context states drawn
from the valid range, so that the rates differ from the initial states.
"""

import numpy as np
import pytest
import torch

from context_adaptive_neural_network_based_prediction_tpu.codec import (
    contexts as j_contexts, rdo as j_rdo, rdoq as j_rdoq, syntax as j_syntax)
from context_adaptive_neural_network_based_prediction_tpu.ops import (
    intra as j_intra, transform as j_transform)
from context_adaptive_neural_network_based_prediction_tpu_torch.codec import (
    contexts as t_contexts, native as t_native, rdo as t_rdo,
    rdoq as t_rdoq, syntax as t_syntax)
from context_adaptive_neural_network_based_prediction_tpu_torch.ops import (
    intra as t_intra, transform as t_transform)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def tu_case(seed, n, qp, chroma):
    """Seeded coefficients of one n x n TU, an intra mode and context
    states."""
    rng = np.random.default_rng(seed)
    scale = rng.choice([4, 16, 60, 160])
    resi = rng.normal(0, scale, (n, n)).round().astype(np.int32)
    resi[rng.random((n, n)) < 0.3] = 0
    coeffs = j_transform.forward_transform_np(
        resi[None], use_dst=(n == 4 and not chroma))[0]
    mode = int(rng.integers(0, 35))
    ctx = j_contexts.make_context_states(qp).copy()
    flip = rng.random(ctx.shape) < 0.5
    ctx[flip] = rng.integers(0, 126, int(flip.sum()))
    return coeffs, mode, ctx


LUMA_CASES = [(n, qp, sh) for n in (4, 8, 16, 32) for qp in (22, 27, 32, 37)
              for sh in (True, False)]


@pytest.mark.parametrize("n,qp,sign_hiding", LUMA_CASES)
def test_luma_rdoq_native_and_python_match_jax(n, qp, sign_hiding):
    lam = t_rdo.lambda_for_qp(qp)
    for seed in range(6):
        coeffs, mode, ctx = tu_case(1000 * n + 10 * qp + seed, n, qp, False)
        for depth0 in (0, 1):
            want = j_rdoq.rdoq_python(coeffs, qp, mode, lam, ctx,
                                      cbf_ctx_offset=depth0,
                                      sign_hiding=sign_hiding)
            got_py = t_rdoq.rdoq_python(coeffs, qp, mode, lam, ctx,
                                        cbf_ctx_offset=depth0,
                                        sign_hiding=sign_hiding)
            got_native = t_native.rdoq_tu_native(coeffs, qp, mode, lam, ctx,
                                                 depth0, sign_hiding)
            got = t_rdoq.rdoq(coeffs, qp, mode, lam, ctx,
                              cbf_ctx_offset=depth0, sign_hiding=sign_hiding)
            np.testing.assert_array_equal(got_py, want)
            np.testing.assert_array_equal(got_native, want)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [4, 8, 16])
@pytest.mark.parametrize("qp", [22, 29, 37])
@pytest.mark.parametrize("sign_hiding", [True, False])
def test_chroma_rdoq_matches_jax(n, qp, sign_hiding):
    lam = t_rdo.lambda_for_qp(qp)
    for seed in range(4):
        coeffs, mode, ctx = tu_case(77 + 100 * n + qp + seed, n, qp, True)
        want = j_rdoq.rdoq_python(coeffs, qp, mode, lam, ctx,
                                  cbf_ctx_offset=0, sign_hiding=sign_hiding,
                                  channel=j_syntax.CHROMA)
        got = t_rdoq.rdoq(coeffs, qp, mode, lam, ctx, cbf_ctx_offset=0,
                          sign_hiding=sign_hiding, channel=t_syntax.CHROMA)
        np.testing.assert_array_equal(got, want)


def test_rdoq_reads_but_does_not_change_the_contexts():
    coeffs, mode, ctx = tu_case(5, 16, 32, False)
    before = ctx.copy()
    t_rdoq.rdoq(coeffs, 32, mode, t_rdo.lambda_for_qp(32), ctx,
                sign_hiding=True)
    np.testing.assert_array_equal(ctx, before)


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
def test_satd_matches_jax(n):
    rng = np.random.default_rng(n)
    resi = rng.integers(-255, 256, (5, n, n)).astype(np.int32)
    np.testing.assert_array_equal(t_rdo.satd(resi), j_rdo.satd(resi))


def test_rd_constants_match_jax():
    assert t_rdo.NUM_FAST_CANDIDATES == j_rdo.NUM_FAST_CANDIDATES
    for qp in range(52):
        assert t_rdo.lambda_for_qp(qp) == j_rdo.lambda_for_qp(qp)


def test_bit_counter_matches_jax():
    """One seeded sequence of context, bypass and terminating bins through
    both counting coders: the same bits and context states."""
    rng = np.random.default_rng(11)
    ops = [(int(rng.integers(0, 4)), int(rng.integers(0, 2)),
            int(rng.integers(0, len(t_contexts.make_context_states(30)))))
           for _ in range(4000)]
    out = []
    for mod, ctx_mod in ((j_rdo, j_contexts), (t_rdo, t_contexts)):
        c = mod.BitCounter()
        ctx = ctx_mod.make_context_states(30).copy()
        for kind, b, idx in ops:
            if kind == 0:
                c.encode_bin(b, ctx, idx)
            elif kind == 1:
                c.encode_bin_ep(b)
            elif kind == 2:
                c.encode_bins_ep(b, 3)
            else:
                c.encode_bin_trm(b)
        out.append((c.bits, np.asarray(ctx).tolist()))
    assert out[0] == out[1]


COUNT_CASES = ([(n, False) for n in (4, 8, 16, 32)]
               + [(n, True) for n in (4, 8, 16)])


@pytest.mark.parametrize("sign_hiding", [True, False])
@pytest.mark.parametrize("n,chroma", COUNT_CASES)
def test_native_coefficient_count_matches_jax(n, chroma, sign_hiding):
    """`BitCounter.count_coefficients` (the native count) against the JAX
    package's `encode_coefficients` through its counting coder: the same
    bits and the same context states after, on quantized TUs at QP 0-37
    (escape codes of every length) and sparse TUs with large levels, in
    the three scans (modes 0, 10 and 26 and seeded ones)."""
    j_ch = j_syntax.CHROMA if chroma else j_syntax.LUMA
    t_ch = t_syntax.CHROMA if chroma else t_syntax.LUMA
    for seed in range(8):
        coeffs, mode, ctx = tu_case(500 + 100 * n + seed, n, 30, chroma)
        rng = np.random.default_rng(seed)
        sparse = np.where(rng.random((n, n)) < 0.08,
                          rng.integers(-3000, 3001, (n, n)), 0)
        sparse[rng.integers(0, n), rng.integers(0, n)] = 1
        tus = [j_transform.quantize_np(coeffs[None], qp)[0]
               for qp in (0, 12, 22, 30, 37)] + [sparse.astype(np.int32)]
        for q in tus:
            if not q.any():
                continue
            for m in (0, 10, 26, mode):
                want_ctx, got_ctx = ctx.copy(), ctx.copy()
                want = j_rdo.BitCounter()
                j_syntax.encode_coefficients(want, want_ctx, q, m,
                                             sign_hiding, channel=j_ch)
                got = t_rdo.BitCounter()
                got.count_coefficients(got_ctx, q, m, sign_hiding,
                                       channel=t_ch)
                assert got.bits == want.bits
                np.testing.assert_array_equal(got_ctx, want_ctx)


def test_native_coefficient_count_refuses_bad_inputs():
    ctx = t_contexts.make_context_states(30).copy()
    with pytest.raises(RuntimeError):
        t_rdo.BitCounter().count_coefficients(
            ctx, np.zeros((8, 8), np.int32), 0)
    with pytest.raises(TypeError):
        t_rdo.BitCounter().count_coefficients(
            ctx.astype(np.int64), np.ones((8, 8), np.int32), 0)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_numpy_transforms_match_jax(n):
    rng = np.random.default_rng(n)
    resi = rng.integers(-255, 256, (4, n, n)).astype(np.int32)
    for dst in ((False, True) if n == 4 else (False,)):
        c = t_transform.forward_transform_np(resi, use_dst=dst)
        np.testing.assert_array_equal(
            c, j_transform.forward_transform_np(resi, use_dst=dst))
        for qp in (0, 22, 37, 51):
            np.testing.assert_array_equal(
                t_transform.quantize_np(c, qp),
                j_transform.quantize_np(c, qp))


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
def test_predict_all_modes_np_matches_jax(n):
    rng = np.random.default_rng(n)
    top = rng.integers(0, 256, (3, 2 * n + 1)).astype(np.int32)
    left = rng.integers(0, 256, (3, 2 * n + 1)).astype(np.int32)
    left[:, 0] = top[:, 0]
    for filtered in (True, False):
        np.testing.assert_array_equal(
            t_intra.predict_all_modes_np(top, left, filtered_edges=filtered),
            j_intra.predict_all_modes_np(top, left, filtered_edges=filtered))
