"""The port's batched transforms and quantiser against the JAX package's.

`forward_transform`, `inverse_transform`, `quantize` and `dequantize` of
port `ops/transform.py` take (B, n, n) integer tensors and compute on
their device (float64 products, int64 elsewhere).  Here they run on the
CPU, held at zero tolerance against:

* the JAX package's device versions (int32, jitted) on seeded blocks, for
  n = 4, 8, 16, 32 and the 4x4 DST, QP 0-51 and both slice types, with
  the extremes of each range included: HM's 16-bit coefficient and level
  range [-32768, 32767] for `inverse_transform`, `quantize` and
  `dequantize`; for `forward_transform` the residuals whose int32 sums the
  JAX package keeps exact, |r| < 2^(17 - log2 n) (every residual of 8-bit
  video), since beyond that its sums wrap;
* the port's numpy twins (`*_np`, int64) over the whole 16-bit range,
  where the forward transform stays exact and the JAX package's does not
  (a case shows that it wraps);
* the properties `tests/test_transform.py` checks on the JAX package.
"""

import numpy as np
import pytest
import torch

from context_adaptive_neural_network_based_prediction_tpu.ops import (
    transform as j_transform)
from context_adaptive_neural_network_based_prediction_tpu_torch.ops import (
    transform as t_transform)

SIZES = [(4, False), (4, True), (8, False), (16, False), (32, False)]
IDS = ["dct4", "dst4", "dct8", "dct16", "dct32"]
LO16, HI16 = -32768, 32767
QPS = range(52)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def jax_exact_bound(n: int) -> int:
    """The largest |r| whose forward-transform sums fit the JAX package's
    int32 arithmetic at size n."""
    return (1 << (17 - (n.bit_length() - 1))) - 1


def blocks(rng, n, lo, hi, matrix=None, count=24):
    """Seeded (B, n, n) int32 blocks in [lo, hi]: uniform ones, every
    entry at each extreme, alternating extremes, and (given `matrix`) rows
    whose signs follow each matrix row, which drive each sum to its
    largest magnitude."""
    out = [rng.integers(lo, hi + 1, (count, n, n)),
           np.full((1, n, n), lo), np.full((1, n, n), hi),
           np.where((np.arange(n)[:, None] + np.arange(n)) % 2, lo, hi)[None]]
    if matrix is not None:
        sgn = np.sign(np.asarray(matrix, np.int64))
        big = min(-lo, hi)
        out.append(np.repeat((sgn * big)[:, None, :], n, axis=1))
        out.append(np.repeat((-sgn * big)[:, None, :], n, axis=1))
        out.append(np.repeat((sgn * big)[:, :, None], n, axis=2))
    return np.concatenate(out).astype(np.int32)


def fwd_matrix(n, dst):
    return t_transform.DST4_FWD if dst else t_transform.dct_matrix(n, True)


def inv_matrix(n, dst):
    return t_transform.DST4 if dst else t_transform.dct_matrix(n)


def port(fn, x, *args, **kw):
    out = fn(torch.from_numpy(x), *args, **kw)
    assert out.dtype == torch.int32 and out.device.type == "cpu"
    return out.numpy()


@pytest.mark.parametrize("n,dst", SIZES, ids=IDS)
def test_forward_matches_jax(n, dst):
    rng = np.random.default_rng(100 + n + dst)
    b = jax_exact_bound(n)
    x = np.concatenate([blocks(rng, n, -b, b, fwd_matrix(n, dst)),
                        blocks(rng, n, -255, 255)])
    want = np.asarray(j_transform.forward_transform(x, use_dst=dst))
    np.testing.assert_array_equal(
        port(t_transform.forward_transform, x, use_dst=dst), want)


@pytest.mark.parametrize("n,dst", SIZES, ids=IDS)
def test_forward_matches_numpy_over_16_bits(n, dst):
    rng = np.random.default_rng(200 + n + dst)
    x = blocks(rng, n, LO16, HI16, fwd_matrix(n, dst))
    np.testing.assert_array_equal(
        port(t_transform.forward_transform, x, use_dst=dst),
        t_transform.forward_transform_np(x, use_dst=dst))


@pytest.mark.parametrize("n", [8, 16, 32])
def test_jax_forward_wraps_beyond_its_int32_range(n):
    """Past |r| < 2^(17 - log2 n) the JAX package's int32 sums wrap; the
    port stays equal to the int64 twin.  (Why the JAX comparison stops
    there.)"""
    x = np.full((1, n, n), HI16, np.int32)
    want = t_transform.forward_transform_np(x)
    assert not np.array_equal(np.asarray(j_transform.forward_transform(x)),
                              want)
    np.testing.assert_array_equal(port(t_transform.forward_transform, x),
                                  want)


@pytest.mark.parametrize("n,dst", SIZES, ids=IDS)
def test_inverse_matches_jax_and_numpy(n, dst):
    rng = np.random.default_rng(300 + n + dst)
    x = blocks(rng, n, LO16, HI16, inv_matrix(n, dst).T)
    want = np.asarray(j_transform.inverse_transform(x, use_dst=dst))
    got = port(t_transform.inverse_transform, x, use_dst=dst)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, t_transform.inverse_transform_np(x, use_dst=dst))


@pytest.mark.parametrize("intra", [True, False], ids=["intra", "inter"])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_quantize_matches_jax_and_numpy(n, intra):
    rng = np.random.default_rng(400 + n + intra)
    x = blocks(rng, n, LO16, HI16, count=8)
    xt = torch.from_numpy(x)
    for qp in QPS:
        want = np.asarray(j_transform.quantize(x, qp, is_intra_slice=intra))
        got = t_transform.quantize(xt, qp, is_intra_slice=intra).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"QP {qp}")
        np.testing.assert_array_equal(
            got, t_transform.quantize_np(x, qp, is_intra_slice=intra),
            err_msg=f"QP {qp}")


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_dequantize_matches_jax_and_numpy(n):
    rng = np.random.default_rng(500 + n)
    x = blocks(rng, n, LO16, HI16, count=8)
    xt = torch.from_numpy(x)
    for qp in QPS:
        want = np.asarray(j_transform.dequantize(x, qp))
        got = t_transform.dequantize(xt, qp).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"QP {qp}")
        np.testing.assert_array_equal(got, t_transform.dequantize_np(x, qp),
                                      err_msg=f"QP {qp}")


@pytest.mark.parametrize("fn", [t_transform.forward_transform,
                                t_transform.inverse_transform])
@pytest.mark.parametrize("n", [8, 16, 32])
def test_dst_refused_off_4x4(fn, n):
    with pytest.raises(ValueError, match="DST only applies to 4x4"):
        fn(torch.zeros((1, n, n), dtype=torch.int32), use_dst=True)


def test_numpy_input_goes_to_device():
    """A numpy array is computed on `device`; a tensor on its own."""
    x = np.arange(16, dtype=np.int32).reshape(1, 4, 4) - 8
    got = t_transform.forward_transform(x, device="cpu")
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(),
                                  t_transform.forward_transform_np(x))


# ---- the properties tests/test_transform.py checks on the JAX package --

@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_dct_roundtrip_small_error(n):
    rng = np.random.default_rng(n)
    resi = rng.integers(-255, 256, (5, n, n)).astype(np.int32)
    back = t_transform.inverse_transform(
        t_transform.forward_transform(torch.from_numpy(resi)))
    assert np.abs(back.numpy() - resi).max() <= (1 if n <= 8 else 4)


def test_dst_roundtrip():
    rng = np.random.default_rng(0)
    resi = rng.integers(-255, 256, (5, 4, 4)).astype(np.int32)
    coeff = t_transform.forward_transform(torch.from_numpy(resi),
                                          use_dst=True)
    back = t_transform.inverse_transform(coeff, use_dst=True)
    assert np.abs(back.numpy() - resi).max() <= 1


def test_dc_coefficient_value():
    coeff = t_transform.forward_transform(
        torch.ones((1, 4, 4), dtype=torch.int32)).numpy()
    assert coeff[0, 0, 0] == 128
    assert np.all(coeff[0].reshape(-1)[1:] == 0)


@pytest.mark.parametrize("qp", [0, 17, 22, 27, 32, 37, 42, 51])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_quant_dequant_error_bounded(qp, n):
    rng = np.random.default_rng(qp * 100 + n)
    resi = rng.integers(-255, 256, (3, n, n)).astype(np.int32)
    coeff = t_transform.forward_transform(torch.from_numpy(resi))
    deq = t_transform.dequantize(t_transform.quantize(coeff, qp), qp)
    step = (2.0 ** ((qp - 4) / 6.0)) * (2 ** (t_transform.transform_shift(
        int(np.log2(n)))))
    assert (deq - coeff).abs().max().item() <= step * 1.1 + 1


def test_quant_zero_at_high_qp():
    coeff = t_transform.forward_transform(
        torch.ones((1, 8, 8), dtype=torch.int32))
    assert not t_transform.quantize(coeff, 51).any()


def test_quant_rounding_offset_intra():
    coeff = torch.zeros((1, 4, 4), dtype=torch.int32)
    coeff[0, 0, 0] = 100
    q_intra = t_transform.quantize(coeff, 22, is_intra_slice=True)
    q_inter = t_transform.quantize(coeff, 22, is_intra_slice=False)
    assert q_intra[0, 0, 0] >= q_inter[0, 0, 0]


def test_sign_symmetry():
    rng = np.random.default_rng(1)
    coeff = torch.from_numpy(
        rng.integers(-1000, 1000, (2, 8, 8)).astype(np.int32))
    np.testing.assert_array_equal(t_transform.quantize(coeff, 30).numpy(),
                                  -t_transform.quantize(-coeff, 30).numpy())


@pytest.mark.parametrize("qp", [10, 37])
def test_full_pipeline_error(qp):
    rng = np.random.default_rng(2)
    base = rng.integers(0, 256, (1, 8, 8)).astype(np.float64)
    smooth = np.asarray(np.round(
        (base + np.roll(base, 1, 1) + np.roll(base, 1, 2)) / 3), np.int32)
    resi = torch.from_numpy(smooth - 128)
    q = t_transform.quantize(t_transform.forward_transform(resi), qp)
    rec = t_transform.inverse_transform(t_transform.dequantize(q, qp))
    assert (rec - resi).abs().max().item() <= (3 if qp == 10 else 90)
