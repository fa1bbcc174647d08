"""The exactness argument of the n = 16 / 32 unit trial kernel's transforms
(`ops/csrc/unit_trial.cu`, `product`), held on the CPU.

The kernel runs the four transform passes (forward rows and columns,
inverse columns and rows) as FP64 tensor-core products (`mma.sync`
m8n8k4), in double, and rounds each pass's sums by floor((sum +
2^(shift-1)) 2^-shift).  That equals the plain trial's integer transforms
bit for bit if every operand, product and partial sum is an integer below
2^53.  These tests compute the worst-case magnitudes from the port's own
tables at n = 16 and 32 and every QP % 6 (and below 2^31 for the passes
the plain trial sums in int32), and emulate the kernel's route in
float64, four terms a product step, on extreme inputs (residuals at +-255,
dequantised levels at the 16-bit clip), against the plain trial's
transforms (`unit_fused._forward_plain` / `_inverse_plain`) and int64
numpy.  They also hold the kernel's small-integer conversions through the
float adder.
"""

import numpy as np
import pytest
import torch

from context_adaptive_neural_network_based_prediction_tpu_torch.codec import (
    rdo)
from context_adaptive_neural_network_based_prediction_tpu_torch.ops import (
    transform, unit_fused)
from context_adaptive_neural_network_based_prediction_tpu_torch.parallel import (
    rate_model, wavefront2)

F64_EXACT = 2 ** 53
I32 = 2 ** 31
CLIP = 32768


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def tables(n, qp):
    c = wavefront2._unit_consts(n, qp)
    return (np.asarray(c["t_fwd"], np.int64), np.asarray(c["t_inv"], np.int64),
            int(c["shift1"]), int(c["shift2"]), int(c["iq_shift"]),
            transform.INV_QUANT_SCALES[qp % 6])


def bounds(n, qp):
    """Worst-case |operand|, |product| and |partial sum| of each pass (any
    prefix of a sum is bounded by the sum of the absolute terms)."""
    tf, ti, s1, s2, _, _ = tables(n, qp)
    row_tf = np.abs(tf).sum(axis=1).max()          # sum_x |Tf(k, x)|
    col_ti = np.abs(ti).sum(axis=0).max()          # sum_k |Ti(k, i)|
    out = {}
    r = 255
    out["forward rows"] = (r, r * np.abs(tf).max(), r * row_tf)
    a = (r * row_tf + (1 << (s1 - 1))) >> s1       # |a'| after the shift
    out["forward cols"] = (a, a * np.abs(tf).max(), a * row_tf)
    out["coefficient"] = ((a * row_tf + (1 << (s2 - 1))) >> s2,)
    for name in ("inverse cols", "inverse rows"):
        out[name] = (CLIP, CLIP * np.abs(ti).max(), CLIP * col_ti)
    return out


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("rem", range(6))
def test_transform_magnitudes_are_exact(n, rem):
    """Every pass below 2^53 (FP64 tensor cores, exact in any order); every
    pass but the forward columns below 2^31 (the plain trial's int32 sums;
    it splits the forward columns' operand in bytes); the
    coefficients and the levels below 2^22 (the float adder's exact
    conversions); the dequantisation's product below 2^31 at every QP."""
    for qp in range(rem, 52, 6):
        b = bounds(n, qp)
        for name in ("forward rows", "forward cols", "inverse cols",
                     "inverse rows"):
            operand, product, partial = b[name]
            assert max(operand, product, partial) < F64_EXACT, (name, qp)
            if name != "forward cols":
                assert partial < I32, (name, qp)
        assert b["forward cols"][2] >= I32       # why the plain trial splits
        assert b["coefficient"][0] < 2 ** 22 and CLIP < 2 ** 22
        _, _, _, _, iq, iq_scale = tables(n, qp)
        deq = CLIP * iq_scale * (1 << max(-iq, 0)) + (1 << max(iq - 1, 0))
        assert deq < I32, qp


def mma_f64(a, b):
    """A @ B as the kernel sums it: float64 from 0, one m8n8k4 step (four
    terms of k) at a time, in ascending k."""
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float64)
    for k0 in range(0, a.shape[1], 4):
        acc = acc + a[:, k0:k0 + 4] @ b[k0:k0 + 4]
    return acc


def rounded(acc, shift, lo=-(2 ** 31), hi=2 ** 31 - 1):
    """floor((sum + 2^(shift-1)) 2^-shift), clipped, in float64."""
    v = torch.floor((acc + float(1 << (shift - 1))) * 2.0 ** -shift)
    return v.clamp(lo, hi)


def kernel_forward(r, tf, s1, s2):
    tfd = torch.from_numpy(tf).double()
    a = rounded(mma_f64(r.double(), tfd.T), s1)
    return rounded(mma_f64(tfd, a), s2)


def kernel_inverse(d, ti):
    tid = torch.from_numpy(ti).double()
    e = rounded(mma_f64(tid.T, d.double()), 7, -CLIP, CLIP - 1)
    return rounded(mma_f64(e, tid), 12, -CLIP, CLIP - 1)


def sign_patterns(m, amp, lo, rng):
    """Blocks at the extremes: constant +-, outer products of the signs of
    matrix rows (the largest sums of both passes), checkerboards, random
    signs."""
    n = m.shape[0]
    sg = np.where(m >= 0, 1, -1)
    out = [np.full((n, n), amp), np.full((n, n), lo)]
    for k1, k2 in ((0, 0), (1, 1), (0, n - 1), (n // 2, 1), (n - 1, n - 1),
                   (3, n // 2 + 1)):
        out.append(np.where(np.outer(sg[k1], sg[k2]) > 0, amp, lo))
        out.append(np.where(np.outer(sg[k1], sg[k2]) > 0, lo, amp))
    yy, xx = np.mgrid[0:n, 0:n]
    out.append(np.where((yy + xx) % 2 == 0, amp, lo))
    out += [np.where(rng.random((n, n)) < 0.5, amp, lo) for _ in range(6)]
    return np.stack(out).astype(np.int64)


def plain_consts(n, qp=32):
    c = wavefront2._unit_consts(n, qp)
    cst = unit_fused.build_consts(
        n, 35, c, rate_model.scalar_bits(qp), rdo.lambda_for_qp(qp),
        transform.QUANT_SCALES[qp % 6], transform.INV_QUANT_SCALES[qp % 6],
        b_eff=8, groups={16: 6, 32: 36}[n])
    return unit_fused.consts_from_numpy(cst, device="cpu")


def to_lanes(blocks, tc):
    """(B, n, n) raster -> (n^2, B) in the plain trial's CG-grouped order."""
    b = blocks.shape[0]
    return blocks.reshape(b, -1)[:, tc["pp"]].T.contiguous()


def from_lanes(x, tc, n):
    return x.T[:, tc["ipp"]].reshape(-1, n, n)


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("qp", [22, 37])
def test_forward_on_tensor_cores_equals_plain(n, qp):
    """Residuals at +-255: the emulated FP64 route equals the plain trial's
    hi/lo-split transform and int64 numpy, bit for bit."""
    tc = plain_consts(n, qp)
    tf, _, s1, s2, _, _ = tables(n, qp)
    r = sign_patterns(tf, 255, -255, np.random.default_rng(n + qp))
    r = np.concatenate([r, np.zeros((1, n, n), np.int64),
                        np.random.default_rng(qp).integers(-255, 256,
                                                           (4, n, n))])
    got = torch.stack([kernel_forward(torch.from_numpy(x), tf, s1, s2)
                       for x in r])
    plain = from_lanes(unit_fused._forward_plain(
        tc, to_lanes(torch.from_numpy(r).float(), tc)), tc, n)
    a = (r @ tf.T + (1 << (s1 - 1))) >> s1
    ref = (tf @ a + (1 << (s2 - 1))) >> s2
    assert torch.equal(got, plain.double())
    assert np.array_equal(got.numpy().astype(np.int64), ref)
    assert np.abs(ref).max() > 16000              # the extremes were reached


@pytest.mark.parametrize("n", [16, 32])
def test_inverse_on_tensor_cores_equals_plain(n):
    """Dequantised levels at the 16-bit clip: the emulated FP64 route
    (with its clips) equals the plain trial's inverse and int64 numpy."""
    tc = plain_consts(n)
    _, ti, _, _, _, _ = tables(n, 32)
    d = sign_patterns(ti.T, CLIP - 1, -CLIP, np.random.default_rng(n))
    d = np.concatenate([d, np.random.default_rng(1).integers(
        -CLIP, CLIP, (4, n, n))])
    got = torch.stack([kernel_inverse(torch.from_numpy(x), ti) for x in d])
    plain = from_lanes(unit_fused._inverse_plain(
        tc, to_lanes(torch.from_numpy(d).to(torch.int32), tc)), tc, n)
    e = np.clip((ti.T @ d + 64) >> 7, -CLIP, CLIP - 1)
    ref = np.clip((e @ ti + 2048) >> 12, -CLIP, CLIP - 1)
    assert torch.equal(got, plain.double())
    assert np.array_equal(got.numpy().astype(np.int64), ref)
    assert np.abs(e).max() >= CLIP - 1            # the clip was reached


def test_small_int_float_conversions_exact():
    """The kernel's int <-> float conversions through the float adder
    (`i2f_small`, `f2i_small`: 1.5 * 2^23 as a bias) are exact for every
    integer below 2^22 in magnitude."""
    i = np.arange(-(2 ** 22) + 1, 2 ** 22, dtype=np.int64)
    bias = np.float32(12582912.0)
    f = (np.int32(0x4B400000) + i.astype(np.int32)).view(np.float32) - bias
    assert np.array_equal(f, i.astype(np.float32))
    back = (f + bias).view(np.int32) - np.int32(0x4B400000)
    assert np.array_equal(back.astype(np.int64), i)
