"""The port's float FC PNN forward (plain version) against the JAX
package's.

`fc_forward.fc_plain` and the wrapper `fc_forward.fc_forward` (CPU tensors
take the plain version), with float32 weights, against the normative
`pnn.fc_forward`; with bfloat16 weights against the JAX package's TPU
kernel `fc_forward_pallas` run in interpret mode (bf16 weight storage,
float32 products and sums).  Tolerance: 1e-4 of max |reference| (float32
sums over 1200 terms in another order).  Widths 4 and 8, batches 1, 7,
128, 200 (ragged against the TPU kernel's 128-row tiles), seeded inputs
and biases.  The CUDA kernel is held against the plain version in
`tests/test_torch_cuda.py`.

The CUDA kernel computes in split TF32 on the tensor cores.  Its arithmetic
is emulated here in plain PyTorch (TF32 rounding by bit operations, three
float32 products per layer) on the frozen FC singles and held against the
JAX package's `pnn.fc_forward` within the same 1e-4; the weight
preparation (transposed hi/lo split, cached per tensor) and the tiling
plan are checked too.
"""

import os

import numpy as np
import pytest
import torch

import jax

from context_adaptive_neural_network_based_prediction_tpu.models import (
    pnn as j_pnn, zoo as j_zoo)
from context_adaptive_neural_network_based_prediction_tpu.ops.pallas import (
    fc_forward as j_fc)
from context_adaptive_neural_network_based_prediction_tpu_torch.models import (
    pnn as t_pnn, zoo as t_zoo)
from context_adaptive_neural_network_based_prediction_tpu_torch.ops import (
    fc_forward as t_fc)

TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN = 86.8568


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def jax_params(w):
    """The JAX package's FC init at width w, with seeded nonzero biases,
    as numpy."""
    params = jax.tree_util.tree_map(
        np.asarray, j_pnn.init_params(jax.random.PRNGKey(w), w, True))
    rng = np.random.default_rng(w)
    fc = params["fully_connected"]
    for i in range(4):
        fc[f"biases_{i}"] = rng.normal(0, 0.1, fc[f"biases_{i}"].shape
                                       ).astype(np.float32)
    return params


def layers(params, dtype):
    fc = t_zoo.params_from_numpy(params, "cpu", dtype)["fully_connected"]
    return ([fc[f"weights_{i}"] for i in range(4)],
            [fc[f"biases_{i}"] for i in range(4)])


def contexts(w, batch):
    rng = np.random.default_rng(batch)
    return rng.normal(0, 30, (batch, 5 * w * w)).astype(np.float32)


def rel_err(got, ref):
    return np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("w", [4, 8])
@pytest.mark.parametrize("batch", [1, 7, 128, 200])
def test_fc_f32_matches_jax(w, batch):
    params = jax_params(w)
    x = contexts(w, batch)
    ref = np.asarray(j_pnn.fc_forward(params["fully_connected"], x, w))
    tp = t_zoo.params_from_numpy(params, "cpu")
    got = t_pnn.fc_forward(tp["fully_connected"], torch.from_numpy(x), w)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert rel_err(got.numpy(), ref) <= TOL
    ws, bs = layers(params, torch.float32)
    plain = t_fc.fc_plain(torch.from_numpy(x), ws, bs)
    assert rel_err(plain.numpy().reshape(ref.shape), ref) <= TOL


@pytest.mark.parametrize("w", [4, 8])
@pytest.mark.parametrize("batch", [1, 7, 128, 200])
def test_fc_bf16_matches_pallas(w, batch):
    params = jax_params(w)
    x = contexts(w, batch)
    ref = np.asarray(j_fc.fc_forward_pallas(params, x, w, interpret=True))
    ws, bs = layers(params, torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in ws)
    got = t_fc.fc_forward(torch.from_numpy(x), ws, bs)
    assert rel_err(got.numpy().reshape(ref.shape), ref) <= TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_padding_does_not_leak(dtype):
    # A batch of 3 gives the same rows as those rows inside a batch of 5
    # (the twin of tests/test_pallas.py::test_batch_padding_does_not_leak).
    w = 8
    ws, bs = layers(jax_params(w), dtype)
    x5 = torch.from_numpy(np.random.default_rng(0).normal(
        0, 30, (5, 320)).astype(np.float32))
    out5 = t_fc.fc_forward(x5, ws, bs)
    out3 = t_fc.fc_forward(x5[:3], ws, bs)
    np.testing.assert_allclose(out3.numpy(), out5[:3].numpy(), rtol=1e-5,
                               atol=1e-4)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel")

    monkeypatch.setattr(t_fc, "_kernel_layer", no_kernel)
    t_fc.reset_launch_counts()
    ws, bs = layers(jax_params(4), torch.float32)
    x = torch.from_numpy(contexts(4, 7))
    assert torch.equal(t_fc.fc_forward(x, ws, bs), t_fc.fc_plain(x, ws, bs))
    assert t_fc.launches == {}
    with pytest.raises(ValueError, match="impl"):
        t_fc.fc_forward(x, ws, bs, impl="fast")


def test_kernel_wrapper_checks_its_inputs():
    # The checks run before the kernel is built or launched.
    ws, bs = layers(jax_params(4), torch.float32)
    x = torch.from_numpy(contexts(4, 3))
    for args in ((x, ws[0].to(torch.float64), bs[0]),     # weight type
                 (x, ws[0], bs[0].to(torch.bfloat16)),     # bias type
                 (x.double(), ws[0], bs[0]),               # input type
                 (x, ws[0][:, :600], bs[0])):              # shape, layout
        with pytest.raises(ValueError, match="want contiguous"):
            t_fc._kernel_layer(*args, act=True)
    # The kernel's TMA reads rows of x and of the prepared weights with a
    # stride of K floats, which must be a multiple of 16 bytes.
    with pytest.raises(ValueError, match="K % 4"):
        t_fc._kernel_layer(torch.zeros(3, 6), torch.zeros(6, 5),
                           torch.zeros(5), act=True)


# ------------------------------------------- the kernel's split TF32 ----

def split_tf32_chain(x, weights, biases):
    """The CUDA kernel's arithmetic in plain PyTorch: per layer, x split
    into x_hi = tf32(x) and x_lo = tf32(x - x_hi), the prepared weight
    (w_hi, w_lo), and x_lo w_hi + x_hi w_lo + x_hi w_hi in float32 (no
    w_lo term for a bfloat16 weight), then the bias and the activation."""
    for i, (w, b) in enumerate(zip(weights, biases)):
        w_hi, w_lo = t_fc.prepare_weight(w)
        x_hi = t_fc.tf32_round(x)
        x_lo = t_fc.tf32_round(x - x_hi)
        h = x_lo @ w_hi.T
        if w_lo is not None:
            h = h + x_hi @ w_lo.T
        h = h + x_hi @ w_hi.T + b
        x = torch.maximum(t_fc.SLOPE * h, h) if i < len(weights) - 1 else h
    return x


def frozen_contexts(w, n, seed):
    """n seeded flattened contexts (pixels minus the mean, a random mask
    per example), as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, 5 * w * w)).astype(np.float32) - MEAN
    keep = rng.random((n, 5 * w * w)) < 0.8
    return np.where(keep, x, 0.0).astype(np.float32)


@pytest.mark.parametrize("w", [4, 8])
@pytest.mark.parametrize("batch", [1, 129, 256])
def test_split_tf32_arithmetic_matches_jax(w, batch):
    path = os.path.join(REPO, "artifacts", "frozen", f"pnn_w{w}_fc_single.npz")
    params, is_fc = j_zoo.load_frozen_params(path)
    assert is_fc
    x = frozen_contexts(w, batch, seed=100 * w + batch)
    ref = np.asarray(j_pnn.fc_forward(params["fully_connected"], x, w))
    ws, bs = layers(params, torch.float32)
    got = split_tf32_chain(torch.from_numpy(x), ws, bs)
    assert rel_err(got.numpy().reshape(ref.shape), ref) <= TOL
    # One TF32 product per layer is not enough: the split is what holds
    # the tolerance.
    one = torch.from_numpy(x)
    for i, (wt, b) in enumerate(zip(ws, bs)):
        h = t_fc.tf32_round(one) @ t_fc.tf32_round(wt) + b
        one = torch.maximum(t_fc.SLOPE * h, h) if i < 3 else h
    assert rel_err(one.numpy().reshape(ref.shape), ref) > \
        rel_err(got.numpy().reshape(ref.shape), ref)


@pytest.mark.parametrize("w", [4, 8])
def test_split_tf32_arithmetic_bf16_matches_pallas(w):
    params = jax_params(w)
    x = contexts(w, 130)
    ref = np.asarray(j_fc.fc_forward_pallas(params, x, w, interpret=True))
    ws, bs = layers(params, torch.bfloat16)
    got = split_tf32_chain(torch.from_numpy(x), ws, bs)
    assert rel_err(got.numpy().reshape(ref.shape), ref) <= TOL


def test_tf32_round():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(0, 1e3, 4096).astype(np.float32))
    r = t_fc.tf32_round(x)
    assert r.dtype == torch.float32
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((r - x).abs() <= x.abs() * 2.0 ** -11).all()
    # Nearest, ties away from zero (as cvt.rna.tf32.f32).
    one = 1.0 + 2.0 ** -11                 # halfway between two TF32 values
    t = torch.tensor([one, -one, 1.0 + 2.0 ** -12, 3.0], dtype=torch.float32)
    assert t_fc.tf32_round(t).tolist() == [1.0 + 2.0 ** -10,
                                           -(1.0 + 2.0 ** -10), 1.0, 3.0]


def test_prepare_weight_splits_and_caches():
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.normal(0, 0.03, (320, 1200)).astype(np.float32))
    hi, lo = t_fc.prepare_weight(w)
    assert hi.shape == lo.shape == (1200, 320)
    assert hi.dtype == lo.dtype == torch.float32
    assert hi.is_contiguous() and lo.is_contiguous()
    for t in (hi, lo):
        assert (t.view(torch.int32) & 0x1FFF).eq(0).all()
    wt = w.T.double()
    assert ((hi.double() + lo.double() - wt).abs()
            <= wt.abs() * 2.0 ** -22).all()
    # Made once per tensor, again after an in-place change.
    assert all(a is b for a, b in zip(t_fc.prepare_weight(w), (hi, lo)))
    w.mul_(2)
    hi2, lo2 = t_fc.prepare_weight(w)
    assert hi2 is not hi and torch.equal(hi2, 2 * hi)
    # bfloat16 weights are exact in TF32: hi is the widened transpose, no lo.
    wb = w.to(torch.bfloat16)
    hb, lb = t_fc.prepare_weight(wb)
    assert lb is None and torch.equal(hb, wb.T.float())


@pytest.mark.parametrize("n,k,d,want", [
    (1024, 1200, 1200, (192, 1)), (2048, 1200, 1200, (192, 1)),
    (1024, 320, 1200, (192, 1)), (1024, 80, 1200, (192, 1)),
    (256, 1200, 1200, (64, 3)), (256, 320, 1200, (64, 1)),
    (1024, 1200, 64, (32, 6)), (1024, 1200, 16, (32, 6)),
    (2048, 1200, 64, (32, 4)), (7, 1200, 1200, (32, 6)),
    (1, 80, 1200, (32, 1))])
def test_plan_at_the_path_shapes(n, k, d, want):
    assert t_fc.plan(n, k, d, 132) == want
    assert t_fc.plan(n, k, d, 132, split_w=False) == want


@pytest.mark.parametrize("n", [1, 7, 64, 65, 200, 1024, 5000])
@pytest.mark.parametrize("k,d", [(80, 1200), (320, 1200), (1200, 1200),
                                 (1200, 16), (1200, 64), (4, 3)])
def test_plan_is_valid(n, k, d):
    bn, splits = t_fc.plan(n, k, d, 132)
    assert bn in t_fc.TILE_COLUMNS and 1 <= splits <= t_fc.MAX_SPLITS
    stages = -(-k // t_fc.TILE_DEPTH)
    # Every split owns at least one stage of K.
    assert (splits - 1) * -(-stages // splits) < stages
