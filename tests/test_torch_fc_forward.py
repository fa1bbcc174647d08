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
"""

import numpy as np
import pytest
import torch

import jax

from context_adaptive_neural_network_based_prediction_tpu.models import (
    pnn as j_pnn)
from context_adaptive_neural_network_based_prediction_tpu.ops.pallas import (
    fc_forward as j_fc)
from context_adaptive_neural_network_based_prediction_tpu_torch.models import (
    pnn as t_pnn, zoo as t_zoo)
from context_adaptive_neural_network_based_prediction_tpu_torch.ops import (
    fc_forward as t_fc)

TOL = 1e-4


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
