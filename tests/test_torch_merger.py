"""The port's float channelwise merger (plain version) against the JAX
package's.

`pnn.channelwise_fc_merger` of the port (through `merger.merger_forward`,
whose CPU tensors take `merger_plain`) against the normative
`pnn.channelwise_fc_merger` (+ `leaky_relu`) with float32 weights, and
`merger.merger_plain` with bfloat16 weights against the JAX package's TPU
kernel `merger_forward` run in interpret mode.  Tolerance: 1e-5 of max
|reference| (float32 sums of 80 products in another order).  Shapes of the
conv PNN at widths 4 and 8 (refconv), 16 and 32 (M = 32, 64, 128, 256; P =
80, O = 16), batches 1, 5, 130, with and without the activation.  The CUDA
kernel is held against the plain version in `tests/test_torch_cuda.py`.
"""

import numpy as np
import pytest
import torch

from context_adaptive_neural_network_based_prediction_tpu.models import (
    pnn as j_pnn)
from context_adaptive_neural_network_based_prediction_tpu.ops.pallas import (
    merger as j_merger)
from context_adaptive_neural_network_based_prediction_tpu_torch.models import (
    pnn as t_pnn)
from context_adaptive_neural_network_based_prediction_tpu_torch.ops import (
    merger as t_merger)

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def data(w, batch, seed):
    """Branch features and merger weights of the conv PNN at width w, the
    JAX package's layout: weights (M, P, O), biases (M, O)."""
    strides = j_pnn.STRIDES_BRANCH[w]
    prod = int(np.prod(strides))
    m = 32 * prod
    side = w // prod
    rng = np.random.default_rng(seed)
    x0 = rng.normal(0, 1, (batch, side, 3 * side, m)).astype(np.float32)
    x1 = rng.normal(0, 1, (batch, 2 * side, side, m)).astype(np.float32)
    wgt = rng.normal(0, 0.1, (m, 5 * side * side, side * side)).astype(
        np.float32)
    b = rng.normal(0, 0.1, (m, side * side)).astype(np.float32)
    return wgt, b, x0, x1, side


def port_weights(wgt, b, dtype=torch.float32):
    """(P, O, M) weights and (O, M) biases, as `zoo.params_from_numpy`
    lays them out."""
    return (torch.from_numpy(np.ascontiguousarray(wgt.transpose(1, 2, 0))
                             ).to(dtype),
            torch.from_numpy(np.ascontiguousarray(b.T)))


def rel_err(got, ref):
    return np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("batch", [1, 5, 130])
@pytest.mark.parametrize("w", [4, 8, 16, 32])
def test_merger_matches_jax(w, batch, act):
    wgt, b, x0, x1, side = data(w, batch, seed=w + batch)
    ref = j_pnn.channelwise_fc_merger(wgt, b, x0, x1, side, side)
    ref = np.asarray(j_pnn.leaky_relu(ref) if act else ref)
    tw, tb = port_weights(wgt, b)
    got = t_pnn.channelwise_fc_merger(tw, tb, torch.from_numpy(x0),
                                      torch.from_numpy(x1), side, side,
                                      act=act)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert rel_err(got.numpy(), ref) <= TOL

    # bf16 weight storage: the TPU kernel's semantics.
    ref = np.asarray(j_merger.merger_forward(wgt, b, x0, x1, side, side,
                                             apply_act=act, interpret=True))
    tw, tb = port_weights(wgt, b, torch.bfloat16)
    m = x0.shape[3]
    xc = torch.from_numpy(np.concatenate(
        [x0.reshape(batch, -1, m), x1.reshape(batch, -1, m)], axis=1))
    got = t_merger.merger_plain(xc, tw, tb, act)
    assert got.shape == (batch, side * side, m)
    assert rel_err(got.numpy().reshape(ref.shape), ref) <= TOL


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel")

    monkeypatch.setattr(t_merger, "_kernel", no_kernel)
    t_merger.reset_launch_counts()
    wgt, b, x0, x1, side = data(16, 7, seed=0)
    tw, tb = port_weights(wgt, b)
    xc = torch.from_numpy(np.concatenate(
        [x0.reshape(7, -1, 128), x1.reshape(7, -1, 128)], axis=1))
    for act in (False, True):
        assert torch.equal(t_merger.merger_forward(xc, tw, tb, act=act),
                           t_merger.merger_plain(xc, tw, tb, act))
    assert t_merger.launches == {}
    with pytest.raises(ValueError, match="impl"):
        t_merger.merger_forward(xc, tw, tb, impl="fast")


def test_kernel_wrapper_checks_its_inputs():
    # The checks run before the kernel is built or launched.
    wgt, b, x0, x1, _ = data(4, 2, seed=1)
    tw, tb = port_weights(wgt, b)
    xc = torch.from_numpy(np.concatenate(
        [x0.reshape(2, -1, 32), x1.reshape(2, -1, 32)], axis=1))
    for args in ((xc, tw.to(torch.float16), tb),           # weight type
                 (xc, tw, tb.double()),                    # bias type
                 (xc, tw[:, :, :16], tb),                  # shape, layout
                 (xc[:, :40], tw, tb)):                    # positions
        with pytest.raises(ValueError, match="want contiguous"):
            t_merger._kernel(*args, act=False)
    # The kernel stages its weight panel in 16-byte copies: M % 8 == 0.
    with pytest.raises(ValueError, match="M % 8"):
        t_merger._kernel(xc[:, :, :20].contiguous(),
                         tw[:, :, :20].contiguous(), tb[:, :20].contiguous(),
                         act=False)
