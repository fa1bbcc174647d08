"""The port's integer merger (plain version) against the JAX package's,
with zero tolerance.

`merger_int.merger_plain` and the wrapper `merger_int_forward` (CPU
tensors take the plain version) equal the JAX package's TPU kernel
`merger_int_forward` run in interpret mode and the XLA integer dot of
`pnn_q.forward_q`, for the codec's map counts M = 32, 64, 128, 256 and
slot counts N = 1, 17, 31 (P = 80, O = 16): on random inputs within the
quantized PNN's caps, and on inputs at the frozen models' caps with every
product of one sign and the bias at the freeze-time limit 2^30, where an
int32 wrap would show.  The CUDA kernel is held against the plain version
in `tests/test_torch_cuda.py`.
"""

import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from context_adaptive_neural_network_based_prediction_tpu.models import (
    pnn_q as j_pnn_q)
from context_adaptive_neural_network_based_prediction_tpu.ops.pallas import (
    merger_int as j_merger_int)
from context_adaptive_neural_network_based_prediction_tpu_torch.ops import (
    merger_int as t_merger_int)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAPS = (32, 64, 128, 256)
SLOTS = (1, 17, 31)
P, O = 80, 16


def frozen_caps():
    """The largest merger input cap and weight magnitude of the frozen
    zoo's conv models."""
    act, wmax = 0, 0
    for path in glob.glob(os.path.join(REPO, "artifacts", "frozen",
                                       "qpnn_*.npz")):
        q = j_pnn_q.load_quantized(path)
        if q["kind"] == "conv":
            act = max(act, int(q["merge_cap"]))
            wmax = max(wmax, int(np.abs(q["merger/w"]).max()))
    return act, wmax


def inputs(m, n, extreme):
    """(x (N, P, M) int16, w (M, P, O) int16, b (M, O) int32), the JAX
    package's layout."""
    rng = np.random.default_rng(1000 * m + n)
    if extreme:
        act, wmax = frozen_caps()
        sign = np.where(np.arange(n) % 2, -1, 1)[:, None, None]
        x = np.broadcast_to(act * sign, (n, P, m))
        w = np.full((m, P, O), wmax)
        b = np.where(np.arange(O)[None, :] % 2, -(1 << 30), 1 << 30)
        b = np.broadcast_to(b, (m, O))
    else:
        x = rng.integers(-2047, 2048, (n, P, m))
        w = rng.integers(-511, 512, (m, P, O))
        b = rng.integers(-(1 << 30), 1 << 30, (m, O))
    return [np.ascontiguousarray(a, dtype=t) for a, t in
            ((x, np.int16), (w, np.int16), (b, np.int32))]


def port(x, w, b):
    """The port's wrapper on CPU tensors, weights laid out as
    `params_from_numpy` lays them: (P, O, M) and (O, M)."""
    return t_merger_int.merger_int_forward(
        torch.from_numpy(x),
        torch.from_numpy(np.ascontiguousarray(w.transpose(1, 2, 0))),
        torch.from_numpy(np.ascontiguousarray(b.T))).numpy()


def xla_dot(x, w, b):
    """The integer dot of `pnn_q.forward_q` (its default merger path)."""
    acc = jax.lax.dot_general(
        jnp.asarray(x).transpose(2, 0, 1), jnp.asarray(w),
        (((2,), (1,)), ((0,), (0,))), preferred_element_type=jnp.int32)
    return np.asarray(acc + jnp.asarray(b)[:, None, :])


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("n", SLOTS)
@pytest.mark.parametrize("m", MAPS)
def test_merger_matches_jax(m, n, extreme):
    x, w, b = inputs(m, n, extreme)
    got = port(x, w, b)
    assert got.dtype == np.int32 and got.shape == (m, n, O)
    want = np.asarray(j_merger_int.merger_int_forward(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, xla_dot(x, w, b))
    # The exact integer result (int64): no int32 wrap anywhere.
    exact = np.einsum("npm,mpo->mno", x.astype(np.int64),
                      w.astype(np.int64)) + b.astype(np.int64)[:, None, :]
    np.testing.assert_array_equal(got.astype(np.int64), exact)
    if extreme:
        assert np.abs(exact).max() > 1 << 30


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    x, w, b = inputs(64, 31, False)

    def no_kernel(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel")

    monkeypatch.setattr(t_merger_int, "_kernel", no_kernel)
    t_merger_int.reset_launch_counts()
    xt = torch.from_numpy(x)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(1, 2, 0)))
    bt = torch.from_numpy(np.ascontiguousarray(b.T))
    a = t_merger_int.merger_int_forward(xt, wt, bt)
    c = t_merger_int.merger_plain(xt, wt, bt)
    assert torch.equal(a, c)
    assert t_merger_int.launches == {}
    with pytest.raises(ValueError, match="impl"):
        t_merger_int.merger_int_forward(xt, wt, bt, impl="fast")


def test_kernel_wrapper_checks_its_inputs():
    x, w, b = inputs(32, 1, False)
    xt = torch.from_numpy(x)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(1, 2, 0)))
    with pytest.raises(ValueError, match="want contiguous"):
        t_merger_int._check("w", wt.to(torch.int32), (P, O, 32),
                            torch.int16, xt.device)
    with pytest.raises(ValueError, match="want contiguous"):
        t_merger_int._check("w", wt.transpose(0, 1), (P, O, 32),
                            torch.int16, xt.device)
