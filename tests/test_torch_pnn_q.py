"""The port's quantized PNN forward against the JAX package's, with zero
tolerance.

`forward_q` (float32 output, compared bit for bit) and `predict_pixels_q`
(int32 pixels) of the port equal the JAX package's on every frozen model
of the zoo (`artifacts/frozen/qpnn_*.npz`: FC and conv, widths 4-64, single
and pair) and on a random bundle the JAX package quantizes itself (as
`tests/test_wavefront_nn.py` builds it, plus an FC model), carried across
by `params_from_numpy`.  Contexts are seeded, mean-subtracted pixel
contexts with random strip masks, at batch 1 and batch 31, and extreme
contexts (flat, checkerboard, and far outside the pixel range, which
saturate the input quantizer and most layers); every requantised layer is
also driven to its cap on its own (`test_every_layer_at_its_cap`).  The JAX side
runs once per model on all contexts together (its integer forward gives
the same rows at any batch); the port runs each batch on its own.  The
port runs on the CPU, where the merger takes its plain version.
"""

import functools
import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from context_adaptive_neural_network_based_prediction_tpu.codec import (
    nn_intra as j_nn_intra)
from context_adaptive_neural_network_based_prediction_tpu.models import (
    pnn as j_pnn, pnn_q as j_pnn_q)
from context_adaptive_neural_network_based_prediction_tpu_torch.models import (
    pnn_q as t_pnn_q)
from context_adaptive_neural_network_based_prediction_tpu_torch.ops import (
    merger_int as t_merger_int)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FROZEN = sorted(os.path.basename(p) for p in glob.glob(
    os.path.join(REPO, "artifacts", "frozen", "qpnn_*.npz")))
MEAN = 86.85680942771248
N_EXTREME = 6
BATCHES = {"batch1": slice(0, 1), "batch31": slice(1, 32),
           "extreme": slice(32, 32 + N_EXTREME)}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def contexts(width, seed):
    """(above (B, w, 3w), left (2w, w)) float32 mean-subtracted contexts:
    1 + 31 random ones with random strip masks, then N_EXTREME extremes
    (flat 255 and 0, a 0/255 checkerboard, and three far outside the pixel
    range, which saturate the input quantizer)."""
    w = width
    rng = np.random.default_rng(seed)
    n_rand = 32
    base = rng.uniform(0, 255, (n_rand, 1, 1))
    yy, xx = np.mgrid[0:2 * w, 0:3 * w]
    patch = np.clip(base + rng.normal(0, 1, (n_rand, 1, 1)) * yy
                    + rng.normal(0, 1, (n_rand, 1, 1)) * xx
                    + rng.normal(0, rng.uniform(1, 40, (n_rand, 1, 1)),
                                 (n_rand, 2 * w, 3 * w)), 0, 255)
    patch = np.round(patch) - MEAN
    above = patch[:, :w, :].astype(np.float32)
    left = patch[:, :, :w].astype(np.float32)
    n_units = (2 * w) // 4
    for i in range(n_rand):
        ka, kl = rng.integers(0, n_units + 1, 2)
        if ka:
            above[i, :, 3 * w - 4 * ka:] = 0.0
        if kl:
            left[i, 2 * w - 4 * kl:, :] = 0.0
    checker = 255.0 * ((yy + xx) % 2) - MEAN
    sign = np.where((yy // 2 + xx // 3) % 2, 1.0, -1.0)
    ext = np.stack([np.full((2 * w, 3 * w), 255.0 - MEAN),
                    np.full((2 * w, 3 * w), -MEAN), checker,
                    1e5 * sign, -1e5 * sign, np.full((2 * w, 3 * w), 1e5)]
                   ).astype(np.float32)
    above = np.concatenate([above, ext[:, :w, :]])
    left = np.concatenate([left, ext[:, :, :w]])
    return above, left


def as_inputs(above, left, fc, mod):
    """The forward's inputs as torch tensors (mod torch) or JAX arrays."""
    b = above.shape[0]
    conv = mod.from_numpy if mod is torch else jnp.asarray
    if fc:
        return conv(np.concatenate([above.reshape(b, -1),
                                    left.reshape(b, -1)], axis=1))
    return conv(above[..., None].copy()), conv(left[..., None].copy())


def jax_run(q, above, left):
    """The JAX package's forward_q (compiled, on every context at once) and
    its predict_pixels_q run op by op on that forward, as its sequential
    decoder runs it.  (Compiled whole, XLA on the CPU contracts the last
    layer's multiply and the mean add into one fused multiply-add, which
    moves some pixels by 1; the op-by-op result is the normative one.)"""
    w = int(np.asarray(q["width"]))
    fc = str(np.asarray(q["kind"])) == "fc"
    inp = as_inputs(above, left, fc, jnp)
    fwd = jax.jit(lambda x: j_pnn_q.forward_q(q, x, w, fc))(inp)
    real = j_pnn_q.forward_q
    j_pnn_q.forward_q = lambda *a, **k: fwd
    try:
        pix = j_pnn_q.predict_pixels_q(q, inp, w, fc, MEAN)
    finally:
        j_pnn_q.forward_q = real
    return np.asarray(fwd), np.asarray(pix)


@functools.lru_cache(maxsize=None)
def random_models():
    """JAX-quantized random models: conv at widths 8 and 16 (the bundle of
    tests/test_wavefront_nn.py) and FC at width 4."""
    params = {8: j_pnn.init_params(jax.random.PRNGKey(1), 8, False),
              16: j_pnn.init_params(jax.random.PRNGKey(2), 16, False),
              4: j_pnn.init_params(jax.random.PRNGKey(3), 4, True)}
    arch = {8: False, 16: False, 4: True}
    bundle = j_nn_intra.PnnBundle(params, arch, 117.9).quantize(n_samples=48)
    return {f"random_w{w}": q for w, q in bundle.quantized.items()}


def model(name):
    if name.startswith("random_"):
        return random_models()[name]
    return j_pnn_q.load_quantized(os.path.join(REPO, "artifacts", "frozen",
                                               name))


MODELS = FROZEN + ["random_w4", "random_w8", "random_w16"]


@pytest.fixture(scope="module")
def results():
    """{model: {batch: (jax fwd, jax pix, port fwd, port pix)}}."""
    out = {}
    for k, name in enumerate(MODELS):
        q = model(name)
        w = int(np.asarray(q["width"]))
        fc = str(np.asarray(q["kind"])) == "fc"
        above, left = contexts(w, seed=k)
        j_fwd, j_pix = jax_run(q, above, left)
        tq = t_pnn_q.params_from_numpy(q, "cpu")
        out[name] = {}
        for batch, sl in BATCHES.items():
            inp = as_inputs(above[sl], left[sl], fc, torch)
            t_fwd = t_pnn_q.forward_q(tq, inp, w, fc).numpy()
            t_pix = t_pnn_q.predict_pixels_q(tq, inp, w, fc, MEAN).numpy()
            out[name][batch] = (j_fwd[sl], j_pix[sl], t_fwd, t_pix)
    return out


@pytest.mark.parametrize("batch", list(BATCHES))
@pytest.mark.parametrize("name", MODELS)
def test_forward_q_matches_jax(results, name, batch):
    j_fwd, _, t_fwd, _ = results[name][batch]
    assert t_fwd.dtype == np.float32 and t_fwd.shape == j_fwd.shape
    np.testing.assert_array_equal(t_fwd.view(np.int32), j_fwd.view(np.int32))


@pytest.mark.parametrize("batch", list(BATCHES))
@pytest.mark.parametrize("name", MODELS)
def test_predict_pixels_q_matches_jax(results, name, batch):
    _, j_pix, _, t_pix = results[name][batch]
    assert t_pix.dtype == np.int32 and t_pix.shape == j_pix.shape
    np.testing.assert_array_equal(t_pix, j_pix)


def requant_layers(q):
    """(multiplier key, cap key) of every requantised layer of a model."""
    out = []
    for k in q:
        name = k.rsplit("/", 1)[-1]
        if name.startswith(("m_", "t_m_")) or k == "merger/m":
            cap = k[:-len(name)] + name.replace("m", "c", 1)
            if cap in q:
                out.append((k, cap))
    return out


@pytest.mark.parametrize("name", MODELS)
def test_every_layer_at_its_cap(name):
    """Each requantised layer of the model, with its own multipliers and
    cap, on int32 accumulators that saturate it (up to +-2^31 - 1), and the
    input quantizer on contexts far outside the pixel range: the port's
    `_requant` and `_quant_in` equal the JAX package's, and reach the
    caps."""
    q = model(name)
    tq = t_pnn_q.params_from_numpy(q, "cpu")
    layers = requant_layers(q)
    assert len(layers) >= 3
    rng = np.random.default_rng(len(name))
    for mkey, ckey in layers:
        mult = np.asarray(q[mkey], np.float32)
        lim = float(np.asarray(q[ckey])) / float(np.abs(mult).min())
        acc = np.concatenate([
            rng.integers(-int(4 * lim), int(4 * lim) + 1, (64, mult.size)),
            np.full((1, mult.size), 2 ** 31 - 1),
            np.full((1, mult.size), -2 ** 31)]).astype(np.int32)
        if mkey == "merger/m":     # per map: (M, N, O) accumulators
            acc3 = acc.T[:, :, None]
            want = np.asarray(j_pnn_q._requant(
                jnp.asarray(acc3), jnp.asarray(mult)[:, None, None],
                q[ckey], leaky=True))
            got = t_pnn_q._requant(torch.from_numpy(acc3),
                                   tq[mkey][:, None, None], tq[ckey],
                                   leaky=True).numpy()
        else:
            want = np.asarray(j_pnn_q._requant(jnp.asarray(acc),
                                               jnp.asarray(mult), q[ckey],
                                               leaky=True))
            got = t_pnn_q._requant(torch.from_numpy(acc), tq[mkey],
                                   tq[ckey], leaky=True).numpy()
        np.testing.assert_array_equal(got, want, err_msg=mkey)
        cap = int(np.asarray(q[ckey]))
        assert got.max() == cap and got.min() == -cap, mkey
    x = np.concatenate([rng.uniform(-1e6, 1e6, 4096),
                        [3.4e38, -3.4e38, 0.0]]).astype(np.float32)
    want = np.asarray(j_pnn_q._quant_in(jnp.asarray(x), q["in_scale"],
                                        q["in_cap"]))
    got = t_pnn_q._quant_in(torch.from_numpy(x), tq["in_scale"],
                            tq["in_cap"]).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() == tq["in_cap"] and got.min() == -tq["in_cap"]


def test_zoo_is_complete():
    assert len(FROZEN) == 10
    kinds = {n: str(np.asarray(model(n)["kind"])) for n in FROZEN}
    assert set(kinds.values()) == {"fc", "conv"}


def test_merger_layout_for_the_kernel():
    """params_from_numpy lays the merger out as (P, O, M) int16 weights and
    (O, M) int32 biases, and the forward goes through merger_int_forward."""
    q = model("qpnn_w8_single.npz")
    tq = t_pnn_q.params_from_numpy(q, "cpu")
    np.testing.assert_array_equal(tq["merger/w"].numpy(),
                                  np.transpose(q["merger/w"], (1, 2, 0)))
    np.testing.assert_array_equal(tq["merger/b"].numpy(), q["merger/b"].T)
    assert tq["merger/w"].dtype == torch.int16
    assert tq["merger/b"].dtype == torch.int32
    above, left = contexts(8, seed=0)
    calls = []
    real = t_merger_int.merger_int_forward

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    t_merger_int.merger_int_forward = spy
    try:
        t_pnn_q.forward_q(tq, as_inputs(above[:3], left[:3], False, torch),
                          8, False)
    finally:
        t_merger_int.merger_int_forward = real
    assert calls == [(3, 80, 64)]


def test_quant_in_divides():
    """_quant_in divides by in_scale (x / s and x * (1 / s) differ in
    float32 for some x, and the JAX package divides)."""
    s = torch.tensor(0.3, dtype=torch.float32)
    x = torch.arange(-3000, 3000, dtype=torch.float32) * 0.37
    got = t_pnn_q._quant_in(x, s, 2047)
    want = torch.clamp(torch.round(x / s), -2047, 2047).to(torch.int16)
    assert torch.equal(got, want)
    assert not torch.equal(x / s, x * (1.0 / s))
