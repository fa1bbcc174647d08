"""The port's float PNN forward against the JAX package's.

`zoo.params_from_numpy` + `pnn.forward` of the port (on the CPU: the FC
and merger kernels' plain versions, `F.conv2d` / `F.conv_transpose2d`)
against the JAX package's `pnn.forward`, on every float single in
`artifacts/frozen/` (FC at widths 4 and 8, conv at 4 and 8 "refconv", 16,
32 and 64) and on a JAX `init_params` net per width, within 1e-4 of max
|reference| (float32 sums in another order).  `predict_uint8` may move a
pixel at a rounding tie: at most 1 apart, in at most 1% of the pixels.
Inputs: seeded mean-subtracted contexts with a random mask per example.
The JAX reference runs under `jax.jit` (one compile per shape instead of
one per operation, to stay inside the test's time).  Also the layout
`params_from_numpy` gives, the loaders, and the TF-SAME transpose
convolution against the JAX package's vjp form.
"""

import glob
import os

import numpy as np
import pytest
import torch

import jax

from context_adaptive_neural_network_based_prediction_tpu.models import (
    importer as j_importer, pnn as j_pnn, zoo as j_zoo)
from context_adaptive_neural_network_based_prediction_tpu_torch.models import (
    importer as t_importer, pnn as t_pnn, zoo as t_zoo)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SINGLES = sorted(os.path.basename(p)[:-4] for p in glob.glob(
    os.path.join(REPO, "artifacts", "frozen", "pnn_*_single.npz")))
TOL = 1e-4
MEAN = 86.8568
j_forward = jax.jit(j_pnn.forward, static_argnums=(2, 3))
j_predict_uint8 = jax.jit(j_pnn.predict_uint8, static_argnums=(2, 3, 4))
j_init_params = jax.jit(j_pnn.init_params, static_argnums=(1, 2))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def width_of(name):
    return int(name.split("_")[1][1:])


def contexts(w, n, seed, is_fc):
    """n seeded contexts (pixels 0..255 minus the mean, a random mask per
    example), as numpy."""
    rng = np.random.default_rng(seed)
    above = rng.integers(0, 256, (n, w, 3 * w, 1)).astype(np.float32) - MEAN
    left = rng.integers(0, 256, (n, 2 * w, w, 1)).astype(np.float32) - MEAN
    wa = rng.choice(np.arange(0, w + 1, 4), n)[:, None, None, None]
    hl = rng.choice(np.arange(0, w + 1, 4), n)[:, None, None, None]
    above = np.where(np.arange(3 * w)[None, None, :, None] >= 3 * w - wa,
                     0.0, above).astype(np.float32)
    left = np.where(np.arange(2 * w)[None, :, None, None] >= 2 * w - hl,
                    0.0, left).astype(np.float32)
    if is_fc:
        return np.concatenate([above.reshape(n, -1), left.reshape(n, -1)], 1)
    return above, left


def to_torch(inputs):
    if isinstance(inputs, tuple):
        return tuple(torch.from_numpy(a) for a in inputs)
    return torch.from_numpy(inputs)


def check(params, w, is_fc, n, seed):
    inputs = contexts(w, n, seed, is_fc)
    ref = np.asarray(j_forward(params, inputs, w, is_fc))
    tp = t_zoo.params_from_numpy(params, "cpu")
    got = t_pnn.forward(tp, to_torch(inputs), w, is_fc)
    assert got.shape == ref.shape and got.dtype == torch.float32
    err = np.abs(got.numpy().astype(np.float64) - ref).max()
    assert err <= TOL * np.abs(ref).max(), err / np.abs(ref).max()

    ref_u8 = np.asarray(j_predict_uint8(params, inputs, w, is_fc, MEAN))
    got_u8 = t_pnn.predict_uint8(tp, to_torch(inputs), w, is_fc, MEAN)
    assert got_u8.dtype == torch.uint8 and got_u8.shape == ref_u8.shape
    diff = np.abs(got_u8.numpy().astype(np.int32) - ref_u8)
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01


def test_every_float_single_is_covered():
    assert [width_of(s) for s in SINGLES] == [16, 32, 4, 4, 64, 8, 8]


@pytest.mark.parametrize("name", SINGLES)
def test_frozen_singles_match_jax(name):
    w = width_of(name)
    path = os.path.join(REPO, "artifacts", "frozen", name + ".npz")
    params, is_fc = j_zoo.load_frozen_params(path)
    t_params, t_fc = t_zoo.load_frozen_params(path)
    assert t_fc == is_fc == ("_fc_" in name)
    check(t_params, w, is_fc, n=4 if w == 64 else 16, seed=w)
    # The JAX package loads the same arrays.
    ref, got = _flatten(params), _flatten(t_params)
    assert ref.keys() == got.keys()
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(v), got[k])


def _flatten(p, prefix=()):
    out = {}
    for k, v in p.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


@pytest.mark.parametrize("w,is_fc", [(4, True), (8, True), (16, False),
                                     (32, False), (64, False)])
def test_init_params_nets_match_jax(w, is_fc):
    params = jax.tree_util.tree_map(
        np.asarray, j_init_params(jax.random.PRNGKey(7 + w), w, is_fc))
    rng = np.random.default_rng(w)
    for path, v in _flatten(params).items():      # nonzero biases
        if path[-1].startswith("biases"):
            node = params
            for k in path[:-1]:
                node = node[k]
            node[path[-1]] = rng.normal(0, 0.1, v.shape).astype(np.float32)
    check(params, w, is_fc, n=3 if w == 64 else 9, seed=100 + w)


def test_params_layout():
    path = os.path.join(REPO, "artifacts", "frozen", "pnn_w16_single.npz")
    params, _ = t_zoo.load_frozen_params(path)
    tp = t_zoo.params_from_numpy(params, "cpu",
                                 torch.bfloat16)["convolutional"]
    conv = tp["branch_above"]["convolution_2"]["weights"]
    assert conv.shape == (128, 64, 5, 5) and conv.dtype == torch.float32
    tconv = tp["merger"]["transpose_convolution_1"]["weights"]
    assert tconv.shape == (128, 64, 5, 5)           # (in, out, k, k)
    cm = tp["merger"]["channelwise_fully_connected_merger"]
    assert cm["weights"].shape == (80, 16, 128)
    assert cm["weights"].dtype == torch.bfloat16
    assert cm["biases"].shape == (16, 128) and cm["biases"].dtype == \
        torch.float32
    src = params["convolutional"]["merger"][
        "channelwise_fully_connected_merger"]["weights"]
    assert torch.equal(cm["weights"][:, :, 5],
                       torch.from_numpy(src[5]).to(torch.bfloat16))
    with pytest.raises(ValueError, match="weight_dtype"):
        t_zoo.params_from_numpy(params, "cpu", torch.float16)


@pytest.mark.parametrize("size,stride,k", [(8, 2, 5), (12, 1, 3), (4, 2, 5),
                                           (6, 2, 3), (5, 1, 3)])
def test_conv_transpose_is_the_vjp(size, stride, k):
    rng = np.random.default_rng(size * 10 + stride)
    y = rng.normal(0, 1, (2, size, size + 1, 3)).astype(np.float32)
    wt = rng.normal(0, 1, (k, k, 4, 3)).astype(np.float32)    # (k, k, out, in)
    ref = np.asarray(j_pnn.conv2d_transpose_same(y, wt, stride))
    got = t_pnn.conv2d_transpose_same(
        torch.from_numpy(y).permute(0, 3, 1, 2),
        torch.from_numpy(np.ascontiguousarray(wt.transpose(3, 2, 0, 1))),
        stride).permute(0, 2, 3, 1)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_importer_matches_jax(tmp_path):
    path = os.path.join(REPO, "artifacts", "frozen",
                        "pnn_w8_refconv_single.npz")
    ref = _flatten(j_importer.load_npz_params(path))
    got = _flatten(t_importer.load_npz_params(path))
    assert ref.keys() == got.keys()
    for k in ref:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]))
    with pytest.raises(NotImplementedError, match="npz"):
        t_importer.import_tf_checkpoint(str(tmp_path / "model.ckpt"))


def test_predict_by_batch_chunks():
    path = os.path.join(REPO, "artifacts", "frozen",
                        "pnn_w4_refconv_single.npz")
    params, is_fc = t_zoo.load_frozen_params(path)
    tp = t_zoo.params_from_numpy(params, "cpu")
    inputs = contexts(4, 10, 3, is_fc)
    whole = t_zoo.predict_by_batch(tp, inputs, 4, is_fc)
    chunked = t_zoo.predict_by_batch(tp, inputs, 4, is_fc, batch_size=3)
    ref = np.asarray(j_zoo.predict_by_batch(params, inputs, 4, is_fc,
                                            batch_size=3))
    assert isinstance(whole, np.ndarray) and whole.shape == (10, 4, 4, 1)
    np.testing.assert_allclose(chunked, whole, rtol=1e-6, atol=1e-5)
    assert np.abs(whole - ref).max() <= TOL * np.abs(ref).max()
