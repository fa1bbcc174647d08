"""The port's IPFCN-S baseline and PNN visualization against the JAX
package's, on the CPU.

IPFCN-S (`models/ipfcn.py`): the line-group extraction and preprocessing
exactly equal; `forward` within 1e-5 of max |JAX| (float32 products in
another order) on JAX-initialised and on port-initialised weights;
`predict_uint8` equal to JAX's except at pixels whose value before
rounding is within 1e-3 of a .5 tie; the schema-less caffemodel reader on
protobuf bytes built here (packed and unpacked floats, packed and
unpacked shape dims, legacy num/channels/height/width blobs, unknown
fields) equal to JAX's; `compare_on_channels(ipfcn_params=...)` rows
within 0.01 dB of JAX's.  The shipped caffemodel is not in the
repository, so no real-weight check runs.

Visualization (`models/visualization.py`): arrangements and filter grids
equal to JAX's; the PNG is written where matplotlib is installed.
"""

import os
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from context_adaptive_neural_network_based_prediction_tpu.evaluation import (
    prediction_comparison as j_pc)
from context_adaptive_neural_network_based_prediction_tpu.models import (
    ipfcn as j_ipfcn, visualization as j_vis, zoo as j_zoo)
from context_adaptive_neural_network_based_prediction_tpu_torch.evaluation import (
    prediction_comparison as t_pc)
from context_adaptive_neural_network_based_prediction_tpu_torch.models import (
    ipfcn as t_ipfcn, visualization as t_vis, zoo as t_zoo)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME = np.load(os.path.join(REPO, "tests", "golden_hm",
                             "128_full_q32_src.npy"))
MEAN = 86.8568
WIDTHS = [4, 8, 16]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def j_params(w, seed=0):
    return {k: np.asarray(v) for k, v in
            j_ipfcn.init_params(jax.random.PRNGKey(seed), w).items()}


def groups(w, n, seed, pair=False):
    rng = np.random.default_rng(seed)
    ch = rng.integers(0, 256, (2 * w + 20, 2 * w + 24, 2 if pair else 1),
                      dtype=np.uint8)
    out = [t_ipfcn.extract_pair_groups_lines_from_channel(
        ch, w, int(r), int(c))
        for r, c in zip(rng.integers(0, 13, n), rng.integers(0, 17, n))]
    return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])


@pytest.mark.parametrize("pair", [False, True], ids=["single", "pair"])
@pytest.mark.parametrize("w", WIDTHS)
def test_extraction_and_preprocessing_are_exact(w, pair):
    rng = np.random.default_rng(w)
    ch = rng.integers(0, 256, (2 * w + 20, 2 * w + 24, 2 if pair else 1),
                      dtype=np.uint8)
    for r, c in ((0, 0), (12, 16), (5, 3)):
        got = t_ipfcn.extract_pair_groups_lines_from_channel(ch, w, r, c)
        want = j_ipfcn.extract_pair_groups_lines_from_channel(ch, w, r, c)
        assert got[0].shape == (8, 2 * w + 8, 1) and got[1].shape == (2 * w,
                                                                      8, 1)
        assert all(np.array_equal(g, x) for g, x in zip(got, want))
    for r, c in ((13, 0), (0, 17), (-1, 0)):
        with pytest.raises(ValueError, match="bounds"):
            t_ipfcn.extract_pair_groups_lines_from_channel(ch, w, r, c)
    with pytest.raises(TypeError):
        t_ipfcn.extract_pair_groups_lines_from_channel(
            ch.astype(np.int32), w, 0, 0)
    ga, gl = groups(w, 9, w + 1, pair)
    flat_t, means_t = t_ipfcn.preprocess_pair_groups(ga, gl)
    flat_j, means_j = j_ipfcn.preprocess_pair_groups(ga, gl)
    assert flat_t.shape == (9, 32 * w + 64)
    assert np.array_equal(flat_t, flat_j) and np.array_equal(means_t, means_j)


@pytest.mark.parametrize("init", ["jax", "port"])
@pytest.mark.parametrize("w", WIDTHS)
def test_forward_and_predict_match_jax(w, init):
    params = (j_params(w, w) if init == "jax"
              else t_ipfcn.init_params(torch.Generator().manual_seed(w), w))
    ga, gl = groups(w, 64, 3 * w)
    flat, means = t_ipfcn.preprocess_pair_groups(ga, gl)
    want = np.asarray(j_ipfcn.forward({k: jnp.asarray(v) for k, v in
                                       params.items()}, jnp.asarray(flat), w))
    got = t_ipfcn.forward(t_ipfcn.params_to_device(params, "cpu"),
                          torch.from_numpy(flat), w).numpy()
    assert got.shape == want.shape == (64, w, w, 1)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    p_t = t_ipfcn.predict_uint8(params, ga, gl, w, device="cpu")
    p_j = j_ipfcn.predict_uint8({k: jnp.asarray(v) for k, v in
                                 params.items()}, ga, gl, w)
    assert p_t.dtype == np.uint8 and p_t.shape == (64, w, w)
    value = want[..., 0] + means[:, None, None]
    near_tie = np.abs(value - np.floor(value) - 0.5) < 1e-3
    assert np.array_equal(p_t[~near_tie], p_j[~near_tie])
    assert np.abs(p_t.astype(int) - p_j).max() <= 1


def test_init_params_shapes_and_constants():
    for w in WIDTHS:
        got = t_ipfcn.init_params(torch.Generator().manual_seed(0), w)
        want = j_params(w)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].shape == want[k].shape, k
            assert got[k].dtype == np.float32, k
            if k.startswith("prelu"):
                assert np.all(got[k] == 0.25)
            elif k.endswith("biases"):
                assert not got[k].any()
            else:
                sd = 1 / np.sqrt(want[k].shape[0])
                assert abs(got[k].std() / sd - 1) <= 0.05, k


# --------------------------------------------------------- caffemodel ----

def varint(v):
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def field(num, wt, payload):
    key = varint((num << 3) | wt)
    if wt == 0:
        return key + varint(payload)
    if wt == 2:
        return key + varint(len(payload)) + payload
    return key + payload            # wire types 1 and 5: fixed width


def blob(arr, style):
    """A BlobProto of `arr` in one of the encodings a caffemodel may use
    (unpacked floats only for the small blobs: the reader walks them one
    field at a time)."""
    arr = np.asarray(arr, np.float32)
    packed = field(5, 2, arr.astype("<f4").tobytes())
    dims = b"".join(field(1, 0, d) for d in arr.shape)
    if style == "packed_dims":
        return field(7, 2, field(1, 2, b"".join(varint(d)
                                               for d in arr.shape))) + packed
    if style == "legacy":           # num, channels, height, width
        legacy = (1,) * (4 - arr.ndim) + arr.shape
        return b"".join(field(i + 1, 0, d)
                        for i, d in enumerate(legacy)) + packed
    if style == "unpacked" and arr.size <= 4096:
        return field(7, 2, dims) + b"".join(
            field(5, 5, struct.pack("<f", x)) for x in arr.ravel())
    return field(7, 2, dims) + packed


def caffemodel_bytes(params, styles):
    """A NetParameter with fc1..fc4 (InnerProduct, (out, in) weights) and
    relu1..relu3 (PReLU) layers, plus fields a reader must skip."""
    out = field(1, 2, b"IntraFCN") + field(2, 1, b"\0" * 8)
    for i in range(1, 5):
        w = params[f"fc{i}_weights"].T
        style = styles[(i - 1) % len(styles)]
        if style == "legacy":
            w = w[None, None]
        layer = (field(1, 2, f"fc{i}".encode()) + field(2, 2, b"InnerProduct")
                 + field(7, 2, blob(w, style))
                 + field(7, 2, blob(params[f"fc{i}_biases"], style))
                 + field(6, 0, 3))
        out += field(100, 2, layer)
        if i < 4:
            out += field(100, 2, field(1, 2, f"relu{i}".encode())
                         + field(2, 2, b"PReLU")
                         + field(7, 2, blob(params[f"prelu{i}_slopes"],
                                            style)))
    return out + field(3, 5, b"\0" * 4)


@pytest.mark.parametrize("styles", [("packed",), ("unpacked",),
                                    ("packed_dims", "legacy", "packed")],
                         ids=["packed", "unpacked", "mixed"])
def test_caffemodel_reader_matches_jax(tmp_path, styles):
    w = 4
    params = j_params(w, 7)
    path = str(tmp_path / "m.caffemodel")
    with open(path, "wb") as f:
        f.write(caffemodel_bytes(params, styles))
    got, want = t_ipfcn.parse_caffemodel(path), j_ipfcn.parse_caffemodel(path)
    assert got.keys() == want.keys() == {f"fc{i}" for i in range(1, 5)} \
        | {f"relu{i}" for i in range(1, 4)}
    for k in want:
        assert got[k][0] == want[k][0]
        assert len(got[k][1]) == len(want[k][1])
        for a, b in zip(got[k][1], want[k][1]):
            assert a.shape == b.shape and np.array_equal(a, b), k
    imported = t_ipfcn.import_caffemodel(path)
    ref = {k: np.asarray(v) for k, v in j_ipfcn.import_caffemodel(path).items()}
    assert imported.keys() == ref.keys() == params.keys()
    for k in ref:
        assert np.array_equal(imported[k], ref[k])
        assert np.array_equal(imported[k], params[k])
    npz = str(tmp_path / "m.npz")
    t_ipfcn.convert_caffemodel_to_npz(path, npz)
    loaded = t_ipfcn.load_npz_params(npz)
    assert all(np.array_equal(loaded[k], params[k]) for k in params)
    with pytest.raises(ValueError, match="wire type"):
        list(t_ipfcn._walk_protobuf(field(1, 3, b"")))


def test_caffemodel_refuses_a_wrong_layer_type(tmp_path):
    params = j_params(4)
    data = caffemodel_bytes(params, ("packed",)).replace(b"InnerProduct",
                                                         b"Convolution_")
    path = str(tmp_path / "bad.caffemodel")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match="expected InnerProduct"):
        t_ipfcn.import_caffemodel(path)


@pytest.mark.parametrize("name", ["pnn_w4_fc_single", "pnn_w8_refconv_single",
                                  "pnn_w16_single"])
def test_compare_on_channels_with_ipfcn_matches_jax(name):
    w = int(name.split("_")[1][1:])
    path = os.path.join(REPO, "artifacts", "frozen", name + ".npz")
    jp, is_fc = j_zoo.load_frozen_params(path)
    tp, _ = t_zoo.load_frozen_params(path)
    ip = j_params(w, 11)
    ch = FRAME[None, :, :, None]
    ref = j_pc.compare_on_channels(ch, w, jp, is_fc, MEAN,
                                   nb_positions_per_image=96, seed=2,
                                   ipfcn_params={k: jnp.asarray(v)
                                                 for k, v in ip.items()})
    got = t_pc.compare_on_channels(ch, w, tp, is_fc, MEAN,
                                   nb_positions_per_image=96, seed=2,
                                   ipfcn_params=ip, device="cpu")
    assert len(got) == len(ref) == 4
    for r, q in zip(got, ref):
        assert (r.width_mask_above, r.height_mask_left) == (
            q.width_mask_above, q.height_mask_left)
        assert q.mean_psnr_ipfcn is not None
        assert abs(r.mean_psnr_ipfcn - q.mean_psnr_ipfcn) <= 0.01
        assert abs(r.mean_psnr_pnn - q.mean_psnr_pnn) <= 0.01
        assert abs(r.mean_psnr_hevc_best - q.mean_psnr_hevc_best) <= 0.01
        assert abs(r.pnn_win_frequency - q.pnn_win_frequency) <= 2 / 96
    assert len({r.mean_psnr_ipfcn for r in got}) == 1


# --------------------------------------------------------- visualization ----

def test_arrangements_match_jax():
    rng = np.random.default_rng(0)
    for w in (4, 8):
        a = rng.integers(0, 256, (w, 3 * w, 1), dtype=np.uint8)
        l = rng.integers(0, 256, (2 * w, w, 1), dtype=np.uint8)
        t = rng.integers(0, 256, (w, w), dtype=np.uint8)
        for args in ((a, l), (a, l, t), (a[..., 0].astype(np.float32) - MEAN,
                                          l.astype(np.float32) - MEAN, None,
                                          MEAN)):
            got = t_vis.arrange_context_portions(*args)
            assert got.dtype == np.uint8 and got.shape == (3 * w, 3 * w)
            assert np.array_equal(got, j_vis.arrange_context_portions(*args))


@pytest.mark.parametrize("name", ["pnn_w8_fc_single", "pnn_w16_single"])
def test_filter_grids_match_jax(name, tmp_path):
    path = os.path.join(REPO, "artifacts", "frozen", name + ".npz")
    params, is_fc = t_zoo.load_frozen_params(path)
    jparams, _ = j_zoo.load_frozen_params(path)
    if is_fc:
        got = t_vis.fc_first_layer_filters(params, 8)
        want = j_vis.fc_first_layer_filters(jparams, 8)
        assert got.shape == (1200, 24, 24)
    else:
        got = t_vis.conv_first_layer_filters(params, "branch_left")
        want = j_vis.conv_first_layer_filters(jparams, "branch_left")
        assert got.shape == (64, 5, 5)
    assert np.array_equal(got, want, equal_nan=True)
    pytest.importorskip("matplotlib")
    png = str(tmp_path / "grid" / "f.png")
    t_vis.plot_filter_grid(got, png, max_filters=16, title=name)
    assert os.path.getsize(png) > 0
    arr = str(tmp_path / "arr.png")
    t_vis.save_context_arrangement(arr, np.zeros((8, 24)), np.zeros((16, 8)),
                                   mean_training=MEAN, enlargement=2)
    assert os.path.getsize(arr) > 0
