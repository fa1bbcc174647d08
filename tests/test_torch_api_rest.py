"""The port's counterparts of the JAX package's remaining public functions.

Each is held against the JAX package's function on seeded inputs, at zero
tolerance (every output is an integer or uint8):

* `ops/intra.pad_intra_pattern` and `predict_via_hevc_mode` (the port's
  on the CPU here) for w = 4, 8, 16, 32: every pattern size (h, w_ip) in
  [w + 1, 2w + 1]^2 for the padding; for the prediction, every size of
  each arm (each h with the full width, each width with the full height,
  and the square ones), all 35 modes;
* `ops/reference_samples.unit_grid_shape` and `build_reference_samples`
  at the frame's corners, on its edges and inside it, on a noisy and a
  smooth frame (where 32x32 strong smoothing fires), with four grids of
  coded units, `strong_intra_smoothing` on and off;
* `codec/cabac.estimate_bin_bits` over every state and bin;
* `utils/color.ycbcr_to_rgb` on seeded images and on every (Cb, Cr) pair
  at five luma levels, numpy in and a CPU tensor in;
* `models/pnn_q.save_quantized` on every `artifacts/frozen/qpnn_*.npz`,
  written by each package and read back by the other's `load_quantized`
  (every array equal in value, dtype and shape, `kind` equal), and on a
  model the port's `quantize_pnn` freezes.
"""

import glob
import os

import numpy as np
import pytest
import torch

from context_adaptive_neural_network_based_prediction_tpu.codec import (
    cabac as j_cabac)
from context_adaptive_neural_network_based_prediction_tpu.models import (
    pnn_q as j_pnn_q)
from context_adaptive_neural_network_based_prediction_tpu.ops import (
    intra as j_intra)
from context_adaptive_neural_network_based_prediction_tpu.ops import (
    reference_samples as j_rs)
from context_adaptive_neural_network_based_prediction_tpu.utils import (
    color as j_color)
from context_adaptive_neural_network_based_prediction_tpu_torch.codec import (
    cabac as t_cabac)
from context_adaptive_neural_network_based_prediction_tpu_torch.models import (
    pnn_q as t_pnn_q)
from context_adaptive_neural_network_based_prediction_tpu_torch.models import (
    zoo as t_zoo)
from context_adaptive_neural_network_based_prediction_tpu_torch.ops import (
    intra as t_intra)
from context_adaptive_neural_network_based_prediction_tpu_torch.ops import (
    reference_samples as t_rs)
from context_adaptive_neural_network_based_prediction_tpu_torch.utils import (
    color as t_color)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = [4, 8, 16, 32]
QMODELS = sorted(glob.glob(os.path.join(REPO, "artifacts", "frozen",
                                        "qpnn_*.npz")))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ------------------------------------------------------------- intra --

def pattern(rng, w, h_ip, w_ip, uint8_dims=3):
    pat = rng.integers(0, 256, (h_ip, w_ip, 1), dtype=np.uint8)
    return pat if uint8_dims == 3 else pat[..., 0]


@pytest.mark.parametrize("w", WIDTHS)
def test_pad_intra_pattern_matches_jax(w):
    rng = np.random.default_rng(w)
    for h_ip in range(w + 1, 2 * w + 2):
        for w_ip in range(w + 1, 2 * w + 2):
            pat = pattern(rng, w, h_ip, w_ip, 3 if (h_ip + w_ip) % 2 else 2)
            got = t_intra.pad_intra_pattern(pat, w)
            want = j_intra.pad_intra_pattern(pat, w)
            for g, e in zip(got, want):
                assert g.dtype == e.dtype and g.shape == (2 * w + 1,)
                np.testing.assert_array_equal(g, e)


@pytest.mark.parametrize("dims", [(3, 5), (5, 3), (10, 5), (5, 10)])
def test_pad_intra_pattern_refuses_bad_dims(dims):
    pat = np.zeros(dims + (1,), np.uint8)
    for fn in (t_intra.pad_intra_pattern, j_intra.pad_intra_pattern):
        with pytest.raises(ValueError, match="intra pattern dims"):
            fn(pat, 4)


def arm_sizes(w):
    """Every size of each arm: (s, 2w+1), (2w+1, s) and (s, s)."""
    full = 2 * w + 1
    out = []
    for s in range(w + 1, full + 1):
        out += [(s, full), (full, s), (s, s)]
    return sorted(set(out))


@pytest.mark.parametrize("mode", range(35))
@pytest.mark.parametrize("w", WIDTHS)
def test_predict_via_hevc_mode_matches_jax(w, mode):
    rng = np.random.default_rng(1000 * w + mode)
    for h_ip, w_ip in arm_sizes(w):
        pat = pattern(rng, w, h_ip, w_ip)
        got = t_intra.predict_via_hevc_mode(pat, w, mode, device="cpu")
        want = j_intra.predict_via_hevc_mode(pat, w, mode)
        assert got.dtype == np.uint8 and got.shape == (w, w, 1)
        np.testing.assert_array_equal(got, want,
                                      err_msg=f"pattern {h_ip}x{w_ip}")


def test_predict_via_hevc_mode_refuses_bad_modes():
    pat = np.zeros((9, 9, 1), np.uint8)
    for mode in (-1, 35):
        with pytest.raises(ValueError, match="mode must be in"):
            t_intra.predict_via_hevc_mode(pat, 4, mode, device="cpu")


# ------------------------------------------------- reference samples --

H, W = 80, 112        # not a multiple of 32: partial units at the edges


def recon_frames():
    rng = np.random.default_rng(3)
    noisy = rng.integers(0, 256, (H, W)).astype(np.int32)
    yy, xx = np.mgrid[0:H, 0:W]
    smooth = (40 + yy + xx).astype(np.int32)
    return {"noisy": noisy, "smooth": smooth}


def coded_grids(x, y, n):
    """Four grids of coded 4x4 units: all, none, seeded random, and the
    units before the block in raster order of its n x n blocks."""
    rows, cols = j_rs.unit_grid_shape(H, W)
    rng = np.random.default_rng(7 * x + y + n)
    raster = np.zeros((rows, cols), bool)
    raster[:y // 4, :] = True
    raster[y // 4:(y + n) // 4, :x // 4] = True
    return {"all": np.ones((rows, cols), bool),
            "none": np.zeros((rows, cols), bool),
            "random": rng.random((rows, cols)) < 0.6, "raster": raster}


def positions(n):
    """Corners, edges and the inside of the frame for an n x n block."""
    xr, yb = W - n, H - n
    xm, ym = W // 2 // n * n, H // 2 // n * n
    return [(0, 0), (xr, 0), (0, yb), (xr, yb),            # corners
            (xm, 0), (0, ym), (xr, ym), (xm, yb),           # edges
            (xm, ym), (n, n), (xr - n, yb - n)]             # inside


@pytest.mark.parametrize("strong", [True, False], ids=["strong", "no_strong"])
@pytest.mark.parametrize("n", WIDTHS)
def test_build_reference_samples_matches_jax(n, strong):
    fired = False
    for fname, recon in recon_frames().items():
        for x, y in positions(n):
            for gname, grid in coded_grids(x, y, n).items():
                got = t_rs.build_reference_samples(
                    recon, x, y, n, grid, strong_intra_smoothing=strong)
                want = j_rs.build_reference_samples(
                    recon, x, y, n, grid, strong_intra_smoothing=strong)
                for g, e in zip(got, want):
                    assert g.dtype == e.dtype
                    np.testing.assert_array_equal(
                        g, e, err_msg=f"{fname} ({x}, {y}) {gname}")
                if strong and n == 32:
                    plain = t_rs.build_reference_samples(
                        recon, x, y, n, grid, strong_intra_smoothing=False)
                    fired |= not np.array_equal(plain[2], got[2])
    assert fired or not (strong and n == 32), \
        "strong smoothing never fired: the case does not reach it"


@pytest.mark.parametrize("shape", [(1, 1), (4, 4), (5, 7), (64, 96),
                                   (1080, 1920), (1081, 1917)])
def test_unit_grid_shape_matches_jax(shape):
    assert t_rs.unit_grid_shape(*shape) == j_rs.unit_grid_shape(*shape)


# ------------------------------------------------------ cabac, colour --

def test_estimate_bin_bits_matches_jax():
    for state in range(len(j_cabac.ENTROPY_BITS)):
        for b in (0, 1):
            got = t_cabac.estimate_bin_bits(state, b)
            assert type(got) is int
            assert got == j_cabac.estimate_bin_bits(state, b), (state, b)


def color_images():
    rng = np.random.default_rng(11)
    out = {f"seeded{h}x{w}": rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
           for h, w in ((1, 1), (17, 29), (64, 96))}
    cb, cr = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for y in (0, 16, 128, 235, 255):
        out[f"all_cbcr_y{y}"] = np.stack(
            [np.full_like(cb, y), cb, cr], axis=2).astype(np.uint8)
    return out


@pytest.mark.parametrize("name", list(color_images()))
def test_ycbcr_to_rgb_matches_jax(name):
    img = color_images()[name]
    want = j_color.ycbcr_to_rgb(img)
    got = t_color.ycbcr_to_rgb(img)
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    got_t = t_color.ycbcr_to_rgb(torch.from_numpy(img))
    assert got_t.dtype == torch.uint8 and got_t.device.type == "cpu"
    np.testing.assert_array_equal(got_t.numpy(), want)


@pytest.mark.parametrize("bad,err", [
    (np.zeros((4, 4, 3), np.float32), TypeError),
    (np.zeros((4, 4), np.uint8), ValueError),
    (np.zeros((4, 4, 4), np.uint8), ValueError)])
def test_ycbcr_to_rgb_refuses_bad_input(bad, err):
    for arg in (bad, torch.from_numpy(bad)):
        with pytest.raises(err):
            t_color.ycbcr_to_rgb(arg)
    with pytest.raises(err):
        j_color.ycbcr_to_rgb(bad)


def test_ycbcr_roundtrip_close():
    rng = np.random.default_rng(12)
    rgb = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
    back = t_color.ycbcr_to_rgb(t_color.rgb_to_ycbcr(rgb))
    assert np.abs(back.astype(int) - rgb.astype(int)).max() <= 3


# ------------------------------------------------------ save_quantized --

def assert_same_model(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for k, v in want.items():
        if k == "kind":
            assert got[k] == v and type(got[k]) is type(v), what
            continue
        g = got[k]
        assert g.dtype == v.dtype and g.shape == v.shape, f"{what} {k}"
        np.testing.assert_array_equal(g, v, err_msg=f"{what} {k}")


WRITERS = {"port": t_pnn_q.save_quantized, "jax": j_pnn_q.save_quantized}
READERS = {"port": t_pnn_q.load_quantized, "jax": j_pnn_q.load_quantized}


@pytest.mark.parametrize("writer", list(WRITERS))
@pytest.mark.parametrize("path", QMODELS, ids=os.path.basename)
def test_save_quantized_round_trip(path, writer, tmp_path):
    """A model written by one package reads back in both, equal to the
    original file as either package reads it."""
    q = READERS[writer](path)
    out = str(tmp_path / "q.npz")
    WRITERS[writer](out, q)
    want = j_pnn_q.load_quantized(path)
    for reader in READERS.values():
        assert_same_model(reader(out), want, f"{writer} -> {reader}")


def test_save_quantized_of_a_port_quantized_model(tmp_path):
    """`quantize_pnn`'s dict (Python str kind, numpy scalars) written by
    either package reads back the same, also from a dict of tensors."""
    params, is_fc = t_zoo.load_frozen_params(os.path.join(
        REPO, "artifacts", "frozen", "pnn_w4_fc_single.npz"))
    calib = t_pnn_q.calibration_contexts(4, is_fc, n_samples=64)
    q = t_pnn_q.quantize_pnn(params, calib, 4, is_fc, device="cpu")
    paths = {}
    for name, write in WRITERS.items():
        paths[name] = str(tmp_path / f"{name}.npz")
        write(paths[name], q)
    as_tensors = {k: torch.from_numpy(np.asarray(v)) if k != "kind" else v
                  for k, v in q.items()}
    paths["port_tensors"] = str(tmp_path / "tensors.npz")
    t_pnn_q.save_quantized(paths["port_tensors"], as_tensors)
    want = j_pnn_q.load_quantized(paths["jax"])
    assert want["kind"] == "fc"
    for name, path in paths.items():
        for rname, read in READERS.items():
            assert_same_model(read(path), want, f"{name} -> {rname}")
