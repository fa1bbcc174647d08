"""The port's float prediction path (Tables I-V) against the JAX package's.

* `intra.predict_all_modes`: all 35 HEVC modes equal (exact int32), w = 4,
  8, 16, 32, filtered edges on and off, random and extreme references;
  `predict_best_mode`: best modes and predictions equal at w <= 16 (the
  JAX package's float32 sums are exact there); at w = 32 the port's mode
  is as good as the JAX package's by the JAX package's own PSNRs, within
  1e-4 dB (its float32 sum of squared errors can round above 2^24).
* extraction (single and pair channels, bounds), masking and
  preprocessing, PSNR and colour conversion: equal.
* `compare_on_channels` on the 128x128 natural test frame
  (`tests/golden_hm/128_full_q32_src.npy`), with the frozen w4 FC, w8
  refconv and w16 singles: every row's PSNRs within 0.01 dB and the PNN's
  win frequency within 2/N of the JAX package's (a pixel at a rounding tie
  may move).
* the CLI writes its CSV from a temporary PNG, equal to the JAX package's
  CLI within the same tolerances.
"""

import csv
import os
import sys

import numpy as np
import pytest
import torch

from context_adaptive_neural_network_based_prediction_tpu.cli import (
    compare_prediction as j_cli)
from context_adaptive_neural_network_based_prediction_tpu.data import (
    extraction as j_extraction, masking as j_masking)
from context_adaptive_neural_network_based_prediction_tpu.evaluation import (
    prediction_comparison as j_pc)
from context_adaptive_neural_network_based_prediction_tpu.models import (
    zoo as j_zoo)
from context_adaptive_neural_network_based_prediction_tpu.ops import (
    intra as j_intra)
from context_adaptive_neural_network_based_prediction_tpu.utils import (
    color as j_color, metrics as j_metrics)
from context_adaptive_neural_network_based_prediction_tpu_torch.cli import (
    compare_prediction as t_cli)
from context_adaptive_neural_network_based_prediction_tpu_torch.data import (
    extraction as t_extraction, masking as t_masking)
from context_adaptive_neural_network_based_prediction_tpu_torch.evaluation import (
    prediction_comparison as t_pc)
from context_adaptive_neural_network_based_prediction_tpu_torch.models import (
    zoo as t_zoo)
from context_adaptive_neural_network_based_prediction_tpu_torch.ops import (
    intra as t_intra)
from context_adaptive_neural_network_based_prediction_tpu_torch.utils import (
    color as t_color, metrics as t_metrics)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME = np.load(os.path.join(REPO, "tests", "golden_hm",
                             "128_full_q32_src.npy"))
MEAN = 86.8568


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def references(w, n, seed):
    """Random references, then extremes (all 0, all 255, a 0/255
    alternation) in the last three rows."""
    rng = np.random.default_rng(seed)
    rt = rng.integers(0, 256, (n, 2 * w + 1)).astype(np.int32)
    rl = rng.integers(0, 256, (n, 2 * w + 1)).astype(np.int32)
    rt[-3], rl[-3] = 0, 0
    rt[-2], rl[-2] = 255, 255
    rt[-1] = 255 * (np.arange(2 * w + 1) % 2)
    rl[-1] = 255 - rt[-1]
    rl[:, 0] = rt[:, 0]
    return rt, rl


@pytest.mark.parametrize("filtered", [True, False])
@pytest.mark.parametrize("w", [4, 8, 16, 32])
def test_predict_all_modes_equal(w, filtered):
    rt, rl = references(w, 64, seed=w)
    ref = np.asarray(j_intra.predict_all_modes(rt, rl,
                                               filtered_edges=filtered))
    got = t_intra.predict_all_modes(torch.from_numpy(rt),
                                    torch.from_numpy(rl),
                                    filtered_edges=filtered)
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("w", [4, 8, 16, 32])
def test_predict_best_mode(w):
    rt, rl = references(w, 200, seed=10 + w)
    rng = np.random.default_rng(w)
    # Targets near one of the modes' predictions, so that modes compete.
    preds = np.asarray(j_intra.predict_all_modes(rt, rl))
    tg = np.clip(preds[np.arange(200), rng.integers(0, 35, 200)]
                 + rng.integers(-3, 4, (200, w, w)), 0, 255).astype(np.int32)
    j_pred, j_mode, j_psnr = [np.asarray(a) for a in
                              j_intra.predict_best_mode(rt, rl, tg)]
    t_pred, t_mode, t_psnr = [a.numpy() for a in t_intra.predict_best_mode(
        torch.from_numpy(rt), torch.from_numpy(rl), torch.from_numpy(tg))]
    if w <= 16:
        np.testing.assert_array_equal(t_mode, j_mode)
        np.testing.assert_array_equal(t_pred, j_pred)
    else:
        # The JAX package's PSNR of every mode (its float32 mean).
        t = tg.astype(np.float32)[:, None]
        mse = ((preds.astype(np.float32) - t) ** 2).mean(axis=(2, 3))
        psnr = 10 * np.log10(255.0 ** 2 / (mse + 1e-6))
        rows = np.arange(200)
        assert np.all(psnr[rows, t_mode] >= psnr[rows, j_mode] - 1e-4)
        np.testing.assert_array_equal(t_pred, preds[rows, t_mode])
    np.testing.assert_allclose(t_psnr, j_psnr, rtol=1e-5)


@pytest.mark.parametrize("pair", [False, True])
def test_extraction_equal(pair):
    rng = np.random.default_rng(3)
    ch = rng.integers(0, 256, (40, 56, 2 if pair else 1)).astype(np.uint8)
    rows = rng.integers(0, 40 - 24 + 1, 17)
    cols = rng.integers(0, 56 - 24 + 1, 17)
    ref = j_extraction.extract_context_portions_targets_from_channel(
        ch, 8, rows, cols)
    got = t_extraction.extract_context_portions_targets_from_channel(
        ch, 8, rows, cols)
    for a, b in zip(got, ref):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    for bad, err in ((ch.astype(np.int16), TypeError),
                     (ch[:, :, :1].repeat(3, 2), ValueError)):
        with pytest.raises(err):
            t_extraction.extract_context_portions_targets_from_channel(
                bad, 8, rows, cols)
    with pytest.raises(ValueError, match="bounds"):
        t_extraction.extract_context_portions_targets_from_channel(
            ch, 8, rows + 40, cols)
    with pytest.raises(TypeError, match="integer"):
        t_extraction.extract_context_portions_targets_from_channel(
            ch, 8, rows.astype(np.float64), cols)


@pytest.mark.parametrize("is_fc", [True, False])
@pytest.mark.parametrize("masks", [(0, 0), (8, 0), (4, 8), "per_example"])
def test_masking_equal(is_fc, masks):
    w = 8
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (6, w, 3 * w, 1)).astype(np.uint8)
    l = rng.integers(0, 256, (6, 2 * w, w, 1)).astype(np.uint8)
    t = rng.integers(0, 256, (6, w, w, 1)).astype(np.uint8)
    if masks == "per_example":
        masks = (rng.choice([0, 4, 8], 6), rng.choice([0, 4, 8], 6))
    ref = j_masking.preprocess_context_portions_targets(a, l, t, MEAN, masks,
                                                        is_fc)
    got = t_masking.preprocess_context_portions_targets(a, l, t, MEAN, masks,
                                                        is_fc)
    assert len(got) == len(ref)
    for x, y in zip(got, ref):
        assert x.dtype == np.float32
        np.testing.assert_array_equal(x, y)
    for bad in ((3, 0), (0, 12), (-4, 0)):
        with pytest.raises(ValueError):
            t_masking.check_mask_sizes(w, *bad)


def test_metrics_and_color_equal():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (7, 8, 8)).astype(np.uint8)
    b = rng.integers(0, 256, (7, 8, 8)).astype(np.uint8)
    assert t_metrics.compute_psnr(a, b) == j_metrics.compute_psnr(a, b)
    assert t_metrics.compute_psnr(a, a) == j_metrics.compute_psnr(a, a)
    np.testing.assert_array_equal(t_metrics.compute_psnr_batch(a, b),
                                  j_metrics.compute_psnr_batch(a, b))
    with pytest.raises(TypeError):
        t_metrics.compute_psnr(a.astype(np.int32), b)
    rgb = rng.integers(0, 256, (9, 11, 3)).astype(np.uint8)
    np.testing.assert_array_equal(t_color.rgb_to_ycbcr(rgb),
                                  np.asarray(j_color.rgb_to_ycbcr(rgb)))


def test_draw_positions_and_hevc_oracle_equal():
    ch = FRAME[:, :, None]
    for w in (4, 8, 16, 32):
        rows, cols = t_pc.draw_positions(np.random.default_rng(w), 128, 128,
                                         w, 50)
        j_rows, j_cols = j_pc.draw_positions(np.random.default_rng(w), 128,
                                             128, w, 50)
        np.testing.assert_array_equal(rows, j_rows)
        np.testing.assert_array_equal(cols, j_cols)
        _, _, t = t_extraction.extract_context_portions_targets_from_channel(
            ch, w, rows, cols)
        got = t_pc.hevc_best_mode_predictions(ch, w, rows, cols, t,
                                              device="cpu")
        ref = j_pc.hevc_best_mode_predictions(ch, w, rows, cols, t)
        assert got[0].dtype == np.uint8
        if w <= 16:
            np.testing.assert_array_equal(got[0], ref[0])
            np.testing.assert_array_equal(got[1], ref[1])


def assert_rows_close(got, ref, n):
    assert len(got) == len(ref) == 4
    for r, q in zip(got, ref):
        assert (r.width_mask_above, r.height_mask_left) == (
            q.width_mask_above, q.height_mask_left)
        assert abs(r.mean_psnr_pnn - q.mean_psnr_pnn) <= 0.01
        assert abs(r.mean_psnr_hevc_best - q.mean_psnr_hevc_best) <= 0.01
        assert abs(r.pnn_win_frequency - q.pnn_win_frequency) <= 2 / n
        assert r.mean_psnr_ipfcn is None


@pytest.mark.parametrize("name", ["pnn_w4_fc_single", "pnn_w8_refconv_single",
                                  "pnn_w16_single"])
def test_compare_on_channels_matches_jax(name):
    w = int(name.split("_")[1][1:])
    path = os.path.join(REPO, "artifacts", "frozen", name + ".npz")
    j_params, is_fc = j_zoo.load_frozen_params(path)
    t_params, _ = t_zoo.load_frozen_params(path)
    ch = FRAME[None, :, :, None]
    ref = j_pc.compare_on_channels(ch, w, j_params, is_fc, MEAN,
                                   nb_positions_per_image=128, seed=3)
    got = t_pc.compare_on_channels(ch, w, t_params, is_fc, MEAN,
                                   nb_positions_per_image=128, seed=3,
                                   device="cpu")
    assert_rows_close(got, ref, 128)


def read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f, delimiter=";"))


def test_cli_writes_csv(tmp_path, monkeypatch, capsys):
    import PIL.Image

    rng = np.random.default_rng(6)
    yy, xx = np.mgrid[0:72, 0:80]
    base = 120 + 60 * np.sin(xx / 9.0) + 40 * np.cos(yy / 7.0)
    rgb = np.clip(base[..., None] + rng.normal(0, 6, (72, 80, 3)), 0, 255)
    PIL.Image.fromarray(rgb.astype(np.uint8)).save(tmp_path / "img.png")
    args = ["4", "--images", str(tmp_path / "*.png"), "--checkpoint",
            os.path.join(REPO, "artifacts", "frozen", "pnn_w4_fc_single.npz"),
            "--crop", "64", "--positions-per-image", "48", "--mean",
            str(MEAN)]
    t_cli.main(args + ["--output", str(tmp_path / "port.csv"),
                       "--device", "cpu"])
    assert "csv ->" in capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["compare_prediction"] + args
                        + ["--output", str(tmp_path / "jax.csv")])
    j_cli.main()
    got, ref = read_csv(tmp_path / "port.csv"), read_csv(tmp_path / "jax.csv")
    assert got[0] == ref[0] and len(got) == len(ref) == 5
    for r, q in zip(got[1:], ref[1:]):
        assert r[:2] == q[:2] and r[4] == q[4] == ""
        for i in (2, 3):
            assert abs(float(r[i]) - float(q[i])) <= 0.01
        assert abs(float(r[5]) - float(q[5])) <= 2 / 48
