"""The port's last evaluation modules against the JAX package's, on the
CPU: `utils/yuv.py`, `utils/profiling.py`, `evaluation/hm_driver.py`,
`evaluation/maps.py`, `evaluation/stats.py`, the RD-curve plot of
`evaluation/performance.py`, and the CLIs `collect_stats_modes`,
`compare_maps_modes` and `compare_rate_distortion`.

Everything here is host numpy, so outputs are held equal: raw YUV bytes
and planes, loaded luma, the HM driver's parsed log (with a stand-in
encoder, a script that writes what HM writes: HM's config is not in the
repository), beacon counts from a stats file built here, mode maps as
RGB and PPM bytes, mode counts of one encode, `StageTimer`'s report on
a fixed clock, the CLIs' `.npy` counts, PPM files and printed RD points
on a 64x64 image (encode times stripped), and PNG plots.
"""

import os
import re
import stat
import sys

import numpy as np
import pytest
import torch

from context_adaptive_neural_network_based_prediction_tpu.cli import (
    collect_stats_modes as j_collect, compare_maps_modes as j_maps_cli,
    compare_rate_distortion as j_rd_cli)
from context_adaptive_neural_network_based_prediction_tpu.codec import (
    encoder as j_encoder)
from context_adaptive_neural_network_based_prediction_tpu.evaluation import (
    hm_driver as j_hm, maps as j_maps, stats as j_stats)
from context_adaptive_neural_network_based_prediction_tpu.utils import (
    profiling as j_profiling, yuv as j_yuv)
from context_adaptive_neural_network_based_prediction_tpu_torch.cli import (
    collect_stats_modes as t_collect, compare_maps_modes as t_maps_cli,
    compare_rate_distortion as t_rd_cli)
from context_adaptive_neural_network_based_prediction_tpu_torch.codec import (
    encoder as t_encoder)
from context_adaptive_neural_network_based_prediction_tpu_torch.evaluation import (
    hm_driver as t_hm, maps as t_maps, performance as t_perf,
    stats as t_stats)
from context_adaptive_neural_network_based_prediction_tpu_torch.utils import (
    profiling as t_profiling, yuv as t_yuv)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def video(h, w, c, t, seed=0, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 256 if dtype == np.uint8 else 1024, (h, w, c, t))
    if c == 3:   # chroma constant on 2x2 blocks, as 4:2:0 keeps it
        v[:, :, 1:] = np.repeat(np.repeat(v[::2, ::2, 1:], 2, 0), 2, 1)
    return v.astype(dtype)


@pytest.mark.parametrize("c,dtype", [(1, np.uint8), (3, np.uint8),
                                     (3, np.uint16)],
                         ids=["400", "420", "420_16bit"])
def test_yuv_round_trip_equals_jax(tmp_path, c, dtype):
    v = video(8, 12, c, 2, dtype=dtype)
    t_path, j_path = str(tmp_path / "t.yuv"), str(tmp_path / "j.yuv")
    t_yuv.write_400_or_420(v, t_path)
    j_yuv.write_400_or_420(v, j_path)
    with open(t_path, "rb") as f, open(j_path, "rb") as g:
        assert f.read() == g.read()
    got = t_yuv.read_400_or_420(8, 12, 2, dtype, c == 1, t_path)
    want = j_yuv.read_400_or_420(8, 12, 2, dtype, c == 1, t_path)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(got, v)


def test_yuv_refusals(tmp_path):
    path = str(tmp_path / "v.yuv")
    t_yuv.write_400_or_420(video(4, 4, 1, 1), path)
    with pytest.raises(IOError, match="already exists"):
        t_yuv.write_400_or_420(video(4, 4, 1, 1), path)
    with pytest.raises(TypeError):
        t_yuv.write_400_or_420(video(4, 4, 1, 1).astype(np.int32),
                               str(tmp_path / "a.yuv"))
    with pytest.raises(ValueError, match="even"):
        t_yuv.write_400_or_420(video(4, 5, 1, 1), str(tmp_path / "b.yuv"))
    with pytest.raises(ValueError, match="1 or 3"):
        t_yuv.write_400_or_420(video(4, 4, 2, 1), str(tmp_path / "c.yuv"))
    with pytest.raises(TypeError):
        t_yuv.read_400_or_420(4, 4, 1, np.int16, True, path)
    with pytest.raises(ValueError, match="even"):
        t_yuv.read_400_or_420(3, 4, 1, np.uint8, True, path)


def write_png(path, shape, mode, seed=0):
    import PIL.Image

    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    planes = [np.clip(60 + 0.8 * yy + 0.5 * xx + 25 * c
                      + rng.normal(0, 10, (h, w)), 0, 255)
              for c in range(3 if mode == "RGB" else 1)]
    arr = np.stack(planes, -1).astype(np.uint8)
    PIL.Image.fromarray(arr if mode == "RGB" else arr[..., 0]).save(path)
    return path


def test_load_luminance_equals_jax(tmp_path):
    rgb = write_png(str(tmp_path / "rgb.png"), (70, 83), "RGB")
    gray = write_png(str(tmp_path / "gray.png"), (66, 90), "L", seed=1)
    raw = str(tmp_path / "seq.yuv")
    t_yuv.write_400_or_420(video(20, 30, 3, 1, seed=2), raw)
    for args in ((rgb,), (gray,), (raw, 20, 30)):
        got, want = t_hm.load_luminance(*args), j_hm.load_luminance(*args)
        assert got.shape == want.shape and np.array_equal(got, want)
        assert got.shape[0] % 8 == 0 and got.shape[1] % 8 == 0
    with pytest.raises(ValueError, match="unknown sequence"):
        t_hm.load_luminance(raw)


FAKE_HM = """#!{python}
import sys
import numpy as np
args = sys.argv[1:]
opt = dict(zip(args[::2], args[1::2]))
w, h = int(opt["-wdt"]), int(opt["-hgt"])
src = np.fromfile(opt["-i"], np.uint8)
open(opt["-b"], "wb").write(bytes(range(37)))
np.clip(src.astype(int) + 3, 0, 255).astype(np.uint8).tofile(opt["-o"])
print("POC    0 TId: 0 ( I-SLICE, nQP 32 QP 32 )     296 bits [Y 41.2345 dB]")
print("      1    i     296.0000   41.2345   99.0000   99.0000")
print(" Total Time:        0.123 sec.")
"""


def test_hm_driver_parses_the_encoders_output_as_jax(tmp_path):
    """Both drivers run a stand-in encoder that writes a 37-byte stream,
    the source plus 3 as reconstruction, and HM's log lines."""
    exe = tmp_path / "TAppEncoderStatic"
    exe.write_text(FAKE_HM.format(python=sys.executable))
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    cfg = tmp_path / "intra.cfg"
    cfg.write_text("# stand-in\n")
    luma = video(16, 24, 1, 1)[:, :, 0, 0]
    got = t_hm.encode_decode_with_hm(
        luma, 32, t_hm.HmPaths(encoder=str(exe), config=str(cfg)))
    want = j_hm.encode_decode_with_hm(
        luma, 32, j_hm.HmPaths(encoder=str(exe), config=str(cfg)))
    assert (got.rate_bpp, got.psnr_y_db, got.total_time_s) == (
        want.rate_bpp, want.psnr_y_db, want.total_time_s) == (
        37 * 8 / (16 * 24), 41.2345, 0.123)
    assert np.array_equal(got.reconstruction, want.reconstruction)
    assert np.array_equal(got.reconstruction,
                          np.clip(luma.astype(int) + 3, 0, 255))
    with pytest.raises(FileNotFoundError, match="intra_main_rext.cfg"):
        t_hm.encode_decode_with_hm(luma, 32, t_hm.HmPaths(encoder=str(exe)))


def test_hm_binary_finds_the_shipped_decoder(monkeypatch):
    monkeypatch.delenv("HM_BIN_DIR", raising=False)
    assert t_hm.hm_binary("TAppDecoderStatic") == os.path.join(
        REPO, "artifacts", "hm_bin", "TAppDecoderStatic")
    assert t_hm.hm_binary("NoSuchBinary") is None


BEACONS = """frame 0
index 0 wins the fast selection: 1 2 3 4 5
index 26 wins the rate-distortion selection: 0 7 1 0 2
index 26 wins the rate-distortion selection: 1 1 1 1 1
index 10 is found in the fast list: 9 0 0 3 1 7
index x wins the fast selection: 1 1 1 1 1
index 40 wins the fast selection: 1 1 1 1 1
index 3 wins the fast selection: 1 1
{fast selection, rate-distortion selection} is run: 10 20 30 40 50
{fast selection, rate-distortion selection} is run: 1 1
"""


def test_beacon_stats_parse_as_jax(tmp_path):
    path = str(tmp_path / "stats.txt")
    with open(path, "w") as f:
        f.write(BEACONS)
    (c, r), (jc, jr) = (t_stats.parse_hm_stats_file(path),
                        j_stats.parse_hm_stats_file(path))
    assert np.array_equal(c, jc) and np.array_equal(r, jr)
    assert c[1, 26].tolist() == [1, 8, 2, 1, 3] and r.tolist() == [
        10, 20, 30, 40, 50]


@pytest.fixture(scope="module")
def encodes():
    """One 64x64 frame through both host encoders (regular, QP 32)."""
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:64, 0:64]
    frame = np.clip(110 + 40 * np.sin(xx / 9.0) + 30 * np.cos(yy / 13.0)
                    + rng.normal(0, 6, (64, 64)), 0, 255).astype(np.uint8)
    return (t_encoder.encode_frame(frame, 32, device="cpu"),
            j_encoder.encode_frame(frame, 32))


def test_mode_maps_and_counts_equal_jax(encodes, tmp_path):
    got, want = encodes
    assert np.array_equal(got.mode_map, want.mode_map)
    rgb = t_maps.mode_map_to_rgb(got.mode_map)
    assert np.array_equal(rgb, j_maps.mode_map_to_rgb(want.mode_map))
    special = np.array([[0, 1, 18, 35], [2, 34, -1, 10]])
    assert np.array_equal(t_maps.mode_map_to_rgb(special),
                          j_maps.mode_map_to_rgb(special))
    t_path, j_path = str(tmp_path / "t" / "m.ppm"), str(tmp_path / "j.ppm")
    t_maps.write_mode_map(got, t_path)
    j_maps.write_mode_map(want, j_path)
    with open(t_path, "rb") as f, open(j_path, "rb") as g:
        assert f.read() == g.read()
    assert np.array_equal(t_maps.read_ppm(t_path), rgb)
    counts = t_stats.collect_mode_counts(got)
    assert np.array_equal(counts, j_stats.collect_mode_counts(want))
    assert counts.sum() > 0
    assert np.array_equal(t_stats.accumulate_over_images([got, got]),
                          2 * counts)
    np.testing.assert_array_equal(t_stats.counts_to_ratios(counts),
                                  j_stats.counts_to_ratios(counts))


def test_stage_timer_report_equals_jax(monkeypatch):
    import time

    clock = iter(np.arange(0.0, 100.0, 0.25))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
    reports = []
    for mod in (t_profiling, j_profiling):
        timer = mod.StageTimer()
        for name in ("encode", "pack", "encode"):
            with timer.stage(name):
                pass
        reports.append(timer.report())
    assert reports[0] == reports[1]
    assert "encode" in reports[0] and "pack" in reports[0]


def test_trace_writes_a_chrome_trace(tmp_path):
    with t_profiling.trace(str(tmp_path / "tr")):
        torch.ones(8).sum()
    with open(tmp_path / "tr" / "trace.json") as f:
        assert "traceEvents" in f.read()


def test_plots_write_pngs(encodes, tmp_path):
    counts = t_stats.collect_mode_counts(encodes[0])
    pts = {"regular": [t_perf.RdPoint(22, 1.2, 40.0, 0.1, 0.1),
                       t_perf.RdPoint(32, 0.5, 35.0, 0.1, 0.1)]}
    paths = [str(tmp_path / n) for n in ("a/f.png", "b.png", "c/rd.png")]
    t_stats.plot_mode_frequencies(counts, paths[0], title="QP 32")
    t_stats.plot_mode_frequencies_vs_hm(counts, counts[::-1], paths[1])
    t_perf.plot_rate_distortion_curves(pts, paths[2], title="rd")
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == PNG_MAGIC


def run_jax_cli(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    mod.main()


def test_collect_stats_modes_cli_equals_jax(tmp_path, monkeypatch, capsys):
    img = write_png(str(tmp_path / "img.png"), (64, 64), "RGB", seed=3)
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    common = ["--images", img, "--qps", "32", "37", "--crop", "64",
              "--policy", "switch"]
    t_collect.main(common + ["--output-dir", out_t, "--device", "cpu"])
    run_jax_cli(j_collect, common + ["--output-dir", out_j], monkeypatch)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4 and lines[:2] == [
        ln.replace(out_j, out_t) for ln in lines[2:]]
    for qp in (32, 37):
        a = np.load(os.path.join(out_t, f"mode_counts_qp{qp}.npy"))
        b = np.load(os.path.join(out_j, f"mode_counts_qp{qp}.npy"))
        assert np.array_equal(a, b) and a.sum() > 0
        # `--policy switch` titles the plot; the encode is regular.
        assert a[:, 35].sum() == 0
        with open(os.path.join(out_t, f"mode_freq_qp{qp}.png"), "rb") as f:
            assert f.read(8) == PNG_MAGIC


def test_compare_maps_modes_cli_equals_jax(tmp_path, monkeypatch, capsys):
    img = write_png(str(tmp_path / "img.png"), (64, 64), "RGB", seed=5)
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    t_maps_cli.main([img, "--qps", "27", "37", "--output-dir", out_t,
                     "--device", "cpu"])
    run_jax_cli(j_maps_cli, [img, "--qps", "27", "37", "--output-dir",
                             out_j], monkeypatch)
    names = sorted(os.listdir(out_t))
    assert names == sorted(os.listdir(out_j)) == [
        "map_modes_qp_27_img_regular.ppm", "map_modes_qp_37_img_regular.ppm"]
    for n in names:
        with open(os.path.join(out_t, n), "rb") as f, \
                open(os.path.join(out_j, n), "rb") as g:
            assert f.read() == g.read()
    assert capsys.readouterr().out.count(" -> ") == 4


def test_compare_rate_distortion_cli_equals_jax(tmp_path, monkeypatch,
                                                capsys):
    img = write_png(str(tmp_path / "img.png"), (64, 64), "RGB", seed=6)
    common = [img, "--qps", "27", "37"]
    t_rd_cli.main(common + ["--cache-dir", str(tmp_path / "tc"),
                            "--output-dir", str(tmp_path / "to"),
                            "--device", "cpu"])
    t_out = capsys.readouterr().out
    run_jax_cli(j_rd_cli, common + ["--cache-dir", str(tmp_path / "jc"),
                                    "--output-dir", str(tmp_path / "jo")],
                monkeypatch)
    j_out = capsys.readouterr().out
    points = lambda out: [re.sub(r" \([0-9.]+s\)$", "", ln)
                          for ln in out.splitlines() if " bpp " in ln]
    assert points(t_out) == points(j_out) and len(points(t_out)) == 2
    with open(tmp_path / "to" / "img_rd.png", "rb") as f:
        assert f.read(8) == PNG_MAGIC
    assert os.path.isfile(tmp_path / "tc" / "img_regular.pkl")
