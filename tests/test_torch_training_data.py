"""The port's training data path, export and CLIs against the JAX package's.

* `TrainingPipeline` batches equal to JAX's for the same seed: offline
  triplets, and on-the-fly extraction from 320x320 crops;
* `create_training_shards` shards equal to JAX's (every array of every
  shard file), single crops and triplets, and pair mode through the port's
  v1 encoder on the CPU against JAX's, on small PIL images written to a
  tmp dir; `compute_luminance_mean` (RGB and grayscale images) and
  `build_test_set`;
* the new extraction, masking and utility functions against JAX's;
* export: `freeze_checkpoint` gives JAX's keys, shapes and values for the
  same checkpoint, the JAX package's `importer.load_npz_params` on the
  port's export gives JAX's forward equal to the port's (within 1e-5 of
  max |JAX|), manifests round-trip through both parsers;
* the CLIs: `train_pnn` runs a few steps on a tmp shard dir with
  `--device cpu` and resumes, `export_pnn` and `create_training_set` run
  end to end, `--dp 2` raises.
"""

import argparse
import glob
import os

import numpy as np
import pytest
import torch

import jax

from context_adaptive_neural_network_based_prediction_tpu.cli import (
    export_pnn as j_export)
from context_adaptive_neural_network_based_prediction_tpu.data import (
    datasets as j_datasets, extraction as j_extraction, masking as j_masking,
    pipeline as j_pipeline)
from context_adaptive_neural_network_based_prediction_tpu.models import (
    importer as j_importer, pnn as j_pnn, training as j_training)
from context_adaptive_neural_network_based_prediction_tpu.utils import (
    images as j_images, parsing as j_parsing, paths as j_paths)
from context_adaptive_neural_network_based_prediction_tpu_torch.cli import (
    create_training_set as t_create, export_pnn as t_export,
    train_pnn as t_train)
from context_adaptive_neural_network_based_prediction_tpu_torch.data import (
    datasets as t_datasets, extraction as t_extraction, masking as t_masking,
    pipeline as t_pipeline)
from context_adaptive_neural_network_based_prediction_tpu_torch.models import (
    pnn as t_pnn, training as t_training, zoo as t_zoo)
from context_adaptive_neural_network_based_prediction_tpu_torch.utils import (
    images as t_images, parsing as t_parsing, paths as t_paths)

MEAN = 86.8568


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def write_images(directory, shapes, seed=0, mode="RGB"):
    """Seeded smooth-ish PNGs of the given (h, w): a gradient plus noise."""
    import PIL.Image

    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i, (h, w) in enumerate(shapes):
        yy, xx = np.mgrid[0:h, 0:w]
        planes = [np.clip(60 + 0.3 * yy + 0.2 * xx + c * 20
                          + rng.normal(0, 12, (h, w)), 0, 255)
                  for c in range(3 if mode == "RGB" else 1)]
        arr = np.stack(planes, -1).astype(np.uint8)
        path = os.path.join(directory, f"img_{i}.png")
        PIL.Image.fromarray(arr if mode == "RGB" else arr[..., 0],
                            mode).save(path)
        paths.append(path)
    return paths


def npz_tree(directory):
    out = {}
    for path in sorted(glob.glob(os.path.join(directory, "**", "*.npz"),
                                 recursive=True)):
        with np.load(path) as d:
            out[os.path.relpath(path, directory)] = {k: d[k] for k in d.files}
    return out


def assert_trees_equal(a, b):
    assert a.keys() == b.keys() and a
    for f in a:
        assert a[f].keys() == b[f].keys(), f
        for k in a[f]:
            assert a[f][k].dtype == b[f][k].dtype, (f, k)
            assert np.array_equal(a[f][k], b[f][k]), (f, k)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("images"))
    return write_images(d, [(330, 340), (400, 330), (320, 320), (200, 400),
                            (350, 360)])


# ------------------------------------------------------------ shards, mean ----

@pytest.mark.parametrize("width", [None, 4, 8], ids=["crops", "w4", "w8"])
def test_create_training_shards_match_jax(images, tmp_path, width):
    kw = dict(width_target=width, nb_shards=2, triplets_per_image=6,
              seed=3, images_per_file=2)
    n_j = j_datasets.create_training_shards(images, str(tmp_path / "j"), **kw)
    n_t = t_datasets.create_training_shards(images, str(tmp_path / "t"),
                                            device="cpu", **kw)
    assert n_t == n_j == (4 if width is None else 24)
    assert_trees_equal(npz_tree(str(tmp_path / "t")),
                       npz_tree(str(tmp_path / "j")))


def test_create_training_shards_pair_matches_jax(images, tmp_path):
    """Pair mode: each crop's second plane from the v1 encoder at a drawn
    QP (the port's on the CPU against the JAX package's)."""
    kw = dict(width_target=None, nb_shards=1, is_pair=True, seed=5)
    paths = images[:2]
    n_j = j_datasets.create_training_shards(paths, str(tmp_path / "j"), **kw)
    n_t = t_datasets.create_training_shards(paths, str(tmp_path / "t"),
                                            device="cpu", **kw)
    assert n_t == n_j == 2
    got = npz_tree(str(tmp_path / "t"))
    assert_trees_equal(got, npz_tree(str(tmp_path / "j")))
    crops = got["thread_0/data_0.npz"]["crops"]
    assert crops.shape == (2, 320, 320, 2)
    assert not np.array_equal(crops[..., 0], crops[..., 1])


def test_luminance_mean_and_test_set_match_jax(images, tmp_path):
    gray = write_images(str(tmp_path / "gray"), [(64, 80)], seed=2,
                        mode="L")
    paths = images + gray
    for channel in (0, 1):
        assert t_datasets.compute_luminance_mean(paths, channel) \
            == j_datasets.compute_luminance_mean(paths, channel)
    with pytest.raises(ValueError, match="no usable"):
        t_datasets.compute_luminance_mean(gray, 2)
    big = [p for i, p in enumerate(images) if i != 3]
    arr_t, rot_t = t_datasets.build_test_set(big, 320, 320)
    arr_j, rot_j = j_datasets.build_test_set(big, 320, 320)
    assert np.array_equal(arr_t, arr_j) and np.array_equal(rot_t, rot_j)
    assert rot_t.tolist() == [False, True, False, False]
    with pytest.raises(ValueError, match="smaller"):
        t_datasets.build_test_set(images, 320, 320)
    path = t_datasets.save_mean_training(12.5, str(tmp_path / "m"))
    assert t_datasets.load_mean_training(path) == 12.5 \
        == j_datasets.load_mean_training(path)


# --------------------------------------------------------------- pipeline ----

@pytest.fixture(scope="module")
def shard_dirs(images, tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    dirs = {}
    for name, width in (("crops", None), ("w4", 4)):
        d = str(root / name)
        t_datasets.create_training_shards(
            images, d, width_target=width, nb_shards=2, triplets_per_image=8,
            images_per_file=2, device="cpu")
        dirs[name] = d
    return dirs


@pytest.mark.parametrize("case", [("w4", 4, False, 1000), ("w4", 4, False, 5),
                                  ("crops", 16, True, 7),
                                  ("crops", 32, True, 1000)],
                         ids=["triplets", "triplets_small_buffer",
                              "on_the_fly_w16", "on_the_fly_w32"])
def test_pipeline_batches_match_jax(shard_dirs, case):
    name, w, fly, buf = case
    kw = dict(is_extraction_on_the_fly=fly, shuffle_buffer=buf, seed=4)
    jb = j_pipeline.TrainingPipeline(shard_dirs[name], 6, w, **kw).batches()
    tb = t_pipeline.TrainingPipeline(shard_dirs[name], 6, w, **kw).batches()
    for _ in range(7):
        for x, y in zip(next(tb), next(jb)):
            assert x.dtype == y.dtype == np.uint8
            assert np.array_equal(x, y)


def test_pipeline_without_the_ram_cache_and_without_shards(shard_dirs,
                                                           tmp_path):
    a = t_pipeline.TrainingPipeline(shard_dirs["w4"], 5, 4, seed=1)
    b = t_pipeline.TrainingPipeline(shard_dirs["w4"], 5, 4, seed=1,
                                    ram_cache_bytes=0)
    assert a._ram_cache is not None and b._ram_cache is None
    for x, y in zip(next(a.batches()), next(b.batches())):
        assert np.array_equal(x, y)
    with pytest.raises(ValueError, match="no .npz"):
        t_pipeline.TrainingPipeline(str(tmp_path), 5, 4)


# ------------------------------------------------ extraction, masking, utils ----

def test_extraction_and_flatten_match_jax():
    rng = np.random.default_rng(0)
    pair = rng.integers(0, 256, (40, 50, 2), dtype=np.uint8)
    for ch in (pair, pair[..., :1]):
        got = t_extraction.extract_context_portions_target_from_channel(
            ch, 8, 5, 7)
        want = j_extraction.extract_context_portions_target_from_channel(
            ch, 8, 5, 7)
        assert all(np.array_equal(g, x) for g, x in zip(got, want))
    for bad in ((8, 20, 0), (8, 0, 30), (8, -1, 0)):
        with pytest.raises(ValueError):
            t_extraction.extract_context_portions_target_from_channel(
                pair, *bad)
    chans = rng.integers(0, 256, (3, 30, 40, 1), dtype=np.uint8)
    for rows, cols in ((np.array([0, 3]), np.array([1, 16])),
                       (rng.integers(0, 7, (3, 4)), rng.integers(0, 17, (3, 4)))):
        got = t_extraction.extract_context_portions_targets_from_channels(
            chans, 8, rows, cols)
        want = j_extraction.extract_context_portions_targets_from_channels(
            chans, 8, rows, cols)
        assert all(np.array_equal(g, x) for g, x in zip(got, want))
    with pytest.raises(ValueError, match="4D"):
        t_extraction.extract_context_portions_targets_from_channels(
            chans[0], 8, rows, cols)
    a = rng.standard_normal((4, 8, 24, 1)).astype(np.float32)
    l = rng.standard_normal((4, 16, 8, 1)).astype(np.float32)
    assert np.array_equal(t_masking.flatten_portions(a, l),
                          j_masking.flatten_portions(a, l))


def test_utils_match_jax(tmp_path):
    for sub in ("b/c", "a", "b/d"):
        os.makedirs(tmp_path / sub, exist_ok=True)
        (tmp_path / sub / "x.npz").write_bytes(b"")
        (tmp_path / sub / "y.txt").write_bytes(b"")
    for fn in ("collect_paths_to_files_in_subdirectories",):
        assert getattr(t_paths, fn)(str(tmp_path), ".npz") \
            == getattr(j_paths, fn)(str(tmp_path), ".npz")
    assert t_paths.collect_immediate_subdirectories(str(tmp_path)) \
        == j_paths.collect_immediate_subdirectories(str(tmp_path)) \
        == ["a", "b"]
    assert t_paths.makedirs_if_needed(str(tmp_path / "n")) \
        == str(tmp_path / "n") and os.path.isdir(tmp_path / "n")
    for fn, good, bad in (("float_positive", "0", "-1"),
                          ("float_strictly_positive", "0.5", "0"),
                          ("int_positive", "0", "-2"),
                          ("int_strictly_positive", "3", "0"),
                          ("tuple_two_positive_integers", "4,8", "4,-8")):
        assert getattr(t_parsing, fn)(good) == getattr(j_parsing, fn)(good)
        with pytest.raises(argparse.ArgumentTypeError):
            getattr(t_parsing, fn)(bad)
    with pytest.raises(argparse.ArgumentTypeError, match="exactly two"):
        t_parsing.tuple_two_positive_integers("1,2,3")
    rng = np.random.default_rng(0)
    ch = rng.integers(0, 256, (37, 45), dtype=np.uint8)
    for is_random in (False, True):
        got = t_images.crop_option_2d(ch, is_random, 16,
                                      np.random.default_rng(4))
        want = j_images.crop_option_2d(ch, is_random, 16,
                                       np.random.default_rng(4))
        assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="too small"):
        t_images.crop_option_2d(ch, False, 40)
    assert t_images.crop_to_multiple(ch, 8).shape == (32, 40)
    t_images.save_image(str(tmp_path / "s.png"), ch, 2)
    back = t_images.read_image_mode(str(tmp_path / "s.png"), "L")
    assert np.array_equal(back, np.repeat(np.repeat(ch, 2, 0), 2, 1))
    with pytest.raises(TypeError):
        t_images.save_image(str(tmp_path / "f.png"), ch.astype(np.float32))
    with pytest.raises(ValueError, match="mode"):
        t_images.read_image_mode(str(tmp_path / "s.png"), "RGB")


# ----------------------------------------------------------------- export ----

@pytest.mark.parametrize("w,fc", [(4, True), (8, False)],
                         ids=["fc_w4", "conv_w8"])
def test_freeze_checkpoint_matches_jax(tmp_path, w, fc):
    state = j_training.init_state(jax.random.PRNGKey(1), w, fc)
    path = j_training.save_checkpoint(state, str(tmp_path / "ckpt"))
    j_export.freeze_checkpoint(path, str(tmp_path / "j.npz"))
    t_export.freeze_checkpoint(path, str(tmp_path / "t.npz"))
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("w,fc", [(4, True), (16, False)],
                         ids=["fc_w4", "conv_w16"])
def test_port_export_loads_in_the_jax_importer(tmp_path, w, fc):
    state = t_training.init_state(torch.Generator().manual_seed(5), w, fc,
                                  device="cpu")
    rng = np.random.default_rng(0)
    b = (rng.integers(0, 256, (4, w, 3 * w, 1), dtype=np.uint8),
         rng.integers(0, 256, (4, 2 * w, w, 1), dtype=np.uint8),
         rng.integers(0, 256, (4, w, w, 1), dtype=np.uint8))
    state, _, _ = t_training.train_step(
        state, None, *b, MEAN, (4, 0), width_target=w, is_fully_connected=fc,
        coeff_l2=1.0, coeff_grad=0.0, random_masks=False)
    ckpt = t_training.save_checkpoint(state, str(tmp_path))
    npz = str(tmp_path / "frozen" / "m.npz")
    t_export.freeze_checkpoint(ckpt, npz)
    j_params = j_importer.load_npz_params(npz)
    t_params, is_fc = t_zoo.load_frozen_params(npz)
    assert is_fc == fc
    x = (rng.standard_normal((6, 5 * w * w)).astype(np.float32) * 30 if fc
         else (rng.standard_normal((6, w, 3 * w, 1)).astype(np.float32) * 30,
               rng.standard_normal((6, 2 * w, w, 1)).astype(np.float32) * 30))
    want = np.asarray(j_pnn.forward(j_params, x, w, fc))
    got = t_zoo.predict_by_batch(t_zoo.params_from_numpy(t_params, "cpu"), x,
                                 w, fc)
    with torch.no_grad():
        tx = (torch.from_numpy(x) if fc
              else tuple(torch.from_numpy(a) for a in x))
        live = t_pnn.forward(state.params, tx, w, fc).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.array_equal(got, live)


def test_manifests_round_trip(tmp_path):
    table = {(4, False): "/a/pnn_w4.npz", (8, True): "/a/pnn_w8_pair.npz",
             (16, False): "rel/pnn_w16.npz"}
    path = str(tmp_path / "m" / "manifest.txt")
    t_export.write_manifest(table, path)
    assert t_zoo.parse_manifest(path) == t_export.parse_manifest(path) \
        == j_export.parse_manifest(path) == table
    j_export.write_manifest(table, str(tmp_path / "j.txt"))
    assert open(path).read() == open(tmp_path / "j.txt").read()


# ------------------------------------------------------------------- CLIs ----

def test_train_pnn_cli_trains_and_resumes(shard_dirs, tmp_path, capsys):
    root = str(tmp_path / "results")
    args = ["4", "--shards", shard_dirs["w4"], "--mean", str(MEAN),
            "--results-root", root, "--batch-size", "4", "--chunk", "2",
            "--snapshot-every", "2", "--device", "cpu", "--coeff-grad",
            "0.5"]
    t_train.main(args + ["--iters", "4"])
    out = capsys.readouterr().out
    assert "step 2:" in out and "step 4:" in out and "resumed" not in out
    d = t_zoo.model_directory(root, 4, True, False, "luminance", 1.0, 0.5,
                              None)
    path, step = t_training.find_latest_checkpoint(d)
    assert step == 4
    before = t_training.read_checkpoint(path)
    t_train.main(args + ["--iters", "6"])
    out = capsys.readouterr().out
    assert f"resumed from {path} (step 4)" in out and "step 6:" in out
    after = t_training.read_checkpoint(
        t_training.find_latest_checkpoint(d)[0])
    assert after["step"] == 6 and int(after["opt_state"][0].count) == 6
    assert "mask_generator_state" in after
    w0 = before["params"]["fully_connected"]["weights_0"]
    assert not np.array_equal(w0, after["params"]["fully_connected"]
                              ["weights_0"])
    # Export the trained model, then load it as the zoo does.
    npz = str(tmp_path / "frozen" / "pnn_w4.npz")
    t_export.main([t_training.find_latest_checkpoint(d)[0], npz])
    assert "froze" in capsys.readouterr().out
    params, is_fc = t_zoo.load_frozen_params(npz)
    assert is_fc and params["fully_connected"]["weights_0"].shape \
        == (80, 1200)


def test_train_pnn_cli_fixed_masks_directory(shard_dirs, tmp_path):
    root = str(tmp_path / "r")
    t_train.main(["4", "--shards", shard_dirs["w4"], "--mean", "90",
                  "--results-root", root, "--batch-size", "3", "--iters",
                  "2", "--chunk", "2", "--masks", "4,0", "--device", "cpu"])
    d = t_zoo.model_directory(root, 4, True, False, "luminance", 1.0, 0.0,
                              (4, 0))
    assert d.endswith(os.path.join("1_0", "masks_tr_4_0"))
    assert t_training.find_latest_checkpoint(d)[1] == 2


@pytest.mark.parametrize("flag", ["--dp", "--tp"])
def test_train_pnn_cli_refuses_sharded_training(shard_dirs, tmp_path, flag,
                                                monkeypatch):
    """`--dp 2` / `--tp 2` outside a process group of 2 ranks raise
    ValueError naming both sizes, and write nothing."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="needs 2 ranks; the process "
                                         "group has 1"):
        t_train.main(["4", "--shards", shard_dirs["w4"], "--mean", "90",
                      "--results-root", str(tmp_path), flag, "2",
                      "--device", "cpu"])
    assert not os.listdir(tmp_path)


def test_create_training_set_cli(images, tmp_path, capsys):
    out = str(tmp_path / "set")
    t_create.main(["--images", os.path.join(os.path.dirname(images[0]),
                                            "*.png"),
                   "--output-dir", out, "--width-target", "8", "--shards",
                   "2", "--triplets-per-image", "3", "--device", "cpu"])
    assert "wrote 12 examples" in capsys.readouterr().out
    ref = str(tmp_path / "ref")
    j_datasets.create_training_shards(sorted(images), ref, width_target=8,
                                      nb_shards=2, triplets_per_image=3)
    assert_trees_equal(npz_tree(os.path.join(out)), npz_tree(ref))
    mean = t_datasets.load_mean_training(os.path.join(
        out, "means", "luminance", "mean_training.pkl"))
    assert mean == j_datasets.compute_luminance_mean(sorted(images))
    with pytest.raises(SystemExit, match="no images"):
        t_create.main(["--images", str(tmp_path / "none" / "*.png"),
                       "--output-dir", out])
