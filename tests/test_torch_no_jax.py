"""The port and `chip_smoke.py` import nothing of JAX, of optax and of the
JAX package: a scan of every Python file of the port package and of
`chip_smoke.py` for import statements (and `import_module` / `__import__`
calls) that name `jax`, `jaxlib`, `optax` or the JAX package, and fresh
processes that run the CTB-64 Annex-B path and the loop-filtered decode,
the v1 and quantize paths, the host RDO codec, and training (steps,
checkpoints, a JAX-written checkpoint, export), and load none of them.  Each child
runs torch on one thread, as the test files cap their own.  Ranks spawned
by `parallel/mesh.spawn_ranks` from this process, which has JAX loaded,
run a tiled encode and a sharded training chunk and load none of them
either."""

import glob
import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "context_adaptive_neural_network_based_prediction_tpu_torch"
REF = "context_adaptive_neural_network_based_prediction_tpu"
FORBIDDEN = rf"(jax|jaxlib|optax|{REF})(?![\w])"
PATTERNS = (
    re.compile(rf"^\s*import\s+([\w.]+\s*(as\s+\w+)?\s*,\s*)*{FORBIDDEN}",
               re.M),
    re.compile(rf"^\s*from\s+{FORBIDDEN}[\w.]*\s+import\b", re.M),
    re.compile(rf"(import_module|__import__)\(\s*[\"']{FORBIDDEN}"),
)
FILES = sorted(glob.glob(os.path.join(REPO, PORT, "**", "*.py"),
                         recursive=True)) + [os.path.join(REPO,
                                                          "chip_smoke.py")]


def child_env():
    """A child process's environment: the repository on the path and one
    thread, as the test files cap their own."""
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


def offending(text):
    return [m.group(0).strip() for p in PATTERNS for m in p.finditer(text)]


@pytest.mark.parametrize("path", [os.path.relpath(f, REPO) for f in FILES])
def test_no_jax_import(path):
    with open(os.path.join(REPO, path)) as f:
        assert offending(f.read()) == []


def test_the_scan_finds_what_it_looks_for():
    for bad in ("import jax\n", "import numpy as np, jax.numpy as jnp\n",
                "import optax\n", "from optax._src import transform\n",
                "    from jax import lax\n", f"from {REF}.ops import intra\n",
                f"import {REF}\n", "importlib.import_module('jax')\n",
                f"__import__(\"{REF}.codec\")\n"):
        assert offending(bad), bad
    for good in (f"from {PORT}.ops import intra\n", f"import {PORT}\n",
                 "# the JAX package's jax.lax.dynamic_slice clamps\n",
                 "from ..ops import unit_fused\n"):
        assert offending(good) == [], good


def test_the_scan_covers_the_annexb_slice():
    names = {os.path.relpath(f, os.path.join(REPO, PORT)) for f in FILES}
    for mod in ("codec/hm_bitstream.py", "codec/hm_encoder.py",
                "codec/sao.py", "codec/deblock.py", "codec/cabac.py",
                "codec/syntax.py", "codec/decoder.py", "codec/native.py",
                "parallel/wavefront2.py"):
        assert mod in names, mod


def test_annexb_path_runs_without_jax():
    """A fresh process runs the CTB-64 Annex-B encode with loop filters and
    the port's decoder on a loop-filtered container stream, and has loaded
    no module of JAX or of the JAX package."""
    code = (
        "import json, sys\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        f"from {PORT}.codec import decoder, encoder, native\n"
        f"from {PORT}.parallel import wavefront2\n"
        "rng = np.random.default_rng(0)\n"
        "f = rng.integers(90, 160, (64, 128)).astype(np.uint8)\n"
        "s, r = wavefront2.encode_frame_wavefront2_hm(f, 32, ctb=64,"
        " device='cpu')\n"
        "a = wavefront2.encode_frame_wavefront2(f, 32, ctb=64,"
        " device='cpu')\n"
        "hdr = encoder.stream_header(width=128, height=64, qp=32,"
        " policy='regular', ctu_size=64, sign_hiding=True,"
        " deblocking=True)\n"
        "d = decoder.decode_frame(hdr + a.bitstream[len(hdr):],"
        " device='cpu')\n"
        f"ref = '{REF}'\n"
        "bad = [m for m in sys.modules if m.startswith('jax')"
        " or m == ref or m.startswith(ref + '.')]\n"
        "print(json.dumps(dict(bad=bad, n=len(s), shape=list("
        "d.reconstruction.shape))))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=child_env(),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == [] and out["n"] > 0 and out["shape"] == [64, 128]


def test_the_scan_covers_the_v1_and_quantize_slice():
    names = {os.path.relpath(f, os.path.join(REPO, PORT)) for f in FILES}
    for mod in ("parallel/wavefront.py", "models/pnn_q.py", "models/zoo.py",
                "codec/nn_intra.py", "evaluation/quantize_golden.py"):
        assert mod in names, mod


def test_v1_and_quantize_paths_run_without_jax():
    """A fresh process runs the v1 encode and its Annex-B stream, the
    decoder on the v1 stream, and quantizes a float single into a bundle,
    and has loaded no module of JAX or of the JAX package."""
    code = (
        "import json, pickle, sys\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        f"from {PORT}.codec import decoder\n"
        f"from {PORT}.models import zoo\n"
        f"from {PORT}.parallel import wavefront\n"
        "rng = np.random.default_rng(0)\n"
        "f = rng.integers(90, 160, (32, 48)).astype(np.uint8)\n"
        "r = wavefront.encode_frame_wavefront(f, 32, device='cpu')\n"
        "s, _ = wavefront.encode_frame_wavefront_hm(f, 32, device='cpu')\n"
        "d = decoder.decode_frame(r.bitstream, device='cpu')\n"
        "b = zoo.load_codec_bundle('artifacts/frozen/manifest_trained.txt',"
        " 100.0, use_pair=False, widths=(8,)).quantize(n_samples=8,"
        " device='cpu')\n"
        f"ref = '{REF}'\n"
        "bad = [m for m in sys.modules if m.startswith('jax')"
        " or m == ref or m.startswith(ref + '.')]\n"
        "print(json.dumps(dict(bad=bad, n=len(s), same=bool(np.array_equal("
        "d.reconstruction, r.reconstruction)), kind=str(b.quantized[8]"
        "['kind']))))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=child_env(),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == dict(bad=[], n=out["n"], same=True, kind="conv")
    assert out["n"] > 0


def test_the_scan_covers_the_host_codec_slice():
    names = {os.path.relpath(f, os.path.join(REPO, PORT)) for f in FILES}
    for mod in ("codec/encoder.py", "codec/rdo.py", "codec/rdoq.py",
                "codec/chroma_enc.py", "codec/hm_decoder.py",
                "codec/hm_bitstream.py", "codec/hm_encoder.py",
                "evaluation/performance.py", "evaluation/host_cases.py",
                "utils/metrics.py"):
        assert mod in names, mod


def test_host_codec_path_runs_without_jax():
    """A fresh process runs the host RDO encoder (framework and Annex-B
    4:2:0 streams), the HM-syntax decoder with both slice parsers and
    `compute_rate_psnr`, and has loaded no module of JAX or of the JAX
    package."""
    code = (
        "import json, sys\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        f"from {PORT}.codec import decoder, encoder, hm_decoder,"
        " hm_encoder\n"
        f"from {PORT}.evaluation import performance\n"
        "rng = np.random.default_rng(0)\n"
        "y = rng.integers(90, 160, (32, 48)).astype(np.uint8)\n"
        "cb, cr = y[::2, ::2].copy(), y[1::2, 1::2].copy()\n"
        "r = encoder.encode_frame(y, 32, device='cpu')\n"
        "d = decoder.decode_frame(r.bitstream, device='cpu')\n"
        "s, r4, rcb, rcr = hm_encoder.encode_frame_hm_420((y, cb, cr), 32,"
        " device='cpu')\n"
        "h = [hm_decoder.decode_hm_stream(s, use_native=u) for u in"
        " ('always', 'never')]\n"
        "p = performance.compute_rate_psnr(y, 32, use_hm_container=True,"
        " device='cpu')\n"
        f"ref = '{REF}'\n"
        "bad = [m for m in sys.modules if m.startswith('jax')"
        " or m == ref or m.startswith(ref + '.')]\n"
        "same = bool(np.array_equal(d.reconstruction, r.reconstruction)"
        " and all(np.array_equal(x.reconstruction_cb, rcb)"
        " and np.array_equal(x.reconstruction, r4.reconstruction)"
        " for x in h))\n"
        "print(json.dumps(dict(bad=bad, same=same, ok=all(x.hash_ok for x"
        " in h), rate=p.rate_bpp > 0)))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=child_env(), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == dict(bad=[], same=True, ok=True, rate=True)


def test_the_scan_covers_the_training_slice():
    names = {os.path.relpath(f, os.path.join(REPO, PORT)) for f in FILES}
    for mod in ("models/training.py", "models/losses.py", "models/ipfcn.py",
                "models/visualization.py", "data/datasets.py",
                "data/pipeline.py", "cli/train_pnn.py", "cli/export_pnn.py",
                "cli/create_training_set.py", "utils/paths.py",
                "utils/parsing.py", "utils/images.py"):
        assert mod in names, mod


def test_training_path_runs_without_jax(tmp_path):
    """A fresh process trains a few steps, saves and restores its own
    checkpoint, restores a checkpoint the JAX package wrote (here, in the
    parent) and steps it, exports both and reloads them, and has loaded
    no module of JAX, of optax or of the JAX package."""
    import jax

    from context_adaptive_neural_network_based_prediction_tpu.models import (
        training as j_training)

    j_path = j_training.save_checkpoint(
        j_training.init_state(jax.random.PRNGKey(0), 4, True),
        str(tmp_path / "jax"))
    code = (
        "import json, sys\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        f"from {PORT}.models import training, zoo\n"
        f"from {PORT}.cli import export_pnn\n"
        "rng = np.random.default_rng(0)\n"
        "b = lambda: (rng.integers(0, 256, (4, 4, 12, 1), dtype=np.uint8),"
        " rng.integers(0, 256, (4, 8, 4, 1), dtype=np.uint8),"
        " rng.integers(0, 256, (4, 4, 4, 1), dtype=np.uint8))\n"
        "kw = dict(width_target=4, is_fully_connected=True, coeff_l2=1.0,"
        " coeff_grad=0.0, random_masks=True)\n"
        "g = torch.Generator().manual_seed(1)\n"
        "s = training.init_state(torch.Generator().manual_seed(0), 4, True,"
        " device='cpu')\n"
        "for _ in range(3):\n"
        "    s, loss, _ = training.train_step(s, g, *b(), 90.0, (0, 0),"
        " **kw)\n"
        f"p = training.save_checkpoint(s, {str(tmp_path / 'port')!r}, g)\n"
        "r = training.restore_checkpoint(p, 4, device='cpu')\n"
        f"j = training.restore_checkpoint({j_path!r}, 4, device='cpu')\n"
        "j, jl, _ = training.train_step(j, g, *b(), 90.0, (0, 0), **kw)\n"
        "out = []\n"
        f"for ck, npz in ((p, {str(tmp_path / 'p.npz')!r}),"
        f" ({j_path!r}, {str(tmp_path / 'j.npz')!r})):\n"
        "    export_pnn.freeze_checkpoint(ck, npz)\n"
        "    params, fc = zoo.load_frozen_params(npz)\n"
        "    out.append(list(params['fully_connected']['weights_0'].shape))\n"
        "same = bool(np.array_equal(zoo.params_to_numpy(r.params)"
        "['fully_connected']['weights_3'], zoo.params_to_numpy(s.params)"
        "['fully_connected']['weights_3']))\n"
        f"ref = '{REF}'\n"
        "bad = [m for m in sys.modules if m.startswith(('jax', 'optax'))"
        " or m == ref or m.startswith(ref + '.')]\n"
        "print(json.dumps(dict(bad=bad, same=same, step=r.step,"
        " jstep=j.step, finite=bool(np.isfinite(float(loss))"
        " and np.isfinite(float(jl))), shapes=out)))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=child_env(), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == dict(bad=[], same=True, step=3, jstep=1, finite=True,
                       shapes=[[80, 1200], [80, 1200]])


def test_the_scan_covers_the_multi_rank_and_evaluation_slice():
    names = {os.path.relpath(f, os.path.join(REPO, PORT)) for f in FILES}
    for mod in ("parallel/mesh.py", "parallel/tiled.py",
                "parallel/sharded_training.py", "parallel/dryrun.py",
                "utils/yuv.py", "utils/profiling.py",
                "evaluation/hm_driver.py", "evaluation/maps.py",
                "evaluation/stats.py", "cli/collect_stats_modes.py",
                "cli/compare_maps_modes.py",
                "cli/compare_rate_distortion.py"):
        assert mod in names, mod


def test_spawned_ranks_load_no_jax():
    """Two Gloo ranks spawned from this process (JAX loaded here) run a
    tiled halo encode and a sharded training chunk, then list what they
    loaded: nothing of JAX, optax or the JAX package."""
    import numpy as np
    import torch

    import jax  # noqa: F401  (the parent has JAX, the ranks must not)
    from context_adaptive_neural_network_based_prediction_tpu_torch \
        .models import training
    from context_adaptive_neural_network_based_prediction_tpu_torch \
        .parallel import mesh, sharded_training, tiled

    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (64, 32), dtype=np.uint8)
    blob = training.state_to_numpy(training.init_state(
        torch.Generator().manual_seed(0), 4, True, device="cpu"))
    batches = [rng.integers(0, 256, (1, 4) + s, dtype=np.uint8)
               for s in ((4, 12, 1), (8, 4, 1), (4, 4, 1))]
    prefixes = ("jax", "jaxlib", "optax", REF, PORT)
    for then, args, kwargs in (
            (tiled.encode_cases, ([("encode_frame_tiled_halo", frame, 32,
                                    {"device": "cpu"})],), {}),
            (sharded_training.chunk_from_state,
             ({"data": 2, "model": 1}, 4, True, blob,
              torch.Generator().get_state().numpy(), *batches, 90.0),
             {"device": "cpu"})):
        for loaded in mesh.spawn_ranks(mesh.loaded_modules, 2,
                                       device="cpu",
                                       args=(prefixes, then, args, kwargs),
                                       timeout=300):
            assert f"{PORT}.parallel.mesh" in loaded
            assert [m for m in loaded if not m.startswith(PORT)] == []
