"""The port's NN-policy encodes against the JAX package's, with zero
tolerance.

Config: CTB 32, NxN on, one frame, policies `switch` (the PNN is a
signalled 36th mode, PNNS) and `substitution` (the PNN replaces mode 18).
Two frames and bundles, as `tests/golden_torch/w2_nn.json` records them:
* here, the synthetic 64x96 frame (seed 5) at QP 37 with the random
  quantized bundle of `tests/test_wavefront_nn.py` (conv PNNs at widths 8
  and 16), quantized by the JAX package and carried across as it is;
* in `test_torch_wavefront_nn_zoo.py`, the 128x128 natural crop with the
  frozen zoo, which reuses this file's helpers.
The port runs on the CPU (plain trial, plain merger).

* Rate evolution off: the JAX package's default CPU encode runs live; the
  reconstruction, every grid of `_assemble_arrays` and the stream bytes
  are equal, the JAX decoder reproduces the port's reconstruction from the
  port's stream, and the JAX encodes equal the digests the card's tests
  read from `w2_nn.json`.  A fresh process runs the user entry point with
  the bundle the card loads and imports no JAX.
* Rate evolution on (switch, 64x96): the JAX package's encode runs op by
  op for about ten minutes, so tier 1 holds the port against the captured
  digests (`scripts/capture_torch_port_golden.py --set nn`); the live
  comparison is the `slow` test.
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from context_adaptive_neural_network_based_prediction_tpu.codec import (
    decoder as j_decoder, nn_intra as j_nn_intra)
from context_adaptive_neural_network_based_prediction_tpu.models import (
    pnn as j_pnn)
from context_adaptive_neural_network_based_prediction_tpu.parallel import (
    wavefront2 as j_wavefront2)
from context_adaptive_neural_network_based_prediction_tpu_torch.codec import (
    nn_intra as t_nn_intra)
from context_adaptive_neural_network_based_prediction_tpu_torch.models import (
    zoo as t_zoo)
from context_adaptive_neural_network_based_prediction_tpu_torch.parallel import (
    wavefront2 as t_wavefront2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden_torch", "w2_nn.json")
GRIDS = ("m8", "q8", "s8", "m4", "q4", "m16", "q16", "s16", "m32", "q32",
         "s32")
ITEMS = ("recon",) + GRIDS + ("stream",)
LIVE = ("synth64x96/switch/live", "synth64x96/substitution/live")
RATE_EVOLVE = "synth64x96/switch/rate_evolve"


def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def frames():
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:64, 0:96]
    synth = np.clip(128 + 45 * np.sin(xx / 11.0) + 35 * np.cos(yy / 8.0)
                    + rng.normal(0, 7, (64, 96)), 0, 255).astype(np.uint8)
    natural = np.load(os.path.join(REPO, "tests", "golden_hm",
                                   "128_full_q32_src.npy"))
    return {"synth64x96": synth, "natural128": natural}


def sha(a):
    if isinstance(a, (bytes, bytearray)):
        return hashlib.sha256(bytes(a)).hexdigest()
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def pnn_pus(trees, policy, widths):
    """PUs coded with the PNN mode (35 under switch; 18 at a width with a
    model under substitution)."""
    count, stack = 0, list(trees)
    while stack:
        node = stack.pop()
        stack.extend(node.children)
        for pu in node.pus:
            count += (policy == "switch" and pu.mode == 35) or (
                policy == "substitution" and pu.mode == 18
                and pu.n in widths)
    return count


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def jax_random_bundle():
    """The random bundle of tests/test_wavefront_nn.py, JAX-quantized."""
    params = {8: j_pnn.init_params(jax.random.PRNGKey(1), 8, False),
              16: j_pnn.init_params(jax.random.PRNGKey(2), 16, False)}
    return j_nn_intra.PnnBundle(params, {8: False, 16: False},
                                117.9).quantize(n_samples=48)


def as_items(recon, grids, res, widths, policy):
    out = {"recon": np.asarray(recon, np.uint8), "stream": res.bitstream,
           "pnn_pus": pnn_pus(res.ctu_trees, policy, widths)}
    out.update(zip(GRIDS, grids))
    return out


def jax_live_encode(key, bundle):
    """The JAX package's default CPU encode (rate evolution off) of a
    `w2_nn.json` entry."""
    e = golden()["encodes"][key]
    frame = frames()[e["frame"]]
    h, w = frame.shape
    j_wavefront2._W2_CACHE.clear()
    run = j_wavefront2._jitted_wavefront2(
        h, w, e["qp"], policy=e["policy"], bundle=bundle, ctb=32,
        enable_nxn=True, rate_evolve=False)
    recon, ys = run(jnp.asarray(frame))
    grids = j_wavefront2._assemble_arrays(ys, h, w, 32)
    res = j_wavefront2._arrays_to_result(
        frame, e["qp"], (np.asarray(recon),) + grids, e["policy"], True)
    j_wavefront2._W2_CACHE.clear()
    return as_items(recon, grids, res, list(bundle.quantized), e["policy"])


def port_encode(key, bundle):
    """The port's encode of a `w2_nn.json` entry on the CPU."""
    e = golden()["encodes"][key]
    frame = frames()[e["frame"]]
    recon, grids = t_wavefront2.encode_arrays_wavefront2(
        frame, e["qp"], policy=e["policy"], pnn=bundle,
        rate_evolve=e["rate_evolve"], device="cpu")
    res = t_wavefront2._arrays_to_result(frame, e["qp"], (recon,) + grids,
                                         e["policy"], True)
    return as_items(recon, grids, res, list(bundle.quantized), e["policy"])


@pytest.fixture(scope="module")
def jax_bundle():
    return jax_random_bundle()


@pytest.fixture(scope="module")
def port_bundle(jax_bundle):
    return t_nn_intra.PnnBundle(dict(jax_bundle.quantized), 117.9)


@pytest.fixture(scope="module")
def jax_live(jax_bundle):
    return {key: jax_live_encode(key, jax_bundle) for key in LIVE}


@pytest.fixture(scope="module")
def port_runs(port_bundle):
    return {key: port_encode(key, port_bundle)
            for key in LIVE + (RATE_EVOLVE,)}


def assert_item_equal(got, want, what):
    if isinstance(want, (bytes, bytearray)):
        assert got == want, f"{what}: {len(got)} vs {len(want)} bytes"
    else:
        assert got.shape == want.shape, what
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("item", ITEMS)
@pytest.mark.parametrize("key", LIVE)
def test_nn_encode_matches_jax(jax_live, port_runs, key, item):
    assert_item_equal(port_runs[key][item], jax_live[key][item],
                      f"{key} {item}")


@pytest.mark.parametrize("key", LIVE)
def test_jax_decoder_reads_port_nn_stream(jax_bundle, port_runs, key):
    dec = j_decoder.decode_frame(port_runs[key]["stream"],
                                 pnn=j_nn_intra.PnnPredictor(jax_bundle))
    np.testing.assert_array_equal(np.asarray(dec.reconstruction),
                                  port_runs[key]["recon"])


@pytest.mark.parametrize("key", LIVE)
def test_card_digests_match_live_jax(jax_live, key):
    """The digests the card's tests read equal the live JAX encodes."""
    want = golden()["encodes"][key]
    got = {k: sha(np.asarray(v, np.int32)) if k in GRIDS else sha(v)
           for k, v in jax_live[key].items() if k in ITEMS}
    assert got == {k: want[k] for k in ITEMS}
    assert jax_live[key]["pnn_pus"] == want["pnn_pus"]


@pytest.mark.parametrize("item", ITEMS)
def test_rate_evolve_nn_matches_jax_digests(port_runs, item):
    want = golden()["encodes"][RATE_EVOLVE]
    assert (want["policy"], want["rate_evolve"], want["impl"]) == (
        "switch", True, "xla")
    got = port_runs[RATE_EVOLVE][item]
    if item in GRIDS:
        got = np.asarray(got, np.int32)
    assert sha(got) == want[item], item


def test_saved_random_bundle_is_the_jax_quantization(jax_bundle):
    """The npz the card loads (no JAX there) holds exactly the models the
    JAX package quantizes."""
    saved = t_zoo.load_bundle_npz(os.path.join(
        REPO, golden()["bundles"]["random"]["file"]))
    rand = jax_bundle
    assert saved.mean_training == rand.mean_training
    assert set(saved.quantized) == set(rand.quantized) == {8, 16}
    for w, q in rand.quantized.items():
        assert set(saved.quantized[w]) == set(q)
        for k, v in q.items():
            a = saved.quantized[w][k]
            if k == "kind":
                assert a == v
            else:
                np.testing.assert_array_equal(a, np.asarray(v), err_msg=k)
                assert a.dtype == np.asarray(v).dtype, k


@pytest.mark.slow
def test_rate_evolve_nn_matches_jax_live(jax_bundle, port_runs):
    """Live JAX-vs-port with rate evolution, op by op (about ten minutes,
    hence `slow`)."""
    e = golden()["encodes"][RATE_EVOLVE]
    frame = frames()[e["frame"]]
    h, w = frame.shape
    old = os.environ.get("CANP_FUSED_UNIT")
    os.environ["CANP_FUSED_UNIT"] = "xla"
    j_wavefront2._W2_CACHE.clear()
    try:
        run = j_wavefront2._jitted_wavefront2(
            h, w, e["qp"], policy="switch", bundle=jax_bundle,
            ctb=32, enable_nxn=True, rate_evolve=True)
        with jax.disable_jit():
            recon, ys = run(jnp.asarray(frame))
    finally:
        j_wavefront2._W2_CACHE.clear()
        if old is None:
            del os.environ["CANP_FUSED_UNIT"]
        else:
            os.environ["CANP_FUSED_UNIT"] = old
    grids = j_wavefront2._assemble_arrays(ys, h, w, 32)
    res = j_wavefront2._arrays_to_result(
        frame, e["qp"], (np.asarray(recon),) + grids, "switch", True)
    want = as_items(recon, grids, res, [8, 16], "switch")
    for item in ITEMS:
        assert_item_equal(port_runs[RATE_EVOLVE][item], want[item], item)


def test_nn_entry_point_imports_no_jax(port_runs, tmp_path):
    """A fresh process loads the saved random bundle through the port and
    runs `encode_frame_wavefront2(policy="switch")` on the CPU: the same
    stream and reconstruction as the test's encode, and no module of JAX
    or of the JAX package loaded."""
    key = "synth64x96/switch/live"
    e = golden()["encodes"][key]
    frame_path = tmp_path / "frame.npy"
    np.save(frame_path, frames()[e["frame"]])
    bundle_path = os.path.join(REPO, golden()["bundles"]["random"]["file"])
    code = (
        "import hashlib, json, sys\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from context_adaptive_neural_network_based_prediction_tpu_torch"
        ".models import zoo\n"
        "from context_adaptive_neural_network_based_prediction_tpu_torch"
        ".parallel import wavefront2\n"
        f"b = zoo.load_bundle_npz({bundle_path!r})\n"
        f"f = np.load({str(frame_path)!r})\n"
        f"r = wavefront2.encode_frame_wavefront2(f, {e['qp']},"
        " policy='switch', pnn=b, device='cpu')\n"
        "ref = 'context_adaptive_neural_network_based_prediction_tpu'\n"
        "bad = [m for m in sys.modules if m.startswith('jax')"
        " or m == ref or m.startswith(ref + '.')]\n"
        "print(json.dumps(dict(bad=bad, policy=r.policy,"
        " stream=hashlib.sha256(r.bitstream).hexdigest(),"
        " recon=hashlib.sha256(r.reconstruction.tobytes()).hexdigest())))\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert out["policy"] == "switch"
    assert out["stream"] == sha(port_runs[key]["stream"]) == e["stream"]
    assert out["recon"] == sha(port_runs[key]["recon"]) == e["recon"]
