"""The port's whole-slice encode against the JAX package's.

Config: regular policy, QP 32, CTB 32, NxN on, one frame, on the
synthetic 64x96 frame of `scripts/w2_golden.py` (seed 5) and the 128x128
natural crop `tests/golden_hm/128_full_q32_src.npy`.  The port runs on
the CPU (plain trial).

* Rate evolution off: the JAX package's default CPU encode runs live; the
  reconstruction, every grid of `_assemble_arrays` and the stream bytes
  are equal, and the JAX decoder reproduces the port's reconstruction from
  the port's stream.
* Rate evolution on: the JAX package needs its fused trial for it, which
  takes tens of minutes on a CPU, so tier 1 holds the port against sha256
  digests captured once from the JAX package
  (`scripts/capture_torch_port_golden.py` ->
  `tests/golden_torch/w2_rate_evolve.json`); the live comparison is the
  `slow` test.
"""

import contextlib
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
    decoder as j_decoder)
from context_adaptive_neural_network_based_prediction_tpu.parallel import (
    wavefront2 as j_wavefront2)
from context_adaptive_neural_network_based_prediction_tpu_torch.codec import (
    native as t_native)
from context_adaptive_neural_network_based_prediction_tpu_torch.parallel import (
    wavefront2 as t_wavefront2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden_torch", "w2_rate_evolve.json")
QP = 32
GRIDS = ("m8", "q8", "s8", "m4", "q4", "m16", "q16", "s16", "m32", "q32",
         "s32")
ITEMS = ("recon",) + GRIDS + ("stream",)
FRAME_NAMES = ("synth64x96", "natural128")


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


def as_items(recon, grids, stream):
    out = {"recon": np.asarray(recon, np.uint8), "stream": stream}
    out.update(zip(GRIDS, grids))
    return out


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def port_encode(frame, rate_evolve):
    recon, grids = t_wavefront2.encode_arrays_wavefront2(
        frame, QP, rate_evolve=rate_evolve, device="cpu")
    res = t_wavefront2._arrays_to_result(frame, QP, (recon,) + grids,
                                         "regular", True)
    return as_items(recon, grids, res.bitstream)


def jax_encode(frame, rate_evolve, op_by_op=False):
    """The JAX package's encode with the same config (its default CPU path
    when rate evolution is off).  `op_by_op` runs it under
    `jax.disable_jit()`, which skips the whole-program compile."""
    h, w = frame.shape
    j_wavefront2._W2_CACHE.clear()   # the fused impl is not in its key
    run = j_wavefront2._jitted_wavefront2(h, w, QP, ctb=32, enable_nxn=True,
                                          rate_evolve=rate_evolve)
    with jax.disable_jit() if op_by_op else contextlib.nullcontext():
        recon, ys = run(jnp.asarray(frame))
        recon = np.asarray(recon)
    grids = j_wavefront2._assemble_arrays(ys, h, w, 32)
    res = j_wavefront2._arrays_to_result(frame, QP, (recon,) + grids,
                                         "regular", True)
    j_wavefront2._W2_CACHE.clear()
    return as_items(recon, grids, res.bitstream)


@pytest.fixture(scope="module")
def jax_off():
    return {name: jax_encode(f, False) for name, f in frames().items()}


@pytest.fixture(scope="module")
def port_off():
    return {name: port_encode(f, False) for name, f in frames().items()}


@pytest.fixture(scope="module")
def port_on():
    return {name: port_encode(f, True) for name, f in frames().items()}


def assert_item_equal(got, want, what):
    if isinstance(want, (bytes, bytearray)):
        assert got == want, f"{what}: {len(got)} vs {len(want)} bytes"
    else:
        assert got.shape == want.shape, what
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("item", ITEMS)
@pytest.mark.parametrize("name", FRAME_NAMES)
def test_encode_matches_jax(jax_off, port_off, name, item):
    assert_item_equal(port_off[name][item], jax_off[name][item],
                      f"{name} {item}")


@pytest.mark.parametrize("name", FRAME_NAMES)
def test_jax_decoder_reads_port_stream(port_off, name):
    dec = j_decoder.decode_frame(port_off[name]["stream"])
    np.testing.assert_array_equal(np.asarray(dec.reconstruction),
                                  port_off[name]["recon"])


@pytest.mark.parametrize("item", ITEMS)
@pytest.mark.parametrize("name", FRAME_NAMES)
def test_rate_evolve_matches_jax_digests(port_on, name, item):
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert golden["config"] == {"policy": "regular", "qp": QP, "ctb": 32,
                                "enable_nxn": True, "rate_evolve": True,
                                "impl": "xla"}
    got = port_on[name][item]
    if item in GRIDS:
        got = np.asarray(got, np.int32)
    assert sha(got) == golden["frames"][name][item], f"{name} {item}"


@pytest.mark.parametrize("name", FRAME_NAMES)
def test_rate_evolve_changes_the_encode(port_off, port_on, name):
    """Live rate evolution steers decisions: the streams differ."""
    assert port_on[name]["stream"] != port_off[name]["stream"]


@pytest.mark.slow
@pytest.mark.parametrize("name", FRAME_NAMES)
def test_rate_evolve_matches_jax_live(port_on, name):
    """Live JAX-vs-port with rate evolution.  The JAX package's fused-trial
    program does not finish compiling in an hour on a CPU, so it runs op
    by op (as `scripts/capture_torch_port_golden.py` does): 8 and 15
    minutes for the two frames, hence `slow`."""
    old = os.environ.get("CANP_FUSED_UNIT")
    os.environ["CANP_FUSED_UNIT"] = "xla"
    try:
        want = jax_encode(frames()[name], True, op_by_op=True)
    finally:
        if old is None:
            del os.environ["CANP_FUSED_UNIT"]
        else:
            os.environ["CANP_FUSED_UNIT"] = old
    for item in ITEMS:
        assert_item_equal(port_on[name][item], want[item], f"{name} {item}")


def test_entry_point_imports_no_jax(port_off, tmp_path):
    """A fresh process imports the port and runs the user entry point,
    `encode_frame_wavefront2`, on the CPU: same stream and reconstruction
    as the test's encode, and no module of JAX or of the JAX package is
    loaded."""
    frame_path = tmp_path / "frame.npy"
    np.save(frame_path, frames()["synth64x96"])
    code = (
        "import hashlib, json, sys\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from context_adaptive_neural_network_based_prediction_tpu_torch"
        ".parallel import wavefront2\n"
        f"f = np.load({str(frame_path)!r})\n"
        "r = wavefront2.encode_frame_wavefront2(f, 32, device='cpu')\n"
        "ref = 'context_adaptive_neural_network_based_prediction_tpu'\n"
        "bad = [m for m in sys.modules if m.startswith('jax')"
        " or m == ref or m.startswith(ref + '.')]\n"
        "print(json.dumps(dict(bad=bad, n_trees=len(r.ctu_trees),"
        " bits=r.num_bits, modes=[int(r.mode_map.min()),"
        " int(r.mode_map.max())],"
        " stream=hashlib.sha256(r.bitstream).hexdigest(),"
        " recon=hashlib.sha256(r.reconstruction.tobytes()).hexdigest())))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    want = port_off["synth64x96"]
    assert out["stream"] == sha(want["stream"])
    assert out["recon"] == sha(want["recon"])
    assert out["bits"] == 8 * len(want["stream"])
    assert out["n_trees"] == (64 // 32) * (96 // 32)
    assert 0 <= out["modes"][0] <= out["modes"][1] <= 34


def test_native_packer_builds_outside_native_dir():
    so = os.path.join(REPO, "native", "libcabac_pack.so")
    before = sha(open(so, "rb").read())
    path = t_native.build()
    assert path.startswith(os.path.join(
        REPO, "context_adaptive_neural_network_based_prediction_tpu_torch",
        "_build"))
    t_native.load_library()
    assert sha(open(so, "rb").read()) == before


def test_box_refuses_to_clamp():
    buf = torch.zeros((3, 4, 5))
    assert t_wavefront2._box(buf, 1, 2, 0, 4, 2, 3).shape == (2, 4, 3)
    for args in ((2, 2, 0, 1, 0, 1), (0, 1, -1, 2, 0, 1),
                 (0, 1, 0, 1, 3, 3)):
        with pytest.raises(IndexError):
            t_wavefront2._box(buf, *args)


@pytest.mark.parametrize("kwargs", [dict(policy="switch"), dict(ctb=64),
                                    dict(n_frames=4)])
def test_unported_configs_raise(kwargs):
    """CTB 64 and frame batching are not ported; an NN policy without a
    PNN bundle is refused, as the JAX package refuses it."""
    want = ValueError if "policy" in kwargs else NotImplementedError
    with pytest.raises(want):
        t_wavefront2._build_wavefront2(64, 128, QP, **kwargs)
