"""The port and `chip_smoke.py` import nothing of JAX and nothing of the
JAX package: a scan of every Python file of the port package and of
`chip_smoke.py` for import statements (and `import_module` / `__import__`
calls) that name `jax`, `jaxlib` or the JAX package, and a fresh process
that runs the CTB-64 Annex-B path and the loop-filtered decode and loads
neither."""

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
FORBIDDEN = rf"(jax|jaxlib|{REF})(?![\w])"
PATTERNS = (
    re.compile(rf"^\s*import\s+([\w.]+\s*(as\s+\w+)?\s*,\s*)*{FORBIDDEN}",
               re.M),
    re.compile(rf"^\s*from\s+{FORBIDDEN}[\w.]*\s+import\b", re.M),
    re.compile(rf"(import_module|__import__)\(\s*[\"']{FORBIDDEN}"),
)
FILES = sorted(glob.glob(os.path.join(REPO, PORT, "**", "*.py"),
                         recursive=True)) + [os.path.join(REPO,
                                                          "chip_smoke.py")]


def offending(text):
    return [m.group(0).strip() for p in PATTERNS for m in p.finditer(text)]


@pytest.mark.parametrize("path", [os.path.relpath(f, REPO) for f in FILES])
def test_no_jax_import(path):
    with open(os.path.join(REPO, path)) as f:
        assert offending(f.read()) == []


def test_the_scan_finds_what_it_looks_for():
    for bad in ("import jax\n", "import numpy as np, jax.numpy as jnp\n",
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
        "import numpy as np\n"
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
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == [] and out["n"] > 0 and out["shape"] == [64, 128]
