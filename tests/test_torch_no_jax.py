"""The port and `chip_smoke.py` import nothing of JAX and nothing of the
JAX package: a scan of every Python file of the port package and of
`chip_smoke.py` for import statements (and `import_module` / `__import__`
calls) that name `jax`, `jaxlib` or the JAX package."""

import glob
import os
import re

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
