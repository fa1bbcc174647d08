"""No module that the harness, the encode paths or the plain reference
load has the top-level name jax, jaxlib, flax or the JAX package's, and
the reference imports nothing of the port: checked in child processes,
by whole top-level names (the port's name begins with the JAX
package's)."""

import os
import subprocess
import sys

import portbench_toy
from benchmark import harness

ROOT = portbench_toy.ROOT
PORT = "context_adaptive_neural_network_based_prediction_tpu_torch"


def _loaded(code):
    out = subprocess.run(
        [sys.executable, "-c", "import sys\n" + code
         + "\nprint('\\n'.join(sorted(sys.modules)))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_the_check_compares_whole_top_level_names():
    mods = {"jax.numpy": 1, f"{PORT}.ops": 1,
            "context_adaptive_neural_network_based_prediction_tpu.codec": 1,
            "jaxtyping": 1, "flax": 1, "numpy": 1}
    assert harness.forbidden_loaded(mods) == [
        "context_adaptive_neural_network_based_prediction_tpu.codec",
        "flax", "jax.numpy"]


def test_a_run_of_a_toy_cell_loads_no_jax(tmp_path):
    root = portbench_toy.make_root(tmp_path, "regular-v1-n16")
    mods = _loaded(
        "import time\nfrom benchmark import harness\n"
        f"r = harness.run('toy', 3, 0.01, False, t_start=time.perf_counter(),"
        f" device='cpu', require_card=False, root={root!r}, log=lambda m: 0)\n"
        "assert r['correct'], r")
    assert harness.forbidden_loaded(dict.fromkeys(mods)) == []
    assert any(m.startswith(PORT + ".") for m in mods)


def test_the_reference_imports_nothing_of_the_port():
    mods = _loaded(
        "from benchmark.reference import wavefront2, wavefront_v1\n"
        "from benchmark import compare, frames, roofline, geometry")
    assert harness.forbidden_loaded(dict.fromkeys(mods)) == []
    assert not [m for m in mods if m.split(".")[0] == PORT]
