"""The port's tiled v1 encoders over Gloo ranks on the CPU against the
JAX package's on its virtual CPU devices, with zero tolerance.

`parallel/tiled.py` runs one process per rank (`mesh.spawn_ranks`, the
`spawn` start method; each rank imports only the port); the JAX package
runs one SPMD program over `tests/conftest.py`'s 8 virtual devices.  At 2
and 4 ranks, on the frames of `tests/test_parallel.py`:

* `encode_frame_tiled` (independent stripes): reconstruction, modes and
  levels equal the JAX package's, and each stripe equals the port's
  single-device encode of that stripe;
* `encode_frame_tiled_halo` (halo row exchanged every step): equal to the
  JAX package's and to the port's single-device encode of the whole
  frame, where independent stripes differ from it;
* every rank returns the same arrays.

And at 2 ranks `encode_frame_tiled_halo_v2` (the quadtree encoder, CTB
32) under regular and switch (the random quantized bundle of
`tests/golden_torch/w2_nn_random_bundle.npz`) on a 64x64 frame: the
reconstruction, mode map, CU trees and stream equal the JAX package's
and the single-device encode's (`test_torch_tiled_v2.py` has 4 ranks).
"""

import multiprocessing
import os

import numpy as np
import pytest
import torch

import jax

from context_adaptive_neural_network_based_prediction_tpu.codec import (
    nn_intra as j_nn_intra)
from context_adaptive_neural_network_based_prediction_tpu.parallel import (
    mesh as j_mesh, tiled as j_tiled, wavefront2 as j_wavefront2)
from context_adaptive_neural_network_based_prediction_tpu_torch.models import (
    zoo as t_zoo)
from context_adaptive_neural_network_based_prediction_tpu_torch.parallel import (
    mesh as t_mesh, tiled as t_tiled, wavefront as t_wavefront,
    wavefront2 as t_wavefront2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLE = os.path.join(REPO, "tests", "golden_torch",
                      "w2_nn_random_bundle.npz")
RANKS = (2, 4)


def natural(h, w, seed=0):
    """`tests/test_parallel.py`'s frame generator."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    f = (120 + 50 * np.sin(xx / 7.0) + 35 * np.cos(yy / 11.0)
         + rng.normal(0, 5, (h, w)))
    return np.clip(f, 0, 255).astype(np.uint8)


def tiled_frame(n):
    return natural(n * 32, 64, seed=4)


def halo_frame(n):
    return natural(n * 32, 96, seed=7)


def v2_frame():
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:64, 0:64]
    return np.clip(128 + 45 * np.sin(xx / 11.0) + 35 * np.cos(yy / 8.0)
                   + rng.normal(0, 7, (64, 64)), 0, 255).astype(np.uint8)


def tree_items(trees):
    """The CU trees as nested tuples (the decided grids: splits, modes,
    levels), comparable across the two packages."""
    def node(nd):
        pus = tuple((pu.x, pu.y, pu.n, int(pu.mode), tuple(
            (tu.x, tu.y, tu.n, tu.cbf, None if tu.coeffs is None
             else np.asarray(tu.coeffs, np.int32).tobytes())
            for tu in pu.tus)) for pu in nd.pus)
        return (nd.x, nd.y, nd.size, nd.depth, bool(nd.split),
                bool(nd.part_nxn), pus,
                tuple(node(c) for c in nd.children))
    return tuple(node(t) for t in trees)


def assert_same_result(a, b, what):
    np.testing.assert_array_equal(a.reconstruction, b.reconstruction,
                                  err_msg=what)
    np.testing.assert_array_equal(a.mode_map, b.mode_map, err_msg=what)
    assert tree_items(a.ctu_trees) == tree_items(b.ctu_trees), what
    assert a.bitstream == b.bitstream, what


def no_child_left():
    return multiprocessing.active_children() == []


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def port_bundle():
    return t_zoo.load_bundle_npz(BUNDLE)


@pytest.fixture(scope="module")
def jax_bundle(port_bundle):
    return j_nn_intra.PnnBundle(
        {}, {w: False for w in port_bundle.quantized}, 117.9,
        quantized=dict(port_bundle.quantized))


@pytest.fixture(scope="module")
def port_runs(port_bundle):
    """Every rank's results of one spawned group per rank count."""
    out = {}
    for n in RANKS:
        cases = [("encode_frame_tiled", tiled_frame(n), 32,
                  dict(device="cpu")),
                 ("encode_frame_tiled", halo_frame(n), 32,
                  dict(device="cpu")),
                 ("encode_frame_tiled_halo", halo_frame(n), 32,
                  dict(device="cpu"))]
        if n == 2:
            cases += [("encode_frame_tiled_halo_v2", v2_frame(), 32,
                       dict(policy=policy, pnn=pnn, serialize=True,
                            device="cpu"))
                      for policy, pnn in (("regular", None),
                                          ("switch", port_bundle))]
        out[n] = [r[0] for r in t_mesh.spawn_ranks(
            t_tiled.encode_cases, n, device="cpu", args=(cases,),
            timeout=300)]
        assert no_child_left()
    return out


@pytest.fixture(scope="module")
def jax_runs(jax_bundle):
    out = {}
    for n in RANKS:
        m = j_mesh.make_mesh({"data": n}, jax.devices()[:n])
        out[n] = [j_tiled.encode_frame_tiled(tiled_frame(n), 32, m),
                  j_tiled.encode_frame_tiled(halo_frame(n), 32, m),
                  j_tiled.encode_frame_tiled_halo(halo_frame(n), 32, m)]
        if n == 2:
            for policy, pnn in (("regular", None), ("switch", jax_bundle)):
                j_wavefront2._W2_CACHE.clear()
                out[n].append(j_tiled.encode_frame_tiled_halo_v2(
                    v2_frame(), 32, m, policy=policy, pnn=pnn,
                    serialize=True))
                j_wavefront2._W2_CACHE.clear()
    return out


def assert_arrays_equal(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


@pytest.mark.parametrize("n", RANKS)
def test_tiled_equals_jax(port_runs, jax_runs, n):
    for i in (0, 1):
        assert_arrays_equal(port_runs[n][0][i], jax_runs[n][i])


@pytest.mark.parametrize("n", RANKS)
def test_tiled_stripes_are_independent_pictures(port_runs, n):
    frame = tiled_frame(n)
    recon, modes, qcoeffs = port_runs[n][0][0]
    assert recon.shape == frame.shape and recon.dtype == np.uint8
    for t in range(n):
        stripe = frame[t * 32:(t + 1) * 32]
        r, m, q = t_wavefront.encode_frames_wavefront_batch(
            stripe[None], 32, device="cpu")
        np.testing.assert_array_equal(recon[t * 32:(t + 1) * 32], r[0])
        np.testing.assert_array_equal(modes[t * 2:(t + 1) * 2], m[0])
        np.testing.assert_array_equal(qcoeffs[t * 2:(t + 1) * 2], q[0])


@pytest.mark.parametrize("n", RANKS)
def test_halo_equals_jax(port_runs, jax_runs, n):
    assert_arrays_equal(port_runs[n][0][2], jax_runs[n][2])


@pytest.mark.parametrize("n", RANKS)
def test_halo_equals_single_device(port_runs, n):
    frame = halo_frame(n)
    single = t_wavefront.encode_frame_wavefront(frame, 32, serialize=False,
                                                device="cpu")
    recon, modes, qcoeffs = port_runs[n][0][2]
    np.testing.assert_array_equal(recon, single.reconstruction)
    np.testing.assert_array_equal(
        np.repeat(np.repeat(modes, 4, 0), 4, 1), single.mode_map)
    # Independent stripes restart prediction at each stripe's top.
    assert not np.array_equal(port_runs[n][0][1][0], single.reconstruction)


@pytest.mark.parametrize("n", RANKS)
def test_every_rank_returns_the_same(port_runs, n):
    first = port_runs[n][0]
    for other in port_runs[n][1:]:
        for a, b in zip(first[:3], other[:3]):
            assert_arrays_equal(a, b)
        for a, b in zip(first[3:], other[3:]):
            assert_same_result(a, b, "rank")


@pytest.mark.parametrize("policy", ["regular", "switch"])
def test_halo_v2_two_ranks_equals_jax_and_single_device(
        port_runs, jax_runs, port_bundle, policy):
    i = 3 if policy == "regular" else 4
    got = port_runs[2][0][i]
    assert_same_result(got, jax_runs[2][i], f"{policy} vs JAX")
    single = t_wavefront2.encode_frame_wavefront2(
        v2_frame(), 32, policy=policy,
        pnn=port_bundle if policy == "switch" else None, device="cpu")
    assert_same_result(got, single, f"{policy} vs single device")
