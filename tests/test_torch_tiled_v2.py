"""The port's tiled quadtree encoder, `encode_frame_tiled_halo_v2`, over 4
Gloo ranks on the CPU against the JAX package's on 4 virtual CPU devices
and against the single-device encode, with zero tolerance; its refusals;
and the rank launcher's failure handling.

The frame and bundle are `tests/test_wavefront_nn.py`'s halo test's: the
synthetic 64x96 frame (seed 5), its left 64 columns stacked twice
(128x64, one CTB row a rank), QP 32, regular and switch with the random
quantized bundle (`tests/golden_torch/w2_nn_random_bundle.npz`, conv
PNNs at widths 8 and 16, quantized by the JAX package).  The
reconstruction, mode map, CU trees (every decided grid) and stream must
equal the JAX package's and the port's single-device
`encode_frame_wavefront2`, on every rank.
"""

import multiprocessing
import os
import time

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
    mesh as t_mesh, tiled as t_tiled, wavefront2 as t_wavefront2)

from test_torch_tiled import assert_same_result

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLE = os.path.join(REPO, "tests", "golden_torch",
                      "w2_nn_random_bundle.npz")
POLICIES = ("regular", "switch")


def frame128x64():
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:64, 0:96]
    frame = np.clip(128 + 45 * np.sin(xx / 11.0) + 35 * np.cos(yy / 8.0)
                    + rng.normal(0, 7, (64, 96)), 0, 255).astype(np.uint8)
    return np.vstack([frame[:, :64], frame[:, :64]])


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


def pnn_of(policy, bundle):
    return bundle if policy == "switch" else None


@pytest.fixture(scope="module")
def port_ranks(port_bundle):
    """Every rank's (results, kernel launches) of one group of 4."""
    cases = [("encode_frame_tiled_halo_v2", frame128x64(), 32,
              dict(policy=p, pnn=pnn_of(p, port_bundle), serialize=True,
                   device="cpu")) for p in POLICIES]
    out = t_mesh.spawn_ranks(t_tiled.encode_cases, 4, device="cpu",
                             args=(cases,), timeout=300)
    assert multiprocessing.active_children() == []
    return out


@pytest.fixture(scope="module")
def jax_results(jax_bundle):
    m = j_mesh.make_mesh({"data": 4}, jax.devices()[:4])
    out = {}
    for p in POLICIES:
        j_wavefront2._W2_CACHE.clear()
        out[p] = j_tiled.encode_frame_tiled_halo_v2(
            frame128x64(), 32, m, policy=p, pnn=pnn_of(p, jax_bundle),
            serialize=True)
        j_wavefront2._W2_CACHE.clear()
    return out


@pytest.mark.parametrize("policy", POLICIES)
def test_halo_v2_equals_jax(port_ranks, jax_results, policy):
    got = port_ranks[0][0][POLICIES.index(policy)]
    assert_same_result(got, jax_results[policy], f"{policy} vs JAX")
    assert got.policy == policy and got.num_bits == 8 * len(got.bitstream)


@pytest.mark.parametrize("policy", POLICIES)
def test_halo_v2_equals_single_device(port_ranks, port_bundle, policy):
    single = t_wavefront2.encode_frame_wavefront2(
        frame128x64(), 32, policy=policy, pnn=pnn_of(policy, port_bundle),
        device="cpu")
    for r, (results, _) in enumerate(port_ranks):
        assert_same_result(results[POLICIES.index(policy)], single,
                           f"{policy} rank {r} vs single device")


def test_halo_v2_switch_codes_pnn_units(port_ranks):
    """The switch encode is not a regular one in disguise: it codes PNNS
    (mode 35) somewhere."""
    res = port_ranks[0][0][1]
    assert (res.mode_map == 35).any()


def test_stripe_plans_pick_the_interior_tables(port_bundle):
    """A stripe below the first reads the interior table variant (its top
    CTB row has a coded row above), the first stripe the frame's top."""
    kw = dict(policy="switch", bundle=port_bundle, halo=True, n_tiles=4)
    top = t_wavefront2._build_wavefront2(32, 64, 32, **kw, stripe=0)
    inner = t_wavefront2._build_wavefront2(32, 64, 32, **kw, stripe=2)
    assert (top["variant"], inner["variant"]) == (0, 1)
    assert (top["t_offset"], inner["t_offset"]) == (0, 4)
    assert top["n_steps_run"] == inner["n_steps_run"] == 1 + 2 * 3 + 1
    for n in (4, 8, 16, 32):
        c = inner["size_consts"][n]
        assert c["cmap"].shape[0] == c["smap"].shape[0] == 2
        assert not np.array_equal(c["smap"][0], c["smap"][1])


@pytest.mark.parametrize("refused", ["ctb64", "n_frames", "rate_evolve"])
def test_halo_refusals_match_jax(refused, port_bundle, jax_bundle):
    kw = {"ctb64": dict(ctb=64), "n_frames": dict(n_frames=2),
          "rate_evolve": dict(rate_evolve=True)}[refused]
    with pytest.raises(NotImplementedError):
        j_wavefront2._build_wavefront2(64, 64, 32, 1.0, "regular", None,
                                       halo_axis="data", n_tiles=2, **kw)
    with pytest.raises(NotImplementedError):
        t_wavefront2._build_wavefront2(64, 64, 32, halo=True, n_tiles=2,
                                       **kw)


def test_uneven_stripes_are_refused_on_every_rank():
    """A height that does not split into whole-CTB-row stripes raises in
    the JAX package and in every rank; the error reaches the caller and
    no rank is left running."""
    frame = frame128x64()[:96]
    with pytest.raises(ValueError, match="whole-CTB-row stripes"):
        j_tiled.encode_frame_tiled_halo_v2(
            frame, 32, j_mesh.make_mesh({"data": 2}, jax.devices()[:2]))
    with pytest.raises(RuntimeError, match="whole-CTB-row stripes"):
        t_mesh.spawn_ranks(t_tiled.encode_cases, 2, device="cpu",
                           args=([("encode_frame_tiled_halo_v2", frame, 32,
                                   dict(device="cpu"))],), timeout=120)
    assert multiprocessing.active_children() == []


def test_a_failing_rank_stops_the_group():
    """Rank 1 raises while ranks 0 and 2 wait in an all-reduce: its
    traceback reaches the caller at once, and the waiting ranks are
    terminated."""
    assert t_mesh.spawn_ranks(t_mesh.check_group, 3, device="cpu",
                              timeout=120) == [
        (0, 3, 3), (1, 3, 3), (2, 3, 3)]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 3 failed(.|\n)*"
                                           "failed on purpose"):
        t_mesh.spawn_ranks(t_mesh.check_group, 3, device="cpu", args=(1,),
                           timeout=120)
    assert time.monotonic() - t0 < 60
    assert multiprocessing.active_children() == []


def test_spawn_ranks_runs_only_the_ports_functions():
    with pytest.raises(ValueError, match="functions of"):
        t_mesh.spawn_ranks(print, 2)
    assert multiprocessing.active_children() == []
