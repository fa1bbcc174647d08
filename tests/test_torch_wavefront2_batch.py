"""Frame batching and the streaming encoder of the port's wavefront encoder.

A batched plan interleaves B frames into the plane axis (plane
`(ROW0 + by) * B + f`), so each frame of a batch must give exactly its own
single-frame encode: reconstruction, the 11 grids of `_assemble_arrays`
and the stream.  The port runs on the CPU (plain trial, plain merger).

* Batches against single-frame port encodes: a 2-frame batch of distinct
  seeded 64x96 frames and a 3-frame batch of distinct 128x128 frames
  (the natural crop `tests/golden_hm/128_full_q32_src.npy` and two
  seeded ones), under regular at QP 32 with rate evolution off and on,
  and under switch and substitution at QP 37 with the random quantized
  bundle of `tests/golden_torch/w2_nn_random_bundle.npz` (conv PNNs at
  widths 8 and 16; `tests/test_torch_wavefront_nn.py` holds it equal to
  the JAX package's quantization).  Rate evolution on is held against
  the port's own single-frame encodes: the JAX package needs its fused
  trial for it, which takes tens of minutes on a CPU, and
  `tests/golden_torch/w2_rate_evolve.json` already holds the port's
  single-frame encodes against the JAX package.
* The 2-frame 64x96 batch against the JAX package's batched program
  (`encode_frames_wavefront2_batch`, its default CPU path, rate evolution
  off), zero tolerance: regular, and switch with the random bundle.
  The 3-frame cases and the check that the switch batches code PNNS PUs
  are in `test_torch_wavefront2_batch3.py`.
* `encode_stream_wavefront2` over 5 frames at batch 2 (two full batches
  and one padded) yields the single-frame results in input order;
  `workers=2` equals `workers=0`, and no worker process outlives the
  generator, whether it ends or is closed early.
"""

import multiprocessing
import os

import numpy as np
import pytest
import torch

from context_adaptive_neural_network_based_prediction_tpu.codec import (
    nn_intra as j_nn_intra)
from context_adaptive_neural_network_based_prediction_tpu.parallel import (
    wavefront2 as j_wavefront2)
from context_adaptive_neural_network_based_prediction_tpu_torch.models import (
    zoo as t_zoo)
from context_adaptive_neural_network_based_prediction_tpu_torch.parallel import (
    wavefront2 as t_wavefront2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLE = os.path.join(REPO, "tests", "golden_torch",
                      "w2_nn_random_bundle.npz")
GRIDS = ("m8", "q8", "s8", "m4", "q4", "m16", "q16", "s16", "m32", "q32",
         "s32")
# name -> (policy, qp, rate_evolve)
CONFIGS = {"regular": ("regular", 32, False),
           "regular_rate_evolve": ("regular", 32, True),
           "switch": ("switch", 37, False),
           "substitution": ("substitution", 37, False)}
BATCHES = {"b2_64x96": 2, "b3_128x128": 3}


def synth(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    f = (128 + 45 * np.sin(xx / (9.0 + seed)) + 35 * np.cos(yy / (6.0 + seed))
         + rng.normal(0, 7, (h, w)))
    return np.clip(f, 0, 255).astype(np.uint8)


def batch_frames(name):
    if name == "b2_64x96":
        return np.stack([synth(64, 96, 5), synth(64, 96, 6)])
    natural = np.load(os.path.join(REPO, "tests", "golden_hm",
                                   "128_full_q32_src.npy"))
    return np.stack([natural, synth(128, 128, 7), synth(128, 128, 8)])


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def port_bundle():
    return t_zoo.load_bundle_npz(BUNDLE)


def pnn_pus(res, policy, widths):
    """PUs coded with the PNN mode (35 under switch; 18 at a width with a
    model under substitution)."""
    count, stack = 0, list(res.ctu_trees)
    while stack:
        node = stack.pop()
        stack.extend(node.children)
        count += sum((policy == "switch" and pu.mode == 35)
                     or (policy == "substitution" and pu.mode == 18
                         and pu.n in widths) for pu in node.pus)
    return count


def port_single(frame, config, bundle):
    policy, qp, rate_evolve = CONFIGS[config]
    pnn = bundle if policy != "regular" else None
    recon, grids = t_wavefront2.encode_arrays_wavefront2(
        frame, qp, policy=policy, pnn=pnn, rate_evolve=rate_evolve,
        device="cpu")
    res = t_wavefront2._arrays_to_result(frame, qp, (recon,) + grids,
                                         policy, True)
    return recon, grids, res.bitstream, pnn_pus(res, policy, (8, 16))


def port_batch(frames, config, bundle):
    policy, qp, rate_evolve = CONFIGS[config]
    pnn = bundle if policy != "regular" else None
    out = []
    for frame, (recon, grids) in zip(frames, (
            t_wavefront2.encode_arrays_wavefront2_batch(
                frames, qp, policy=policy, pnn=pnn, rate_evolve=rate_evolve,
                device="cpu"))):
        res = t_wavefront2._arrays_to_result(frame, qp, (recon,) + grids,
                                             policy, True)
        out.append((recon, grids, res.bitstream,
                    pnn_pus(res, policy, (8, 16))))
    return out


class Encodes(dict):
    """{(config, batch): (singles, batch results)}, each case encoded when
    a test first asks for it (a file encodes only the cases it checks)."""

    def __init__(self, bundle):
        super().__init__()
        self.bundle = bundle

    def __missing__(self, key):
        config, name = key
        frames = batch_frames(name)
        self[key] = (
            [port_single(f, config, self.bundle) for f in frames],
            port_batch(frames, config, self.bundle))
        return self[key]


@pytest.fixture(scope="module")
def encodes(port_bundle):
    return Encodes(port_bundle)


def assert_same_encode(got, want, what):
    np.testing.assert_array_equal(got[0], want[0], err_msg=f"{what} recon")
    for g, a, b in zip(GRIDS, got[1], want[1]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"{what} {g}")
    assert got[2] == want[2], f"{what} stream"


def check_batched_frame(encodes, config, name, frame):
    singles, batch = encodes[config, name]
    assert len(batch) == BATCHES[name]
    assert_same_encode(batch[frame], singles[frame],
                       f"{config} {name} frame {frame}")


# The 3-frame 128x128 cases are in `test_torch_wavefront2_batch3.py`, so
# that the two halves run side by side.
@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("name,frame", [("b2_64x96", f) for f in range(2)])
def test_batched_frame_equals_single_frame(encodes, config, name, frame):
    check_batched_frame(encodes, config, name, frame)


@pytest.fixture(scope="module")
def jax_batch(port_bundle):
    """The JAX package's batched program (its default CPU path: unfused
    trial, rate evolution off) on the 2-frame 64x96 batch, regular at QP
    32 and switch at QP 37 with the random bundle."""
    j_bundle = j_nn_intra.PnnBundle(
        {}, {w: False for w in port_bundle.quantized}, 117.9,
        quantized=dict(port_bundle.quantized))
    frames = batch_frames("b2_64x96")
    out = {}
    for config, bundle in (("regular", None), ("switch", j_bundle)):
        policy, qp, _ = CONFIGS[config]
        j_wavefront2._W2_CACHE.clear()
        res = j_wavefront2.encode_frames_wavefront2_batch(
            frames, qp, policy=policy, pnn=bundle, serialize=True)
        j_wavefront2._W2_CACHE.clear()
        out[config] = res
    return out


@pytest.mark.parametrize("config", ["regular", "switch"])
@pytest.mark.parametrize("frame", [0, 1])
def test_batch_equals_jax_batched_program(encodes, jax_batch, config,
                                          frame):
    want = jax_batch[config][frame]
    recon, grids, stream, _ = encodes[config, "b2_64x96"][1][frame]
    np.testing.assert_array_equal(recon, want.reconstruction)
    assert stream == want.bitstream


def test_batched_plan_refuses_a_single_frame():
    plan, dp = t_wavefront2._get_plan(64, 96, 32, 1.0, 32, True, False,
                                      torch.device("cpu"), n_frames=2)
    assert plan["b_eff"] == 2 * plan["b_max"]
    with pytest.raises(ValueError):
        t_wavefront2.run(plan, dp, synth(64, 96, 5))


STREAM_FRAMES = [synth(64, 96, s) for s in (5, 6, 9, 10, 11)]


@pytest.fixture(scope="module")
def stream_singles(encodes):
    known = dict(zip((5, 6), encodes["regular", "b2_64x96"][0]))
    out = []
    for seed, frame in zip((5, 6, 9, 10, 11), STREAM_FRAMES):
        out.append(known.get(seed) or port_single(frame, "regular", None))
    return out


def test_stream_yields_single_frame_results_in_order(stream_singles):
    got = list(t_wavefront2.encode_stream_wavefront2(
        iter(STREAM_FRAMES), 32, batch=2, device="cpu"))
    assert len(got) == len(STREAM_FRAMES)
    for i, (res, want) in enumerate(zip(got, stream_singles)):
        np.testing.assert_array_equal(res.reconstruction, want[0],
                                      err_msg=f"frame {i}")
        assert res.bitstream == want[2], f"frame {i}"
        assert res.num_bits == 8 * len(want[2])


def test_stream_builds_trees_on_request(stream_singles):
    got = list(t_wavefront2.encode_stream_wavefront2(
        iter(STREAM_FRAMES[:3]), 32, batch=2, build_trees=True,
        device="cpu"))
    assert [r.bitstream for r in got] == [w[2] for w in stream_singles[:3]]
    assert all(len(r.ctu_trees) == 6 and r.mode_map.min() >= 0
               for r in got)


def test_stream_process_pool_equals_in_process_and_shuts_down(
        stream_singles, monkeypatch):
    # The spawned workers read one thread from their environment.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")

    def new_children():
        return set(multiprocessing.active_children()) - before

    before = set(multiprocessing.active_children())
    got = list(t_wavefront2.encode_stream_wavefront2(
        iter(STREAM_FRAMES), 32, batch=2, workers=2, device="cpu"))
    assert new_children() == set()
    assert [r.bitstream for r in got] == [w[2] for w in stream_singles]
    for res, want in zip(got, stream_singles):
        np.testing.assert_array_equal(res.reconstruction, want[0])
    # Closed after its first result: the pool goes with it.
    gen = t_wavefront2.encode_stream_wavefront2(
        iter(STREAM_FRAMES), 32, batch=2, workers=2, device="cpu")
    first = next(gen)
    assert first.bitstream == stream_singles[0][2]
    assert new_children() != set()
    gen.close()
    assert new_children() == set()
