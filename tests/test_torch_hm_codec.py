"""The port's HM-syntax codec of the host encoder against the JAX package,
live on the CPU, with zero tolerance.

* `hm_decoder.decode_hm_stream` on every stock-HM stream of
  `tests/golden_hm/` (luma and 4:2:0), with the native slice parser
  (`use_native="always"`) and the Python one (`"never"`): the JAX
  decoder's planes and mode map, the stored reconstruction and the
  stream's own picture hash.
* The parser half of `hm_bitstream` (NAL splitting, emulation prevention,
  SPS / PPS / slice header, the hash SEI, the bit reader) gives the JAX
  package's records.
* `hm_encoder.encode_frame_hm` and `encode_frame_hm_420` against the JAX
  package run in `test_torch_hm_codec_encode.py`.
* Chroma deblocking (native and numpy) and the chroma SAO estimate equal
  the JAX package's.
"""

import glob
import os

import numpy as np
import pytest
import torch

from context_adaptive_neural_network_based_prediction_tpu.codec import (
    deblock as j_deblock, hm_bitstream as j_hmb, hm_decoder as j_hm_decoder,
    sao as j_sao)
from context_adaptive_neural_network_based_prediction_tpu_torch.codec import (
    deblock as t_deblock, hm_bitstream as t_hmb, hm_decoder as t_hm_decoder,
    sao as t_sao)
from context_adaptive_neural_network_based_prediction_tpu_torch.evaluation \
    import host_cases

from test_torch_host_encoder import jax_zoo, port_zoo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAMS = sorted(os.path.basename(p) for p in glob.glob(
    os.path.join(REPO, "tests", "golden_hm", "*.bin")))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def zoos():
    """The quantized zoo in both packages (for
    `test_torch_hm_codec_encode.py`)."""
    return {"port": port_zoo(), "jax": jax_zoo()}


def stored_planes(name):
    base = os.path.join(REPO, "tests", "golden_hm", name[:-4])
    if name.startswith("420"):
        with np.load(base + "_rec.npz") as z:
            return z["y"], z["cb"], z["cr"]
    return np.load(base + "_rec.npy"), None, None


def planes(res):
    return (res.reconstruction, res.reconstruction_cb, res.reconstruction_cr)


def assert_planes(got, want, what):
    for g, w, p in zip(got, want, ("y", "cb", "cr")):
        if w is None:
            assert g is None, f"{what} {p}"
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {p}")


@pytest.mark.parametrize("use_native", ["always", "never"])
@pytest.mark.parametrize("name", STREAMS)
def test_decode_stock_hm_stream_matches_jax(name, use_native):
    with open(os.path.join(REPO, "tests", "golden_hm", name), "rb") as f:
        data = f.read()
    got = t_hm_decoder.decode_hm_stream(data, use_native=use_native)
    want = j_hm_decoder.decode_hm_stream(data, use_native=use_native)
    assert got.hash_checked and got.hash_ok
    assert got.qp == want.qp
    assert_planes(planes(got), planes(want), name)
    assert_planes(planes(got), stored_planes(name), f"{name} stored")
    np.testing.assert_array_equal(got.mode_map, want.mode_map)


@pytest.mark.parametrize("name", STREAMS)
def test_parse_stream_matches_jax(name):
    with open(os.path.join(REPO, "tests", "golden_hm", name), "rb") as f:
        data = f.read()
    got, want = t_hmb.parse_stream(data), j_hmb.parse_stream(data)
    for part in ("sps", "pps", "slice_header"):
        assert vars(getattr(got, part)) == vars(getattr(want, part)), part
    assert got.picture_hash == want.picture_hash
    assert ([vars(u) for u in got.nal_units]
            == [vars(u) for u in want.nal_units])
    assert ([vars(u) for u in t_hmb.split_annexb(data)]
            == [vars(u) for u in j_hmb.split_annexb(data)])


@pytest.mark.parametrize("seed", range(3))
def test_bit_reader_and_emulation_prevention_match_jax(seed):
    rng = np.random.default_rng(seed)
    data = bytes(rng.choice([0, 0, 0, 1, 2, 3, 9, 255],
                            size=3000).astype(np.uint8))
    escaped = t_hmb.insert_emulation_prevention(data)
    assert t_hmb.remove_emulation_prevention(escaped) == data
    assert (t_hmb.remove_emulation_prevention(escaped)
            == j_hmb.remove_emulation_prevention(escaped))
    bits = bytes(rng.integers(0, 256, 3000).astype(np.uint8))
    readers = (t_hmb.BitReader(bits), j_hmb.BitReader(bits))
    for _ in range(200):
        kind = int(rng.integers(0, 4))
        n = int(rng.integers(1, 25))
        got = [(r.u(n) if kind == 0 else r.flag() if kind == 1
                else r.ue() if kind == 2 else r.se()) for r in readers]
        assert got[0] == got[1]


def test_decode_hm_stream_refuses_an_unknown_parser():
    with open(os.path.join(REPO, "tests", "golden_hm", STREAMS[0]),
              "rb") as f:
        data = f.read()
    with pytest.raises(ValueError, match="use_native"):
        t_hm_decoder.decode_hm_stream(data, use_native="sometimes")


@pytest.mark.parametrize("qp", [22, 32, 40])
def test_chroma_deblock_matches_jax(qp):
    rng = np.random.default_rng(qp)
    plane = rng.integers(0, 256, (48, 80)).astype(np.uint8)
    tu = rng.integers(0, 5, (24, 40)).astype(np.int32)
    want = j_deblock.deblock_chroma(plane, tu, qp, use_native=False)
    np.testing.assert_array_equal(t_deblock.deblock_chroma(plane, tu, qp),
                                  want)
    np.testing.assert_array_equal(
        t_deblock.deblock_chroma_plain(plane, tu, qp), want)


def test_chroma_sao_estimate_matches_jax():
    cb, cr = host_cases.chroma_planes(96, 160, seed=9)
    rng = np.random.default_rng(1)
    deb_cb = np.clip(cb.astype(int) + rng.integers(-6, 7, cb.shape),
                     0, 255).astype(np.uint8)
    deb_cr = np.clip(cr.astype(int) + rng.integers(-6, 7, cr.shape),
                     0, 255).astype(np.uint8)
    for ctu in (16, 32):
        got = t_sao.estimate_frame_chroma(cb, deb_cb, cr, deb_cr, ctu, 40.0)
        want = j_sao.estimate_frame_chroma(cb, deb_cb, cr, deb_cr, ctu, 40.0)
        for g_grid, w_grid in zip(got, want):
            assert ([[p.key() for p in row] for row in g_grid]
                    == [[p.key() for p in row] for row in w_grid])
