"""The port's Annex-B (HM syntax) writer against the JAX package's, and
stock HM-16.15 decoding the port's streams, with zero tolerance.

* `BitWriter` (u(n), ue(v), se(v), trailing bits), `_write_ptl` and
  emulation prevention give the JAX package's bytes on seeded sequences;
  `write_sps` and `write_pps` too, over their options.
* The port's `CabacEncoder` gives the JAX package's bytes and context
  states on seeded bin sequences (context, bypass, multi-bin bypass and
  terminating bins, `finish` and `terminate_and_finish`), and
  `encode_coefficients` / `encode_intra_mode` on seeded blocks and modes.
* `serialize_hm_slice` and `assemble_hm_stream` give the JAX package's
  bytes on the same decided trees and SAO grids.
* `encode_frame_wavefront2_hm` gives the streams and reconstructions of
  `tests/golden_torch/w2_hm.json` (`scripts/capture_torch_port_golden_ctb64.py
  --set hm`): the three policies at CTB 32 and 64, loop filters on and
  off.
* Stock HM (`artifacts/hm_bin/TAppDecoderStatic`) decodes the port's
  regular streams at CTB 32 and 64, reports its hash check "(OK)" and
  writes the port's reconstruction; the JAX package's
  `hm_decoder.decode_hm_stream(..., policy=, pnn=)` decodes the port's NN
  streams to the port's reconstruction.

The checks of the encodes (the last three points) are defined here and
run in `test_torch_hm_stream_ctb32.py`, `_ctb64.py` and `_smooth.py`.
"""

import copy
import hashlib
import json
import os
import subprocess

import numpy as np
import pytest
import torch

from context_adaptive_neural_network_based_prediction_tpu.codec import (
    cabac as j_cabac, contexts as j_contexts, hm_bitstream as j_hmb,
    hm_decoder as j_hm_decoder, hm_encoder as j_hm_encoder,
    nn_intra as j_nn_intra, sao as j_sao, syntax as j_syntax)
from context_adaptive_neural_network_based_prediction_tpu.models import (
    pnn_q as j_pnn_q)
from context_adaptive_neural_network_based_prediction_tpu_torch.codec import (
    cabac as t_cabac, contexts as t_contexts, hm_bitstream as t_hmb,
    hm_encoder as t_hm_encoder, rdo as t_rdo, sao as t_sao,
    syntax as t_syntax)
from context_adaptive_neural_network_based_prediction_tpu_torch.parallel import (
    wavefront2 as t_wavefront2)

from test_torch_wavefront2_ctb64 import (frames, mean_training, port_bundle,
                                         sha)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden_torch", "w2_hm.json")
HM_DECODER = os.path.join(REPO, "artifacts", "hm_bin", "TAppDecoderStatic")
FROZEN = os.path.join(REPO, "artifacts", "frozen")


def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ------------------------------------------------------------ bit level --

@pytest.mark.parametrize("seed", range(4))
def test_bit_writer_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(300):
        kind = int(rng.integers(0, 4))
        if kind == 0:
            n = int(rng.integers(1, 33))
            ops.append(("u", int(rng.integers(0, 2 ** n)), n))
        elif kind == 1:
            ops.append(("flag", int(rng.integers(0, 2))))
        elif kind == 2:
            ops.append(("ue", int(rng.integers(0, 70000))))
        else:
            ops.append(("se", int(rng.integers(-40000, 40000))))
    ptl = (int(rng.integers(0, 32)), int(rng.integers(0, 256)),
           int(rng.integers(0, 2 ** 32)), int(rng.integers(0, 2 ** 44)))
    outs = []
    for mod in (j_hmb, t_hmb):
        w = mod.BitWriter()
        for op in ops:
            getattr(w, op[0])(*op[1:])
        mod._write_ptl(w, *ptl)
        w.rbsp_trailing()
        outs.append(w.to_bytes())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("seed", range(4))
def test_emulation_prevention_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    # Many zero runs, so every 00 00 0x case occurs.
    data = bytes(rng.choice([0, 0, 0, 1, 2, 3, 4, 255],
                            size=4000).astype(np.uint8))
    got = t_hmb.insert_emulation_prevention(data)
    assert got == j_hmb.insert_emulation_prevention(data)
    assert j_hmb.remove_emulation_prevention(got) == data


@pytest.mark.parametrize("seed", range(3))
def test_picture_checksum_matches_jax(seed):
    rng = np.random.default_rng(seed)
    plane = rng.integers(0, 256, (72 + 8 * seed, 300), dtype=np.uint8)
    assert t_hmb.picture_checksum(plane) == j_hmb.picture_checksum(plane)


@pytest.mark.parametrize("ctu", [32, 64])
@pytest.mark.parametrize("sao,depth,smooth", [
    (True, 0, True), (False, 0, True), (True, 1, False), (False, 2, True)])
def test_sps_matches_jax(ctu, sao, depth, smooth):
    for w, h in ((128, 64), (1920, 1024), (1920, 1056)):
        kw = dict(sao=sao, max_tu_depth=depth, strong_intra_smoothing=smooth,
                  ctu_size=ctu)
        assert t_hm_encoder.write_sps(w, h, **kw) == j_hm_encoder.write_sps(
            w, h, chroma_format_idc=0, **kw)
    assert t_hm_encoder.VPS_RBSP == j_hm_encoder.VPS_RBSP
    assert t_hm_encoder.PTL_BYTES == j_hm_encoder.PTL_BYTES


@pytest.mark.parametrize("sign_hiding", [True, False])
@pytest.mark.parametrize("transform_skip", [True, False])
@pytest.mark.parametrize("deblocking", [True, False])
def test_pps_matches_jax(sign_hiding, transform_skip, deblocking):
    kw = dict(sign_hiding=sign_hiding, transform_skip=transform_skip,
              deblocking=deblocking)
    assert t_hm_encoder.write_pps(**kw) == j_hm_encoder.write_pps(**kw)


@pytest.mark.parametrize("nal_type", [32, 33, 34, 19, 40])
def test_nal_matches_jax(nal_type):
    rbsp = bytes(np.random.default_rng(nal_type).choice(
        [0, 0, 1, 3, 200], size=200).astype(np.uint8))
    for long_start in (True, False):
        assert (t_hm_encoder._nal(nal_type, rbsp, long_start=long_start)
                == j_hm_encoder._nal(nal_type, rbsp, long_start=long_start))


# ---------------------------------------------------------------- CABAC --

def bin_ops(rng, n_ops, n_ctx):
    ops = []
    for _ in range(n_ops):
        kind = int(rng.integers(0, 10))
        if kind < 6:
            # Skewed bins, so states run towards both ends.
            ops.append(("bin", int(rng.random() < 0.2 + 0.6 * (kind & 1)),
                        int(rng.integers(0, n_ctx))))
        elif kind < 8:
            ops.append(("ep", int(rng.integers(0, 2))))
        elif kind == 8:
            n = int(rng.integers(1, 17))
            ops.append(("eps", int(rng.integers(0, 2 ** n)), n))
        else:
            # A terminating 1 ends a slice: terminate_and_finish codes it.
            ops.append(("trm", 0))
    return ops


def run_ops(mod, ops, ctx, terminate):
    enc = mod.CabacEncoder()
    for op in ops:
        if op[0] == "bin":
            enc.encode_bin(op[1], ctx, op[2])
        elif op[0] == "ep":
            enc.encode_bin_ep(op[1])
        elif op[0] == "eps":
            enc.encode_bins_ep(op[1], op[2])
        else:
            enc.encode_bin_trm(op[1])
    return enc.terminate_and_finish() if terminate else enc.finish()


@pytest.mark.parametrize("terminate", [True, False])
@pytest.mark.parametrize("seed", range(5))
def test_cabac_encoder_matches_jax(seed, terminate):
    rng = np.random.default_rng(seed)
    qp = int(rng.integers(22, 43))
    ops = bin_ops(rng, 5000, 40)
    j_ctx = j_contexts.make_context_states(qp)
    t_ctx = t_contexts.make_context_states(qp).tolist()
    want = run_ops(j_cabac, ops, j_ctx, terminate)
    got = run_ops(t_cabac, ops, t_ctx, terminate)
    assert got == want
    assert t_ctx == j_ctx.tolist()
    # The port's decoder reads the bins back.
    if terminate:
        dec = t_cabac.CabacDecoder(got)
        d_ctx = t_contexts.make_context_states(qp).tolist()
        for op in ops:
            if op[0] == "bin":
                assert dec.decode_bin(d_ctx, op[2]) == op[1]
            elif op[0] == "ep":
                assert dec.decode_bin_ep() == op[1]
            elif op[0] == "eps":
                assert dec.decode_bins_ep(op[2]) == op[1]
            else:
                assert dec.decode_bin_trm() == op[1]


def coeff_block(rng, n):
    q = np.zeros((n, n), np.int32)
    k = int(rng.integers(1, n * n // 2 + 2))
    pos = rng.choice(n * n, size=k, replace=False)
    mag = np.where(rng.random(k) < 0.8, rng.integers(1, 4, k),
                   rng.integers(1, 300, k))
    q.reshape(-1)[pos] = mag * rng.choice([-1, 1], k)
    return q


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("sign_hiding", [True, False])
def test_encode_coefficients_matches_jax(n, sign_hiding):
    outs, ctxs = [], []
    for mod, cmod in ((j_cabac, j_contexts), (t_cabac, t_contexts)):
        syn = j_syntax if mod is j_cabac else t_syntax
        r = np.random.default_rng(n + 7 * sign_hiding)
        enc = mod.CabacEncoder()
        ctx = cmod.make_context_states(32)
        for _ in range(40):
            q = coeff_block(r, n)
            mode = int(r.integers(0, 35))
            syn.encode_coefficients(enc, ctx, q, mode, sign_hiding)
            mpms = syn.mpm_candidates(int(r.integers(0, 35)),
                                      int(r.integers(0, 35)))
            syn.encode_intra_mode(enc, ctx, int(r.integers(0, 35)), mpms)
        outs.append(enc.terminate_and_finish())
        ctxs.append(np.asarray(ctx).tolist())
    assert outs[0] == outs[1]
    assert ctxs[0] == ctxs[1]


# --------------------------------------------------- slices and streams --

class HmEncodes(dict):
    """The port's `encode_frame_wavefront2_hm` of `w2_hm.json` entries on
    the CPU, {key: (stream, EncodeResult)}, each made when a test first
    asks for it (a file encodes only the entries it checks).

    The loop filters are post-passes over the decisions, so the `lf` and
    `nolf` entries of one configuration share one device encode
    (`encode_frame_wavefront2`, which `encode_frame_wavefront2_hm` calls):
    it runs once, and each call gets a copy of its result."""

    def __init__(self):
        super().__init__()
        self.bundles = {}
        self.device_encodes = {}

    def __missing__(self, key):
        e = golden()["encodes"][key]
        pnn = None
        if e["policy"] != "regular":
            if e["bundle"] not in self.bundles:
                self.bundles[e["bundle"]] = port_bundle(e["bundle"])
            pnn = self.bundles[e["bundle"]]
        inner = t_wavefront2.encode_frame_wavefront2

        def shared(frame, qp, **kw):
            k = (frame.tobytes(), qp, kw["policy"], id(kw["pnn"]), kw["ctb"])
            if k not in self.device_encodes:
                self.device_encodes[k] = inner(frame, qp, **kw)
            return copy.deepcopy(self.device_encodes[k])

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(t_wavefront2, "encode_frame_wavefront2", shared)
            self[key] = t_wavefront2.encode_frame_wavefront2_hm(
                frames()[e["frame"]], e["qp"],
                loop_filters=e["loop_filters"], policy=e["policy"],
                pnn=pnn, ctb=e["ctb"], device="cpu")
        return self[key]


@pytest.fixture(scope="module")
def hm_encodes():
    return HmEncodes()


# The checks of the encodes; the tests that run them are in
# `test_torch_hm_stream_ctb32.py`, `_ctb64.py` and `_smooth.py`, each a
# part of the entries, so that they run side by side.
def keys(prefix, pred=lambda k: True):
    return [k for k in sorted(golden()["encodes"])
            if k.startswith(prefix) and pred(k)]


def check_digests(hm_encodes, key):
    want = golden()["encodes"][key]
    stream, res = hm_encodes[key]
    assert len(stream) == want["stream_len"]
    assert sha(stream) == want["stream"]
    assert sha(np.asarray(res.reconstruction, np.uint8)) == want["recon"]
    assert sha(np.asarray(res.mode_map, np.int32)) == want["mode_map"]
    assert res.num_bits == 8 * len(stream) and res.bitstream == stream
    if key.endswith("/lf"):
        # The nolf twin shares the device encode: the same decisions.
        twin = key[:-len("lf")] + "nolf"
        if twin in golden()["encodes"]:
            assert (golden()["encodes"][twin]["mode_map"]
                    == want["mode_map"])


def check_serialize_hm_slice(hm_encodes, key):
    """The slice serialiser and the stream assembly of both packages on
    the same trees and SAO grid (the port's, re-estimated)."""
    e = golden()["encodes"][key]
    _, res = hm_encodes[key]
    fr = frames()[e["frame"]]
    grid = t_sao.estimate_frame(fr, res.reconstruction, e["ctb"],
                                t_rdo.lambda_for_qp(e["qp"]))
    j_grid = [[j_sao.SaoParams(p.mode, p.type_aux, p.offsets) for p in row]
              for row in grid]
    h, w = fr.shape
    for depth in (0, 1):
        kw = dict(width=w, height=h, qp=e["qp"], policy=e["policy"],
                  ctu_size=e["ctb"], sign_hiding=True, max_tu_depth=depth,
                  transform_skip=False)
        got = t_hm_encoder.serialize_hm_slice(res.ctu_trees, sao_grid=grid,
                                              **kw)
        want = j_hm_encoder.serialize_hm_slice(res.ctu_trees,
                                               sao_grid=j_grid, **kw)
        assert got == want
    kw = dict(sao_enabled=True, deblocking=True, sign_hiding=True,
              transform_skip=False, max_tu_depth=0, ctu_size=e["ctb"])
    assert (t_hm_encoder.assemble_hm_stream(res, sao_grid=grid, **kw)
            == j_hm_encoder.assemble_hm_stream(res, sao_grid=j_grid, **kw))
    assert (t_hm_encoder.write_decoded_picture_hash_sei(res.reconstruction)
            == j_hm_encoder.write_decoded_picture_hash_sei(
                res.reconstruction))


def hm_decode(stream, h, w, tmp_path):
    bs, yuv = tmp_path / "s.bin", tmp_path / "r.yuv"
    bs.write_bytes(stream)
    proc = subprocess.run([HM_DECODER, "-b", str(bs), "-o", str(yuv), "-d",
                           "8"], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    luma = np.fromfile(yuv, np.uint8)
    assert luma.size == h * w
    return proc.stdout, luma.reshape(h, w)


def check_stock_hm(hm_encodes, key, tmp_path):
    stream, res = hm_encodes[key]
    out, luma = hm_decode(stream, *res.reconstruction.shape, tmp_path)
    assert "(OK)" in out, out
    np.testing.assert_array_equal(luma, res.reconstruction)


@pytest.fixture(scope="module")
def jax_bundles():
    from test_torch_wavefront_nn import jax_random_bundle

    quantized = {w: j_pnn_q.load_quantized(os.path.join(
        FROZEN, f"qpnn_w{w}_single.npz")) for w in (4, 8, 16, 32)}
    frozen = j_nn_intra.PnnBundle(
        {}, {w: str(q["kind"]) == "fc" for w, q in quantized.items()},
        mean_training(), quantized=quantized)
    return {"random": jax_random_bundle(), "frozen_singles": frozen}


def check_jax_hm_decoder(hm_encodes, jax_bundles, key):
    e = golden()["encodes"][key]
    stream, res = hm_encodes[key]
    dec = j_hm_decoder.decode_hm_stream(
        stream, policy=e["policy"],
        pnn=j_nn_intra.PnnPredictor(jax_bundles[e["bundle"]]),
        use_native="never")
    assert dec.hash_ok
    np.testing.assert_array_equal(dec.reconstruction, res.reconstruction)
