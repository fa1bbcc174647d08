"""The port's Annex-B encoders of the host codec against the JAX
package, live on the CPU, with zero tolerance (the encode half of
`test_torch_hm_codec.py`, a file of its own so that it runs beside it).

`hm_encoder.encode_frame_hm` (regular, substitution, switch) and
`encode_frame_hm_420` (regular, switch, and switch with the chroma PNNS
mode forced) give the JAX package's bytes and planes on a 64x64 crop of
the natural frame (chroma from `evaluation/host_cases.chroma_planes`),
with the quantized zoo for the NN policies; the port's HM-syntax decoder
gives every stream back with both parsers (switch 4:2:0: Python;
"always" raises), and stock HM (`artifacts/hm_bin/TAppDecoderStatic`)
decodes the regular streams with "(OK)" and equal planes.
"""

import os
import subprocess

import numpy as np
import pytest

from context_adaptive_neural_network_based_prediction_tpu.codec import (
    chroma_enc as j_chroma_enc, hm_encoder as j_hm_encoder,
    nn_intra as j_nn_intra)
from context_adaptive_neural_network_based_prediction_tpu_torch.codec import (
    chroma_enc as t_chroma_enc, hm_decoder as t_hm_decoder,
    hm_encoder as t_hm_encoder, nn_intra as t_nn_intra)
from context_adaptive_neural_network_based_prediction_tpu_torch.evaluation \
    import host_cases

from test_torch_hm_codec import (assert_planes, few_threads,  # noqa: F401
                                 planes, zoos)
from test_torch_host_encoder import natural64

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HM_DECODER = os.path.join(REPO, "artifacts", "hm_bin", "TAppDecoderStatic")


def hm_decode_planes(stream, h, w, chroma, tmp_path):
    bs, yuv = tmp_path / "s.bin", tmp_path / "r.yuv"
    bs.write_bytes(stream)
    proc = subprocess.run([HM_DECODER, "-b", str(bs), "-o", str(yuv), "-d",
                           "8"], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    raw = np.fromfile(yuv, np.uint8)
    y = raw[:h * w].reshape(h, w)
    if not chroma:
        return proc.stdout, (y, None, None)
    c = (h // 2) * (w // 2)
    cb = raw[h * w:h * w + c].reshape(h // 2, w // 2)
    cr = raw[h * w + c:h * w + 2 * c].reshape(h // 2, w // 2)
    return proc.stdout, (y, cb, cr)


LUMA_CASES = [("regular", 32), ("substitution", 27), ("switch", 37)]


@pytest.mark.parametrize("policy,qp", LUMA_CASES)
def test_encode_frame_hm_matches_jax(zoos, policy, qp, tmp_path):
    frame = natural64()
    j_pnn = t_pnn = None
    if policy != "regular":
        j_pnn = j_nn_intra.PnnPredictor(zoos["jax"])
        t_pnn = t_nn_intra.PnnPredictor(zoos["port"], device="cpu")
    want, want_res = j_hm_encoder.encode_frame_hm(frame, qp, policy=policy,
                                                  pnn=j_pnn)
    got, res = t_hm_encoder.encode_frame_hm(frame, qp, policy=policy,
                                            pnn=t_pnn, device="cpu")
    assert got == want
    np.testing.assert_array_equal(res.reconstruction, want_res.reconstruction)
    for use_native in ("always", "never"):
        dec = t_hm_decoder.decode_hm_stream(
            got, use_native=use_native, policy=policy,
            pnn=zoos["port"] if policy != "regular" else None, device="cpu")
        assert dec.hash_ok, use_native
        np.testing.assert_array_equal(dec.reconstruction, res.reconstruction)
        np.testing.assert_array_equal(dec.mode_map, res.mode_map)
    if policy == "regular":
        out, hm = hm_decode_planes(got, 64, 64, False, tmp_path)
        assert "(OK)" in out, out
        np.testing.assert_array_equal(hm[0], res.reconstruction)


def force_chroma_pnns(self, luma_mode):
    """Every CU's chroma on the PNNS slot (DM of a PNNS luma PU)."""
    return [(3, 35)] if luma_mode != 35 else [(4, 35)]


CHROMA_CASES = [("regular", 32, False), ("switch", 37, False),
                ("switch", 27, True)]


@pytest.mark.parametrize("policy,qp,forced", CHROMA_CASES)
def test_encode_frame_hm_420_matches_jax(zoos, policy, qp, forced, tmp_path,
                                         monkeypatch):
    y = natural64()
    cb, cr = host_cases.chroma_planes(64, 64, seed=5)
    if forced:
        monkeypatch.setattr(j_chroma_enc.ChromaPass, "_candidates",
                            force_chroma_pnns)
        monkeypatch.setattr(t_chroma_enc.ChromaPass, "_candidates",
                            force_chroma_pnns)
    j_pnn = t_pnn = None
    if policy != "regular":
        j_pnn = j_nn_intra.PnnPredictor(zoos["jax"])
        t_pnn = t_nn_intra.PnnPredictor(zoos["port"], device="cpu")
    want = j_hm_encoder.encode_frame_hm_420((y, cb, cr), qp, policy=policy,
                                            pnn=j_pnn)
    got = t_hm_encoder.encode_frame_hm_420((y, cb, cr), qp, policy=policy,
                                           pnn=t_pnn, device="cpu")
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(getattr(g, "reconstruction", g),
                                      getattr(w, "reconstruction", w))
    mine = (got[1].reconstruction, got[2], got[3])
    kw = dict(policy=policy, device="cpu",
              pnn=zoos["port"] if policy != "regular" else None)
    natives = ("always", "never") if policy != "switch" else ("never",
                                                              "auto")
    for use_native in natives:
        dec = t_hm_decoder.decode_hm_stream(got[0], use_native=use_native,
                                            **kw)
        assert dec.hash_ok, use_native
        assert_planes(planes(dec), mine, use_native)
    if policy == "switch":
        with pytest.raises(NotImplementedError):
            t_hm_decoder.decode_hm_stream(got[0], use_native="always", **kw)
    if forced:
        assert t_pnn.forwards["conv"] + t_pnn.forwards["fc"] > 0
    if policy == "regular":
        out, hm = hm_decode_planes(got[0], 64, 64, True, tmp_path)
        assert "(OK)" in out, out
        assert_planes(hm, mine, "stock HM")
