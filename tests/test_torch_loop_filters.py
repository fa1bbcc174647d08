"""The port's loop filters against the JAX package's, with zero tolerance.

* `deblock.deblock_luma` (the native filter, `native/hm_parse.cpp:1554`)
  and its numpy twin `deblock_luma_plain` equal the JAX package's
  `deblock_luma(..., use_native=False)` on seeded reconstructions and TU
  maps, at QPs 10 (beta 0: no filtering), 22, 32, 37 and 51; a native
  failure raises, it does not fall back.
* `sao.estimate_frame`, `apply_sao` and the `encode_params` /
  `decode_params` round trip equal the JAX package's, CTB 32 and 64.
* The port's decoder gives the JAX decoder's reconstruction on the JAX
  package's `encoder.encode_frame` streams with its defaults (deblocking
  and SAO on).
"""

import numpy as np
import pytest
import torch

from context_adaptive_neural_network_based_prediction_tpu.codec import (
    cabac as j_cabac, contexts as j_contexts, decoder as j_decoder,
    deblock as j_deblock, encoder as j_encoder, rdo as j_rdo, sao as j_sao)
from context_adaptive_neural_network_based_prediction_tpu_torch.codec import (
    cabac as t_cabac, contexts as t_contexts, deblock as t_deblock,
    decoder as t_decoder, native as t_native, rdo as t_rdo, sao as t_sao)

from test_torch_wavefront2_ctb64 import frames


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def blocky(rng, h, w):
    """A reconstruction with blocking edges and a random TU map of 4- to
    32-sample square TUs."""
    base = frames()["natural128"].astype(np.int32)
    img = np.tile(base, (h // 128 + 1, w // 128 + 1))[:h, :w]
    tu = np.zeros((h // 4, w // 4), np.int32)
    tid = 0
    for y in range(0, h, 32):
        for x in range(0, w, 32):
            n = int(rng.choice([4, 8, 16, 32]))
            for yy in range(y, y + 32, n):
                for xx in range(x, x + 32, n):
                    tu[yy // 4:(yy + n) // 4, xx // 4:(xx + n) // 4] = tid
                    img[yy:yy + n, xx:xx + n] += int(rng.integers(-12, 13))
                    tid += 1
    img += rng.integers(-3, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8), tu


@pytest.mark.parametrize("qp", [10, 22, 32, 37, 51])
@pytest.mark.parametrize("seed", range(2))
def test_deblock_matches_jax(qp, seed):
    rng = np.random.default_rng(seed)
    rec, tu = blocky(rng, 96, 160)
    want = j_deblock.deblock_luma(rec, tu, qp, use_native=False)
    native = t_deblock.deblock_luma(rec, tu, qp)
    plain = t_deblock.deblock_luma_plain(rec, tu, qp)
    assert native.dtype == rec.dtype == plain.dtype
    np.testing.assert_array_equal(native, want)
    np.testing.assert_array_equal(plain, want)
    if j_deblock.BETA_TABLE[qp] == 0:
        np.testing.assert_array_equal(native, rec)
    else:
        assert not np.array_equal(native, rec)


def test_deblock_does_not_fall_back(monkeypatch):
    class Failing:
        @staticmethod
        def deblock_luma_native(*args):
            return 3

    rec, tu = blocky(np.random.default_rng(0), 64, 64)
    monkeypatch.setattr(t_native, "load_library", lambda: Failing)
    with pytest.raises(RuntimeError, match="code 3"):
        t_deblock.deblock_luma(rec, tu, 32)
    with pytest.raises(ValueError):
        t_native.deblock_luma(rec, tu[:, :-1], 32)


def sao_inputs(seed, h, w, qp):
    rng = np.random.default_rng(seed)
    rec, tu = blocky(rng, h, w)
    orig = np.clip(rec.astype(np.int32) + rng.integers(-6, 7, rec.shape)
                   + (rng.random(rec.shape) < 0.05) * 40, 0, 255
                   ).astype(np.uint8)
    return orig, t_deblock.deblock_luma(rec, tu, qp)


def j_grid(grid):
    return [[j_sao.SaoParams(p.mode, p.type_aux, p.offsets) for p in row]
            for row in grid]


@pytest.mark.parametrize("ctb", [32, 64])
@pytest.mark.parametrize("qp", [22, 37])
@pytest.mark.parametrize("merge", [True, False])
def test_sao_estimate_and_apply_match_jax(ctb, qp, merge):
    orig, deb = sao_inputs(ctb + qp, 128, 192, qp)
    lam = t_rdo.lambda_for_qp(qp)
    assert lam == j_rdo.lambda_for_qp(qp)
    got = t_sao.estimate_frame(orig, deb, ctb, lam, merge=merge)
    want = j_sao.estimate_frame(orig, deb, ctb, lam, merge=merge)
    assert [[p.key() for p in r] for r in got] \
        == [[p.key() for p in r] for r in want]
    modes = {p.mode for r in got for p in r}
    assert modes - {t_sao.MODE_OFF}, "no CTU took SAO"
    np.testing.assert_array_equal(t_sao.apply_sao(deb, got, ctb),
                                  j_sao.apply_sao(deb, want, ctb))


@pytest.mark.parametrize("seed", range(3))
def test_sao_params_round_trip_matches_jax(seed):
    rng = np.random.default_rng(seed)
    grid = []
    for cy in range(3):
        row = []
        for cx in range(5):
            kind = int(rng.integers(0, 5))
            if kind == 0:
                p = t_sao.SaoParams()
            elif kind == 1 and cx > 0:
                p = row[cx - 1]
            elif kind == 2 and cy > 0:
                p = grid[cy - 1][cx]
            elif kind == 3:
                p = t_sao.SaoParams(t_sao.MODE_BO, int(rng.integers(0, 29)),
                                    tuple(int(v) for v in
                                          rng.integers(-7, 8, 4)))
            else:
                m = rng.integers(0, 8, 4)
                p = t_sao.SaoParams(t_sao.MODE_EO, int(rng.integers(0, 4)),
                                    (int(m[0]), int(m[1]), -int(m[2]),
                                     -int(m[3])))
            row.append(p)
        grid.append(row)
    outs = []
    for cabac, contexts, sao, g in ((t_cabac, t_contexts, t_sao, grid),
                                    (j_cabac, j_contexts, j_sao,
                                     j_grid(grid))):
        enc = cabac.CabacEncoder()
        ctx = contexts.make_context_states(32)
        sao.encode_params(enc, ctx, g)
        outs.append(enc.terminate_and_finish())
    assert outs[0] == outs[1]
    dec = t_cabac.CabacDecoder(outs[0])
    back = t_sao.decode_params(dec, t_contexts.make_context_states(32)
                               .tolist(), 3, 5)
    j_back = j_sao.decode_params(j_cabac.CabacDecoder(outs[0]),
                                 j_contexts.make_context_states(32), 3, 5)
    assert [[p.key() for p in r] for r in back] \
        == [[p.key() for p in r] for r in grid] \
        == [[p.key() for p in r] for r in j_back]


@pytest.mark.parametrize("qp", [22, 32, 37])
def test_decoder_reads_jax_loop_filtered_streams(qp):
    """`encoder.encode_frame` (the JAX package's host RDO encoder, its
    defaults: deblocking and SAO on) on a 64x64 crop; the port's decoder
    returns the JAX decoder's reconstruction, which is the encoder's."""
    frame = np.ascontiguousarray(frames()["natural128"][32:96, 16:80])
    enc = j_encoder.encode_frame(frame, qp=qp)
    want = j_decoder.decode_frame(enc.bitstream)
    got = t_decoder.decode_frame(enc.bitstream, device="cpu")
    np.testing.assert_array_equal(got.reconstruction,
                                  np.asarray(want.reconstruction))
    np.testing.assert_array_equal(got.reconstruction, enc.reconstruction)
    np.testing.assert_array_equal(got.mode_map, want.mode_map)
