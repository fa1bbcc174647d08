"""The port's v1 wavefront encoder (the uniform n x n grid) against the JAX
package's, with zero tolerance.

* Live against the JAX package on the frames of its v1 tests and on
  block sizes 8 and 32 (`tests/golden_torch/w1.json`'s small cases): the
  reconstruction, the modes, the levels and the container stream are
  equal, and equal to the captured digests.
* Batches of 2 and 3 frames equal single-frame encodes and the JAX
  package's vmapped batch.
* The port's decoder and the JAX decoder give the port's reconstruction
  back from its streams at block sizes 8, 16 and 32 (32 with strong intra
  smoothing off: the encoder filters 32x32 references with [1 2 1]
  only; with it on, the smooth frame's decode differs).
* `encode_frame_wavefront_hm` (Annex-B, CTB 16) gives the JAX package's
  stream and reconstruction, loop filters on and off; stock HM
  (`artifacts/hm_bin/TAppDecoderStatic`) decodes it with its hash check
  "(OK)" to the port's reconstruction.
* The rate table: its entries, and the float64 sum that makes a mode's
  rate proxy independent of summation order.
* The 1056x1920 frame at b = 1 and b = 4 and its Annex-B stream against
  the digests (marked slow: about a minute of CPU).
* The step kernel's wrapper (`ops/v1_step.py`; the kernel runs only on a
  card, `tests/test_torch_cuda.py`): CPU state takes the plain `_step`
  and launches nothing; the wrapper refuses state on another device, of
  another dtype or shape, without launching; its grid is the step's
  blocks inside the frames; its dequantiser scalars give `dequantize_np`;
  and the int32 bounds of the kernel's exactness argument hold.
"""

import hashlib
import json
import os
import subprocess
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from context_adaptive_neural_network_based_prediction_tpu.codec import (
    decoder as j_decoder)
from context_adaptive_neural_network_based_prediction_tpu.parallel import (
    wavefront as j_wavefront)
from context_adaptive_neural_network_based_prediction_tpu_torch.codec import (
    decoder as t_decoder, native as t_native)
from context_adaptive_neural_network_based_prediction_tpu_torch.ops import (
    _cuda_build, transform, v1_step)
from context_adaptive_neural_network_based_prediction_tpu_torch.parallel import (
    wavefront as t_wavefront)
from context_adaptive_neural_network_based_prediction_tpu_torch.utils import (
    profiling)
from context_adaptive_neural_network_based_prediction_tpu_torch.evaluation \
    .v1_frames import BATCH_CASE, HM_CASES, V1_CASES, batch4, make_frame

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GOLDEN = os.path.join(REPO, "tests", "golden_torch", "w1.json")
HM_DECODER = os.path.join(REPO, "artifacts", "hm_bin", "TAppDecoderStatic")
SMALL = [k for k, (spec, _, _) in V1_CASES.items() if spec["kind"] != "bench"]


def golden():
    with open(GOLDEN) as f:
        return json.load(f)["cases"]


def sha(a):
    if isinstance(a, (bytes, bytearray)):
        return hashlib.sha256(bytes(a)).hexdigest()
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def port_arrays(frames, qp, n):
    return t_wavefront.encode_frames_wavefront_batch(
        frames, qp, block_size=n, device="cpu")


def jax_arrays(frame, qp, n):
    run = j_wavefront._jitted_wavefront(*frame.shape, n, qp)
    return tuple(np.asarray(a) for a in run(jnp.asarray(frame)))


@pytest.mark.parametrize("case", SMALL)
def test_encode_matches_jax(case):
    spec, qp, n = V1_CASES[case]
    frame = make_frame(spec)
    want = j_wavefront.encode_frame_wavefront(frame, qp, block_size=n)
    got = t_wavefront.encode_frame_wavefront(frame, qp, block_size=n,
                                             device="cpu")
    recons, modes, qcoeffs = port_arrays(frame[None], qp, n)
    j_recon, j_modes, j_q = jax_arrays(frame, qp, n)
    np.testing.assert_array_equal(got.reconstruction, want.reconstruction)
    np.testing.assert_array_equal(recons[0], j_recon.astype(np.uint8))
    np.testing.assert_array_equal(modes[0], j_modes)
    np.testing.assert_array_equal(qcoeffs[0], j_q)
    np.testing.assert_array_equal(got.mode_map, want.mode_map)
    assert got.bitstream == want.bitstream
    assert got.num_bits == want.num_bits
    g = golden()[case]
    assert (sha(got.reconstruction), sha(modes[0].astype(np.int32)),
            sha(qcoeffs[0].astype(np.int32)), sha(got.bitstream)) == (
        g["recon"], g["modes"], g["qcoeffs"], g["stream"])
    # The CU trees carry the decided grid (one 2Nx2N leaf a block).
    assert len(got.ctu_trees) == modes[0].size
    for node, mode in zip(got.ctu_trees, modes[0].reshape(-1)):
        assert not node.split and node.size == n
        assert node.pus[0].mode == mode


def natural_frames(h, w, seeds):
    return np.stack([make_frame({"kind": "natural", "h": h, "w": w,
                                 "seed": s}) for s in seeds])


@pytest.mark.parametrize("n_frames", [2, 3])
@pytest.mark.parametrize("n", [8, 16])
def test_batch_equals_single_frames_and_jax(n_frames, n):
    frames = natural_frames(48, 64, [11, 12, 13][:n_frames])
    qp = 30
    recons, modes, qcoeffs = port_arrays(frames, qp, n)
    j_recons, j_modes, j_q = j_wavefront.encode_frames_wavefront_batch(
        frames, qp, block_size=n)
    np.testing.assert_array_equal(recons, j_recons)
    np.testing.assert_array_equal(modes, j_modes)
    np.testing.assert_array_equal(qcoeffs, j_q)
    for f in range(n_frames):
        r1, m1, q1 = port_arrays(frames[f:f + 1], qp, n)
        np.testing.assert_array_equal(recons[f], r1[0])
        np.testing.assert_array_equal(modes[f], m1[0])
        np.testing.assert_array_equal(qcoeffs[f], q1[0])


@pytest.mark.parametrize("case", [
    "natural64x96s1_q32_n8", "natural64x96s1_q32_n16",
    "natural48x48s3_q27_n16", "natural64x96s1_q32_n32",
    "smooth64x96_q32_n32"])
def test_decoders_give_the_reconstruction_back(case):
    spec, qp, n = V1_CASES[case]
    res = t_wavefront.encode_frame_wavefront(make_frame(spec), qp,
                                             block_size=n, device="cpu")
    smoothing = n != 32
    for dec in (t_decoder.decode_frame(res.bitstream, device="cpu",
                                       strong_intra_smoothing=smoothing),
                j_decoder.decode_frame(res.bitstream,
                                       strong_intra_smoothing=smoothing)):
        np.testing.assert_array_equal(dec.reconstruction, res.reconstruction)
        np.testing.assert_array_equal(dec.mode_map, res.mode_map)


def test_strong_smoothing_breaks_the_block_32_decode():
    """Why block-size-32 streams decode with strong smoothing off: on the
    smooth frame the decoder's default bilinear 32x32 filter differs from
    the encoder's [1 2 1]."""
    spec, qp, n = V1_CASES["smooth64x96_q32_n32"]
    res = t_wavefront.encode_frame_wavefront(make_frame(spec), qp,
                                             block_size=n, device="cpu")
    dec = t_decoder.decode_frame(res.bitstream, device="cpu")
    assert not np.array_equal(dec.reconstruction, res.reconstruction)


def test_stream_header_and_payload():
    spec, qp, n = V1_CASES["natural64x96s1_q32_n8"]
    frame = make_frame(spec)
    _, modes, qcoeffs = port_arrays(frame[None], qp, n)
    stream = t_native.serialize_grid(modes[0], qcoeffs[0], width=96,
                                     height=64, n=n, qp=qp)
    payload = t_native.pack_grid_payload(modes[0], qcoeffs[0], n, qp)
    assert stream.endswith(payload) and len(stream) == len(payload) + 21
    dec = t_decoder.FrameDecoder(stream, device="cpu")
    assert (dec.ctu, dec.w, dec.h, dec.qp, dec.sign_hiding,
            dec.max_tu_depth) == (8, 96, 64, qp, False, 0)
    with pytest.raises(ValueError):
        t_native.pack_grid_payload(modes[0], qcoeffs[0][:, :, :4, :4], n,
                                   qp)


@pytest.mark.parametrize("case", [k for k, v in HM_CASES.items()
                                  if "bench" not in v[0]])
def test_hm_stream_matches_jax_and_stock_hm(case):
    base, loop_filters = HM_CASES[case]
    spec, qp, n = V1_CASES[base]
    frame = make_frame(spec)
    j_stream, j_res = j_wavefront.encode_frame_wavefront_hm(
        frame, qp, loop_filters=loop_filters)
    stream, res = t_wavefront.encode_frame_wavefront_hm(
        frame, qp, loop_filters=loop_filters, device="cpu")
    assert stream == j_stream
    np.testing.assert_array_equal(res.reconstruction, j_res.reconstruction)
    g = golden()[case]
    assert (sha(stream), sha(res.reconstruction)) == (g["stream"], g["recon"])
    with tempfile.TemporaryDirectory() as tmp:
        bs, yuv = os.path.join(tmp, "s.bin"), os.path.join(tmp, "r.yuv")
        with open(bs, "wb") as f:
            f.write(stream)
        out = subprocess.run([HM_DECODER, "-b", bs, "-o", yuv, "-d", "8"],
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "(OK)" in out.stdout
        luma = np.fromfile(yuv, np.uint8).reshape(frame.shape)
    np.testing.assert_array_equal(luma, res.reconstruction)


def test_refused_configs():
    frame = make_frame({"kind": "natural", "h": 64, "w": 96, "seed": 1})
    with pytest.raises(ValueError):
        t_wavefront.encode_frame_wavefront(frame, 32, block_size=12,
                                           device="cpu")
    with pytest.raises(ValueError):
        t_wavefront.encode_frame_wavefront(frame[:40], 32, block_size=16,
                                           device="cpu")


def test_rate_table():
    table = t_wavefront.rate_table()
    assert table.dtype == np.float32 and table.shape == (1 << 15,)
    assert table[0] == 0.0
    k = np.arange(1, 1 << 15)
    want = 2.0 * np.log2(1.0 + k) + 1.0
    # Rounded once from float64: within half a float32 ulp.
    assert np.all(np.abs(table[1:] - want) <= np.spacing(table[1:]) / 2)
    # Every term is >= 3 with at most 22 fractional bits, so a float64
    # sum of up to 32 x 32 of them is exact in any order.
    assert table[1:].min() == 3.0
    assert np.all(table[1:] * 2.0 ** 22 == np.round(table[1:] * 2.0 ** 22))
    rng = np.random.default_rng(0)
    for _ in range(20):
        terms = table[rng.integers(0, 1 << 15, 1024)].astype(np.float64)
        a = np.sum(terms)
        b = sum(terms[rng.permutation(1024)].tolist())
        c = float(torch.from_numpy(terms).sum())
        assert a == b == c
        assert a * 2.0 ** 22 == np.round(a * 2.0 ** 22)


@pytest.mark.parametrize("n", [4, 32])
def test_levels_stay_inside_the_rate_table(n):
    """At QP 0 a 0 / 255 checkerboard drives the levels near their largest;
    they stay below 2^15 (the table's size), the encode runs and equals
    the JAX package's."""
    yy, xx = np.mgrid[0:64, 0:64]
    frame = (255 * ((yy + xx) % 2)).astype(np.uint8)
    frame[:, 32:] = 255 - frame[:, 32:]
    recons, modes, qcoeffs = port_arrays(frame[None], 0, n)
    assert np.abs(qcoeffs).max() < (1 << 15)
    j_recon, j_modes, j_q = jax_arrays(frame, 0, n)
    np.testing.assert_array_equal(recons[0], j_recon.astype(np.uint8))
    np.testing.assert_array_equal(qcoeffs[0], j_q)


def cpu_state(n=8, nf=2, qp=30, top=0, has_halo=False):
    frames = natural_frames(2 * n, 5 * n, [21, 22, 23][:nf])
    plan, dp = t_wavefront._get_plan(2 * n, 5 * n, n, qp, nf, "cpu", top,
                                     has_halo)
    return plan, dp, t_wavefront._state(plan, frames, torch.device("cpu"))


def test_cpu_steps_are_the_plain_step_and_launch_nothing():
    """CPU state runs the plain `_step` (what the JAX comparisons above
    hold): an encode launches no kernel, counts no `v1.step_kernel` and
    loads no kernel library."""
    v1_step.reset_launch_counts()
    plan, dp, st = cpu_state()
    step = t_wavefront._stepper(plan, dp, st)
    assert step.func is t_wavefront._step
    frames = natural_frames(32, 48, [5, 6])
    profiling.reset()
    profiling.enable()
    try:
        recons, _, _ = port_arrays(frames, 30, 8)
        counters = profiling.counters()
    finally:
        profiling.disable()
        profiling.reset()
    assert "v1.step_kernel" not in counters
    assert counters["v1.readback_bytes"] > 0
    assert v1_step.launches == {}
    assert "v1_step" not in _cuda_build._libs
    np.testing.assert_array_equal(recons[1],
                                  port_arrays(frames[1:], 30, 8)[0][0])


@pytest.mark.parametrize("what", ["device", "meta", "dtype", "shape",
                                  "table"])
def test_kernel_wrapper_refuses_without_launching(what):
    """The wrapper takes CUDA tensors of the plan's dtypes and shapes, or
    raises ValueError before it builds or launches anything: no fallback
    (state on a device other than the CPU never reaches the plain
    step)."""
    v1_step.reset_launch_counts()
    plan, dp, st = cpu_state()
    if what == "device":
        call = lambda: v1_step.stepper(plan, dp, st)
    elif what == "meta":
        meta = {k: torch.empty_like(v, device="meta") for k, v in st.items()}
        call = lambda: t_wavefront._stepper(plan, dp, meta)
    else:
        if what == "dtype":
            st["recon"] = st["recon"].to(torch.int64)
        elif what == "shape":
            st["qcoeffs"] = st["qcoeffs"][:, :-1].contiguous()
        else:
            dp = dict(dp, rate=dp["rate"].to(torch.float64))
        call = lambda: v1_step.kernel_args(plan, dp, st)
    with pytest.raises(ValueError):
        call()
    assert v1_step.launches == {}
    assert "v1_step" not in _cuda_build._libs


@pytest.mark.parametrize("n,nf,top,has_halo", [
    (4, 1, 0, False), (8, 3, 0, False), (16, 2, 1, False), (32, 1, 1, True)])
def test_kernel_grid_is_the_steps_blocks_on_the_frame(n, nf, top, has_halo):
    """`blocks_on_frame(plan, t)` x NF is the plan's slots of step t on the
    frames (the kernel's grid), for wide, tall and square grids."""
    for h, w in ((3 * n, 11 * n), (9 * n, 2 * n), (5 * n, 5 * n)):
        plan, _ = t_wavefront._get_plan(h, w, n, 32, nf, "cpu", top,
                                        has_halo)
        pad = plan["nby"] * plan["nbx"]
        on = (plan["cell"] % plan["cells"] != pad).sum(1)
        got = [v1_step.blocks_on_frame(plan, t) * nf
               for t in range(plan["n_steps"])]
        assert got == on.tolist()
        for t in (-1, plan["n_steps"]):
            with pytest.raises(ValueError):
                v1_step.blocks_on_frame(plan, t)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("qp", [0, 22, 37, 51])
def test_kernel_args_carry_the_plans_scalars(n, qp):
    """The kernel's scalars: its dequantiser (a right shift with rounding,
    or a left shift) gives `dequantize_np` on every level, and bit m of
    its mask is the plan's `use_filtered[m]`."""
    plan, dp, st = cpu_state(n=n, nf=1, qp=qp, top=1, has_halo=True)
    args = v1_step.kernel_args(plan, dp, st)
    (nf, width, height, top, has_halo, nbx, nby, plane, cells, qscale,
     qbits, qadd, dq_scale, dq_shift, mask, lam) = args[:16]
    assert (nf, width, height, top, has_halo, nbx, nby) == (
        1, 5 * n, 2 * n, 1, 1, 5, 2)
    assert (plane, cells, qscale, qbits, qadd) == (
        plan["plane"], plan["cells"], plan["qscale"], plan["qbits"],
        plan["qadd"])
    assert np.float32(lam) == plan["lam"]
    assert [bool(mask >> m & 1) for m in range(35)] == \
        plan["use_filtered"].tolist()
    lv = np.arange(-(1 << 15) + 1, 1 << 15, dtype=np.int64)
    if dq_shift > 0:
        v = (lv * dq_scale + (1 << (dq_shift - 1))) >> dq_shift
    else:
        v = lv * dq_scale * (1 << -dq_shift)
    assert np.abs(lv * dq_scale * (1 << max(0, -dq_shift))).max() < 2 ** 31
    np.testing.assert_array_equal(
        np.clip(v, -32768, 32767),
        transform.dequantize_np(lv.astype(np.int32).reshape(-1, 1, 1)
                                .repeat(n, 1).repeat(n, 2), qp)[:, 0, 0])


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_kernel_int32_bounds(n):
    """The bounds of `csrc/v1_step.cu`'s exactness argument: every DCT row
    has an L1 norm of at most 64 n, so the forward transform of any 8-bit
    residual block keeps |coeff| <= 32640 (shown on the worst sign
    pattern of every coefficient), the quantiser's product stays below
    2^31 at QP 0 and the levels below 2^15."""
    t = transform.dct_matrix(n).astype(np.int64)
    assert np.abs(t).sum(1).max() <= 64 * n
    log2n = n.bit_length() - 1
    sh1, sh2 = log2n - 1, log2n + 6
    sg = np.sign(t)                                  # (k, x)
    # r[k, l] = 255 sign(T[k, i]) sign(T[l, x]): the largest coeff (k, l).
    for sign in (1, -1):
        r = sign * 255 * sg[:, None, :, None] * sg[None, :, None, :]
        a = (np.einsum("klix,jx->klij", r, t) + (1 << (sh1 - 1))) >> sh1
        c = (np.einsum("ji,klim->kljm", t, a) + (1 << (sh2 - 1))) >> sh2
        k, l = np.arange(n)[:, None], np.arange(n)[None, :]
        assert np.abs(a).max() <= 32640
        assert np.abs(c).max() <= 32640 == np.abs(c[k, l, k, l]).max()
    qbits = 14 + 0 + (15 - 8 - log2n)
    prod = 32640 * transform.QUANT_SCALES[0] + (171 << (qbits - 9))
    assert prod < 2 ** 31 and (prod >> qbits) < 2 ** 15


@pytest.mark.slow
def test_bench_frame_matches_digests():
    """The 1056x1920 frame: b = 1, b = 4 and the Annex-B stream (about a
    minute of CPU; `chip_smoke.py` phase 16 checks the same on the card)."""
    g = golden()
    spec, qp, n = V1_CASES["bench1056x1920_q32_n16"]
    frame = make_frame(spec)
    res = t_wavefront.encode_frame_wavefront(frame, qp, block_size=n,
                                             device="cpu")
    assert (sha(res.reconstruction), sha(res.bitstream)) == (
        g["bench1056x1920_q32_n16"]["recon"],
        g["bench1056x1920_q32_n16"]["stream"])
    recons, modes, qcoeffs = port_arrays(batch4(frame), qp, n)
    for f, want in enumerate(g[BATCH_CASE]["frames"]):
        assert (sha(recons[f]), sha(modes[f].astype(np.int32)),
                sha(qcoeffs[f].astype(np.int32))) == (
            want["recon"], want["modes"], want["qcoeffs"])
    stream, res_hm = t_wavefront.encode_frame_wavefront_hm(
        frame, qp, device="cpu")
    h = g["bench1056x1920_q32_hm_lf"]
    assert (sha(stream), sha(res_hm.reconstruction)) == (h["stream"],
                                                          h["recon"])
