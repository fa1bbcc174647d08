"""Tests of the port that need an NVIDIA card (marker `cuda`).

They hold the CUDA kernels against their plain PyTorch versions on the
card (exactly): the unit trial, also with a PNN prediction under the
substitution (`sub18`) and switch (`append`) policies, the one-launch
trial at every n at 1 to 31 slots (with the launches the profiler
sees per call), and the PNN's integer merger at every map count of the
codec, with random inputs and inputs at the frozen models' caps, and
after an in-place change of its weights.  The kernel path's encodes of the small
test frames, regular and NN policies, are held against the digests
captured from the JAX package.  The float PNN's kernels (the FC layers and
the float merger) are held against their plain versions by tolerance, at
the edges of the FC kernel's tiles and K splits and of the merger's slot
chunks, two calls on the same inputs giving the same bits; and the float
prediction path against `tests/golden_torch/float_pnn.*`.  Batched
plans: the trial and the merger at 124 and 496 slots, 2-frame batches
and the streaming encoder equal to single-frame encodes, and the port's
decoder on the card.  Training: a step's loss and gradients on the card
against the CPU, a resumed run equal to an uninterrupted one, the TF32 and
cuDNN flags given back, and the FC kernel's forward after a step on the
updated weights.  Multi-rank paths: 2 Gloo ranks sharing the card run
the v1 tiled halo encoder (equal to the single-device encode, each rank
launching the v1 step kernel once a step), the v2 one (regular and
switch, equal to the single-device encode, each rank launching the trial
kernel, and under switch the merger) and a sharded training chunk
(against the single-device chunk).
The batched transforms and quantiser, `predict_via_hevc_mode` and
`ycbcr_to_rgb` on CUDA tensors give the CPU's results.  The v1 step
kernel equals the plain `_step` after every step of whole encodes (every
block size, QP 0 to 51, natural, flat and binary frames, batches of 1
and 3, halo plans), launched once a step.
Without a card they skip.  The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from context_adaptive_neural_network_based_prediction_tpu_torch.codec import (
    rdo)
from context_adaptive_neural_network_based_prediction_tpu_torch.evaluation import (
    float_golden)
from context_adaptive_neural_network_based_prediction_tpu_torch.models import (
    zoo)
from context_adaptive_neural_network_based_prediction_tpu_torch.ops import (
    fc_forward, merger, merger_int, transform, unit_fused, v1_step)
from context_adaptive_neural_network_based_prediction_tpu_torch.parallel import (
    rate_model, wavefront2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = {4: 1, 8: 1, 16: 6, 32: 36}
FIELDS = ("cost", "best", "rec", "q", "counts")
GRIDS = ("m8", "q8", "s8", "m4", "q4", "m16", "q16", "s16", "m32", "q32",
         "s32")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def trial_inputs(n, b, seed):
    """Seeded random content, worst-case residuals in the last 4 slots,
    nonzero live rate rows in odd slots."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (b, 1))
    rt = np.clip(base + rng.integers(-60, 60, (b, 2 * n + 1)), 0, 255)
    rl = np.clip(base + rng.integers(-60, 60, (b, 2 * n + 1)), 0, 255)
    og = np.clip(base[:, :, None] + rng.integers(-70, 70, (b, n, n)), 0, 255)
    yy, xx = np.mgrid[0:n, 0:n]
    rt[-4:-1], rl[-4:-1] = 0, 0
    og[-4], og[-3], og[-2] = 255, 255 * ((yy + xx) % 2), 255 * (xx % 2)
    rt[-1], rl[-1], og[-1] = 255, 255, 0
    rl[:, 0] = rt[:, 0]
    mb = rng.uniform(1.0, 6.0, (b, 35)).astype(np.float32)
    rr = rng.integers(-400, 400, (8, b))
    rr[:, 0::2] = 0
    return [np.ascontiguousarray(x, dtype=t) for x, t in
            ((rt, np.int32), (rl, np.int32), (og, np.int32),
             (mb, np.float32), (rr, np.int32))]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("qp", [22, 32, 37])
def test_kernel_matches_plain(dev, n, qp):
    c = wavefront2._unit_consts(n, qp)
    cst = unit_fused.build_consts(
        n, 35, c, rate_model.scalar_bits(qp), rdo.lambda_for_qp(qp),
        transform.QUANT_SCALES[qp % 6], transform.INV_QUANT_SCALES[qp % 6],
        b_eff=31, groups=GROUPS[n])
    tc = unit_fused.consts_from_numpy(cst, device=dev)
    args = [torch.from_numpy(x).to(dev)
            for x in trial_inputs(n, 31, 100 * n + qp)]
    launches = unit_fused.launches[n]
    got = unit_fused.trial_apply(tc, *args, impl="kernel")
    want = unit_fused.trial_apply(tc, *args, impl="plain")
    torch.cuda.synchronize()
    assert unit_fused.launches[n] == launches + 1
    for field, x, y in zip(FIELDS, got, want):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), field


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["synth64x96", "natural128"])
def test_kernel_encode_matches_jax_digests(dev, name):
    with open(os.path.join(REPO, "tests", "golden_torch",
                           "w2_rate_evolve.json")) as f:
        want = json.load(f)["frames"][name]
    if name == "synth64x96":
        rng = np.random.default_rng(5)
        yy, xx = np.mgrid[0:64, 0:96]
        frame = np.clip(128 + 45 * np.sin(xx / 11.0) + 35 * np.cos(yy / 8.0)
                        + rng.normal(0, 7, (64, 96)), 0, 255).astype(np.uint8)
    else:
        frame = np.load(os.path.join(REPO, "tests", "golden_hm",
                                     "128_full_q32_src.npy"))
    recon, grids = wavefront2.encode_arrays_wavefront2(
        frame, 32, rate_evolve=True, device=dev)
    res = wavefront2._arrays_to_result(frame, 32, (recon,) + grids,
                                       "regular", True)
    sha = lambda b: hashlib.sha256(b).hexdigest()
    assert sha(recon.tobytes()) == want["recon"]
    assert sha(res.bitstream) == want["stream"]
    for g, k in zip(grids, GRIDS):
        assert sha(np.ascontiguousarray(g, np.int32).tobytes()) == want[k], k


def merger_inputs(m, n, seed, extreme):
    """(x (N, 80, M) int16, w (80, 16, M) int16, b (16, M) int32): random
    in the PNN's caps (activations 2047, weights 511, biases 2^30), or every
    product at the cap with one sign per slot (the largest sums)."""
    rng = np.random.default_rng(seed)
    if extreme:
        sign = np.where(np.arange(n) % 2, -1, 1)[:, None, None]
        x = np.broadcast_to(2047 * sign, (n, 80, m))
        w = np.full((80, 16, m), 511)
        b = np.where(np.arange(16)[:, None] % 2, -(1 << 30), 1 << 30)
        b = np.broadcast_to(b, (16, m))
    else:
        x = rng.integers(-2047, 2048, (n, 80, m))
        w = rng.integers(-511, 512, (80, 16, m))
        b = rng.integers(-(1 << 30), 1 << 30, (16, m))
    return [np.ascontiguousarray(a, dtype=t) for a, t in
            ((x, np.int16), (w, np.int16), (b, np.int32))]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("n", [1, 17, 31])
@pytest.mark.parametrize("extreme", [False, True])
def test_merger_kernel_matches_plain(dev, m, n, extreme):
    x, w, b = [torch.from_numpy(a).to(dev)
               for a in merger_inputs(m, n, 7 * m + n, extreme)]
    before = merger_int.launches.get(m, 0)
    got = merger_int.merger_int_forward(x, w, b)
    want = merger_int.merger_int_forward(x, w, b, impl="plain")
    torch.cuda.synchronize()
    assert merger_int.launches[m] == before + 1
    assert got.dtype == torch.int32 and got.shape == (m, n, 16)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("policy", ["sub18", "append"])
def test_kernel_matches_plain_with_nn_pred(dev, n, policy):
    qp = 37
    n_modes = 36 if policy == "append" else 35
    c = wavefront2._unit_consts(n, qp, n_modes)
    cst = unit_fused.build_consts(
        n, n_modes, c, rate_model.scalar_bits(qp), rdo.lambda_for_qp(qp),
        transform.QUANT_SCALES[qp % 6], transform.INV_QUANT_SCALES[qp % 6],
        b_eff=31, nn_policy=policy, groups=GROUPS[n])
    tc = unit_fused.consts_from_numpy(cst, device=dev)
    rt, rl, og, mb, rr = trial_inputs(n, 31, 100 * n + 7)
    rng = np.random.default_rng(n)
    mb = rng.uniform(1.0, 6.0, (31, n_modes)).astype(np.float32)
    # PNN predictions: the original plus noise (so the PNN mode wins in
    # some slots), then extremes.
    nnp = np.clip(og + rng.integers(-3, 4, og.shape), 0, 255)
    nnp[-2], nnp[-1] = 0, 255
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (rt, rl, og, mb, rr)]
    nn_pred = torch.from_numpy(nnp.astype(np.int32)).to(dev)
    for pred in (nn_pred, None):
        got = unit_fused.trial_apply(tc, *args, nn_pred=pred)
        want = unit_fused.trial_apply(tc, *args, impl="plain", nn_pred=pred)
        torch.cuda.synchronize()
        for field, a, b in zip(FIELDS, got, want):
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), (field, pred is None)
    nn_mode = 18 if policy == "sub18" else 35
    best = unit_fused.trial_apply(tc, *args, nn_pred=nn_pred)[1]
    assert (best == nn_mode).any()


def small_trial_case(dev, n, b, qp, policy):
    """Table set, inputs (b slots: the last ones the worst-case residuals
    of `trial_inputs`, nonzero rate rows in odd slots of the 4-slot case)
    and a PNN prediction for the one-launch trial."""
    n_modes = 36 if policy == "append" else 35
    c = wavefront2._unit_consts(n, qp, n_modes)
    cst = unit_fused.build_consts(
        n, n_modes, c, rate_model.scalar_bits(qp), rdo.lambda_for_qp(qp),
        transform.QUANT_SCALES[qp % 6], transform.INV_QUANT_SCALES[qp % 6],
        b_eff=b, nn_policy=policy)
    tc = unit_fused.consts_from_numpy(cst, device=dev)
    rt, rl, og, _, rr = trial_inputs(n, max(b, 4), 1000 * n + 10 * b + qp)
    rng = np.random.default_rng(b)
    mb = rng.uniform(1.0, 6.0, (b, n_modes)).astype(np.float32)
    rt, rl, og, rr = rt[-b:], rl[-b:], og[-b:], rr[:, -b:]
    nnp = np.clip(og + rng.integers(-3, 4, og.shape), 0, 255)
    return tc, [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (rt, rl, og, mb, rr, nnp.astype(np.int32))]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("b", [1, 2, 17, 31])
@pytest.mark.parametrize("qp", [22, 32, 37])
@pytest.mark.parametrize("policy", [None, "sub18", "append"])
def test_fused_trial_edges(dev, n, b, qp, policy):
    """The one-launch trial at the edges of its design: 1 to 31 slots
    (clusters), half-warp, warp and warpgroup modes, the modes past the
    last (35 modes: the 36th mode slot repeats one), with and without a
    PNN prediction and rate rows (None: zero rows), equal to the plain
    trial bit for bit; each call one launch; two calls the same bits."""
    tc, (rt, rl, og, mb, rr, nnp) = small_trial_case(dev, n, b, qp, policy)
    for pred in ([None, nnp] if policy else [None]):
        for rows in (rr, None):
            before = unit_fused.launches[n]
            got = unit_fused.trial_apply(tc, rt, rl, og, mb, rows,
                                         nn_pred=pred)
            again = unit_fused.trial_apply(tc, rt, rl, og, mb, rows,
                                           nn_pred=pred)
            want = unit_fused.trial_apply(tc, rt, rl, og, mb, rows,
                                          impl="plain", nn_pred=pred)
            torch.cuda.synchronize()
            assert unit_fused.launches[n] == before + 2
            for field, x, y, z in zip(FIELDS, got, want, again):
                if x.dtype == torch.float32:
                    x, y, z = (t.view(torch.int32) for t in (x, y, z))
                assert torch.equal(x, y), (field, pred is None, rows is None)
                assert torch.equal(x, z), (field, "repeated")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_trial_launches_per_call(dev, n):
    """What the card runs for one trial call (profiler): one kernel at
    every n, all of a session's calls counted in that session.  A second
    witness that cannot drop records: each call of a session has inputs
    no earlier call had and keeps its outputs, which must equal the plain
    trial's, so every call ran its kernel (a skipped launch would leave a
    buffer that nothing wrote these outputs to).  The profiler drops a
    session's kernel records now and then (0 of 4 seen, the calls' outputs
    right), so a session short of records, whose every call that witness
    shows ran, is profiled again with new inputs, up to 3 sessions; no
    session may show another kernel or more records than calls."""
    from torch.profiler import ProfilerActivity, profile

    tc, (rt, rl, og, mb, rr, _) = small_trial_case(dev, n, 31, 32, None)
    unit_fused.trial_apply(tc, rt, rl, og, mb, rr)
    calls = 4
    want = "trial_small_kernel" if n <= 8 else "trial_large_kernel"
    for session in range(3):
        origs = [(og + 29 * (session * calls + j + 1)) % 256
                 for j in range(calls)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            outs = [unit_fused.trial_apply(tc, rt, rl, o, mb, rr)
                    for o in origs]
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if getattr(e, "device_type", None)
                 == torch.autograd.DeviceType.CUDA]
        assert all(want in x for x in names), names
        assert len(names) <= calls, names
        for o, got in zip(origs, outs):
            plain = unit_fused.trial_apply(tc, rt, rl, o, mb, rr,
                                           impl="plain")
            for x, y in zip(got, plain):
                assert torch.equal(x.view(torch.int32), y.view(torch.int32))
        if len(names) == calls:
            break
    assert len(names) == calls, names


@pytest.mark.cuda
@pytest.mark.parametrize("m", [32, 64, 128, 256])
def test_merger_kernel_reprepares_after_in_place_change(dev, m):
    """The weights' kernel layout is made once per tensor and made again
    after an in-place change; the kernel then equals the plain version on
    the changed weights."""
    x, w, b = [torch.from_numpy(a).to(dev)
               for a in merger_inputs(m, 31, 11 * m, False)]
    first = merger_int.merger_int_forward(x, w, b)
    wp = merger_int.prepare_weight(w, b)
    assert merger_int.prepare_weight(w, b) is wp
    w[7, 3].neg_()
    b[2].add_(5)
    got = merger_int.merger_int_forward(x, w, b)
    want = merger_int.merger_int_forward(x, w, b, impl="plain")
    torch.cuda.synchronize()
    assert merger_int.prepare_weight(w, b) is not wp
    assert torch.equal(got, want) and not torch.equal(got, first)


def nn_bundles():
    import pickle

    with open(os.path.join(REPO, "artifacts", "training_set", "luminance",
                           "means", "mean_training.pkl"), "rb") as f:
        mean = float(pickle.load(f))
    return {
        "random": zoo.load_bundle_npz(os.path.join(
            REPO, "tests", "golden_torch", "w2_nn_random_bundle.npz")),
        "frozen_singles": zoo.load_quantized_bundle(
            os.path.join(REPO, "artifacts", "frozen",
                         "manifest_quantized.txt"),
            mean, use_pair=False, widths=(4, 8, 16, 32))}


def nn_frame(name):
    if name == "synth64x96":
        rng = np.random.default_rng(5)
        yy, xx = np.mgrid[0:64, 0:96]
        return np.clip(128 + 45 * np.sin(xx / 11.0) + 35 * np.cos(yy / 8.0)
                       + rng.normal(0, 7, (64, 96)), 0, 255).astype(np.uint8)
    return np.load(os.path.join(REPO, "tests", "golden_hm",
                                "128_full_q32_src.npy"))


NN_ENCODES = ("synth64x96/switch/live", "synth64x96/substitution/live",
              "natural128/switch/live", "natural128/substitution/live",
              "synth64x96/switch/rate_evolve")


@pytest.mark.cuda
@pytest.mark.parametrize("key", NN_ENCODES)
def test_kernel_nn_encode_matches_jax_digests(dev, key):
    with open(os.path.join(REPO, "tests", "golden_torch",
                           "w2_nn.json")) as f:
        want = json.load(f)["encodes"][key]
    frame = nn_frame(want["frame"])
    merger_int.reset_launch_counts()
    recon, grids = wavefront2.encode_arrays_wavefront2(
        frame, want["qp"], policy=want["policy"],
        pnn=nn_bundles()[want["bundle"]], rate_evolve=want["rate_evolve"],
        device=dev)
    res = wavefront2._arrays_to_result(frame, want["qp"], (recon,) + grids,
                                       want["policy"], True)
    assert sum(merger_int.launches.values()) > 0
    sha = lambda b: hashlib.sha256(b).hexdigest()
    assert sha(recon.tobytes()) == want["recon"]
    assert sha(res.bitstream) == want["stream"]
    for g, k in zip(grids, GRIDS):
        assert sha(np.ascontiguousarray(g, np.int32).tobytes()) == want[k], k


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("b", [124, 496])
@pytest.mark.parametrize("policy", [None, "append"])
def test_fused_trial_batched_slots(dev, n, b, policy):
    """The trial at the slot counts of batched plans (1080p: 31 slots x 4
    frames, x 16 frames): one launch, equal to the plain trial."""
    tc, (rt, rl, og, mb, rr, nnp) = small_trial_case(dev, n, b, 32, policy)
    pred = nnp if policy else None
    before = unit_fused.launches[n]
    got = unit_fused.trial_apply(tc, rt, rl, og, mb, rr, nn_pred=pred)
    want = unit_fused.trial_apply(tc, rt, rl, og, mb, rr, impl="plain",
                                  nn_pred=pred)
    torch.cuda.synchronize()
    assert unit_fused.launches[n] == before + 1
    for field, x, y in zip(FIELDS, got, want):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), field


@pytest.mark.cuda
@pytest.mark.parametrize("m", [32, 64, 128, 256])
@pytest.mark.parametrize("n", [124, 496])
@pytest.mark.parametrize("extreme", [False, True])
def test_merger_kernel_batched_slots(dev, m, n, extreme):
    x, w, b = [torch.from_numpy(a).to(dev)
               for a in merger_inputs(m, n, 11 * m + n, extreme)]
    got = merger_int.merger_int_forward(x, w, b)
    want = merger_int.merger_int_forward(x, w, b, impl="plain")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["regular", "switch", "substitution"])
def test_kernel_batch_equals_single_frames_and_decodes(dev, policy):
    """A 2-frame batch (the natural crop and its left-right flip) through
    the kernel path: each frame equal to its single-frame kernel encode;
    the port's decoder on the card turns each stream back into its
    reconstruction (frozen singles zoo, QP 32, rate evolution on)."""
    from context_adaptive_neural_network_based_prediction_tpu_torch.codec \
        import decoder

    frame = nn_frame("natural128")
    frames = np.stack([frame, np.ascontiguousarray(frame[:, ::-1])])
    pnn = nn_bundles()["frozen_singles"] if policy != "regular" else None
    batch = wavefront2.encode_frames_wavefront2_batch(
        frames, 32, policy=policy, pnn=pnn, serialize=True,
        rate_evolve=True, device=dev)
    for f, got in zip(frames, batch):
        want = wavefront2.encode_frame_wavefront2(
            f, 32, policy=policy, pnn=pnn, rate_evolve=True, device=dev)
        assert got.bitstream == want.bitstream
        np.testing.assert_array_equal(got.reconstruction,
                                      want.reconstruction)
        dec = decoder.decode_frame(got.bitstream, pnn=pnn, device=dev)
        np.testing.assert_array_equal(dec.reconstruction,
                                      got.reconstruction)


@pytest.mark.cuda
def test_stream_on_card_equals_single_frames(dev):
    frame = nn_frame("synth64x96")
    frames = [frame, frame[::-1].copy(), np.roll(frame, 32, axis=1)]
    got = list(wavefront2.encode_stream_wavefront2(
        iter(frames), 32, batch=2, rate_evolve=True, device=dev))
    assert len(got) == 3
    for f, res in zip(frames, got):
        want = wavefront2.encode_frame_wavefront2(f, 32, rate_evolve=True,
                                                  device=dev)
        assert res.bitstream == want.bitstream
        np.testing.assert_array_equal(res.reconstruction,
                                      want.reconstruction)


# ---------------------------------------------------- float PNN kernels ----

def rel_err(got, want):
    """max |got - want| over max |want|."""
    got, want = got.double(), want.double()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
            ).item()


def fc_weights(w, dtype, dev, seed):
    """An FC PNN's layers with the JAX package's init distributions
    (weights N(0, 0.01) / N(0, 0.029)) and small random biases."""
    rng = np.random.default_rng(seed)
    dims = [(5 * w * w, 1200), (1200, 1200), (1200, 1200), (1200, w * w)]
    ws, bs = [], []
    for (k, d), sd in zip(dims, (0.01, 0.029, 0.029, 0.01)):
        ws.append(torch.from_numpy(rng.normal(0, sd, (k, d)).astype(
            np.float32)).to(dev, dtype))
        bs.append(torch.from_numpy(rng.normal(0, 0.1, d).astype(
            np.float32)).to(dev))
    return ws, bs


@pytest.mark.cuda
@pytest.mark.parametrize("w", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 7, 128, 200, 2048])
def test_fc_kernel_matches_plain(dev, w, dtype, n):
    ws, bs = fc_weights(w, getattr(torch, dtype), dev, 10 * w + n)
    x = torch.from_numpy(np.random.default_rng(n).normal(
        0, 30, (n, 5 * w * w)).astype(np.float32)).to(dev)
    before = fc_forward.launches.get((5 * w * w, 1200), 0)
    got = fc_forward.fc_forward(x, ws, bs)
    want = fc_forward.fc_forward(x, ws, bs, impl="plain")
    torch.cuda.synchronize()
    assert fc_forward.launches[(5 * w * w, 1200)] == before + 1
    assert got.shape == (n, w * w) and got.dtype == torch.float32
    assert rel_err(got, want) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("m", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("n", [1, 31, 256, 2048])
@pytest.mark.parametrize("act", [False, True])
def test_float_merger_kernel_matches_plain(dev, m, n, act):
    rng = np.random.default_rng(3 * m + n)
    x, w, b = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.normal(0, 1, (n, 80, m)), rng.normal(0, 0.1, (80, 16, m)),
        rng.normal(0, 0.1, (16, m)))]
    before = merger.launches.get(m, 0)
    got = merger.merger_forward(x, w, b, act=act)
    want = merger.merger_forward(x, w, b, act=act, impl="plain")
    torch.cuda.synchronize()
    assert merger.launches[m] == before + 1
    assert got.shape == (n, 16, m) and got.dtype == torch.float32
    assert rel_err(got, want) <= 1e-5
    got = merger.merger_forward(x, w.to(torch.bfloat16), b, act=act)
    want = merger.merger_forward(x, w.to(torch.bfloat16), b, act=act,
                                 impl="plain")
    assert rel_err(got, want) <= 1e-5


FC_LAYER_SHAPES = sorted({(5 * w * w, 1200) for w in (4, 8)}
                         | {(1200, 1200)} | {(1200, w * w) for w in (4, 8)})


@pytest.mark.cuda
@pytest.mark.parametrize("k,d", FC_LAYER_SHAPES)
@pytest.mark.parametrize("n", [1, 7, 127, 129, 200, 1024, 2048])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fc_layer_kernel_edges(dev, k, d, n, dtype):
    # Every layer shape of the w4 and w8 chains, at batches around the
    # kernel's 64-row tiles and its K splits (small N, D = w^2).
    rng = np.random.default_rng(k + d + n)
    x = torch.from_numpy(rng.normal(0, 30, (n, k)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(0, 0.03, (k, d)).astype(np.float32)).to(
        dev, getattr(torch, dtype))
    b = torch.from_numpy(rng.normal(0, 0.1, d).astype(np.float32)).to(dev)
    act = d == 1200
    before = fc_forward.launches.get((k, d), 0)
    got = fc_forward._kernel_layer(x, w, b, act)
    again = fc_forward._kernel_layer(x, w, b, act)
    want = fc_forward._layer_plain(x, w, b, act)
    torch.cuda.synchronize()
    assert fc_forward.launches[(k, d)] == before + 2
    assert got.shape == (n, d) and got.dtype == torch.float32
    assert torch.equal(got, again)
    assert rel_err(got, want) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("m", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("n", [1, 31, 33, 1024, 2048])
@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_float_merger_kernel_edges(dev, m, n, act, dtype):
    # Slot counts around the merger's 2-slot groups and per-block chunks.
    rng = np.random.default_rng(7 * m + n)
    x, w, b = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.normal(0, 1, (n, 80, m)), rng.normal(0, 0.1, (80, 16, m)),
        rng.normal(0, 0.1, (16, m)))]
    w = w.to(getattr(torch, dtype))
    before = merger.launches.get(m, 0)
    got = merger.merger_forward(x, w, b, act=act)
    again = merger.merger_forward(x, w, b, act=act)
    want = merger.merger_forward(x, w, b, act=act, impl="plain")
    torch.cuda.synchronize()
    assert merger.launches[m] == before + 2
    assert got.shape == (n, 16, m) and got.dtype == torch.float32
    assert torch.equal(got, again)
    assert rel_err(got, want) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("name", float_golden.MODELS)
def test_float_path_matches_jax_goldens(dev, name):
    golden = float_golden.load(REPO)
    fc_forward.reset_launch_counts()
    merger.reset_launch_counts()
    report = float_golden.check_model(golden, name, dev)
    assert report["forward_rel_err"] <= 1e-4, report
    assert report["contexts_equal"], report
    launches = {("fc", k): v for k, v in fc_forward.launches.items()}
    launches.update({("merger", k): v for k, v in merger.launches.items()})
    assert launches == float_golden.forward_launches(name, report["n"])
    rows = float_golden.check_comparison(golden, name, dev)
    assert rows["max_psnr_diff"] <= 0.01, rows
    assert rows["max_win_diff"] <= 2 / rows["n"], rows


@pytest.mark.cuda
def test_float_kernels_bf16_match_pallas_goldens(dev):
    golden = float_golden.load(REPO)
    for key, err in float_golden.check_pallas(golden, dev).items():
        assert err <= (1e-4 if key.startswith("fc") else 1e-5), (key, err)


# ------------------------------------------- v1 wavefront and quantize ----

def v1_golden():
    with open(os.path.join(REPO, "tests", "golden_torch", "w1.json")) as f:
        return json.load(f)["cases"]


def v1_frame(spec):
    from context_adaptive_neural_network_based_prediction_tpu_torch \
        .evaluation.v1_frames import make_frame

    return make_frame(spec)


def sha256(a):
    if isinstance(a, (bytes, bytearray)):
        return hashlib.sha256(bytes(a)).hexdigest()
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "natural64x96s1_q32_n8", "natural64x96s1_q32_n16",
    "natural64x96s1_q32_n32", "natural64x64s2_q22_n16",
    "natural64x64s2_q42_n16", "natural48x48s3_q27_n16",
    "flat32x32_q22_n16", "smooth64x96_q32_n32"])
def test_v1_encode_on_card_matches_jax_digests(dev, case):
    """The v1 encoder on the card (one launch of the step kernel a step,
    `ops/v1_step.py`, and no other kernel) gives the JAX package's digests
    and decodes back."""
    from context_adaptive_neural_network_based_prediction_tpu_torch.codec \
        import decoder
    from context_adaptive_neural_network_based_prediction_tpu_torch \
        .parallel import wavefront

    g = v1_golden()[case]
    frame = v1_frame(g["frame"])
    v1_step.reset_launch_counts()
    unit_fused.reset_launch_counts()
    res = wavefront.encode_frame_wavefront(frame, g["qp"],
                                           block_size=g["block_size"],
                                           device=dev)
    _, modes, qcoeffs = wavefront.encode_frames_wavefront_batch(
        np.stack([frame, frame[::-1].copy()]), g["qp"],
        block_size=g["block_size"], device=dev)
    plan, _ = wavefront._get_plan(*frame.shape, g["block_size"], g["qp"], 1,
                                  dev)
    assert v1_step.launches == {g["block_size"]: 2 * plan["n_steps"]}
    assert not any(unit_fused.launches.values())
    assert (sha256(res.reconstruction), sha256(modes[0].astype(np.int32)),
            sha256(qcoeffs[0].astype(np.int32)), sha256(res.bitstream)) == (
        g["recon"], g["modes"], g["qcoeffs"], g["stream"])
    dec = decoder.decode_frame(
        res.bitstream, device=dev,
        strong_intra_smoothing=g["block_size"] != 32)
    np.testing.assert_array_equal(dec.reconstruction, res.reconstruction)


def v1_frames(kind, nf, h, w, seed):
    """natural (`v1_frames.make_frame`), flat or binary 0 / 255 frames."""
    if kind == "natural":
        return np.stack([v1_frame({"kind": "natural", "h": h, "w": w,
                                   "seed": seed + f}) for f in range(nf)])
    if kind == "flat":
        return np.stack([np.full((h, w), 77 + 30 * f, np.uint8)
                         for f in range(nf)])
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, (nf, h, w)) * 255).astype(np.uint8)


def v1_kernel_against_plain(dev, h, w, n, qp, nf, kind, top=0,
                            has_halo=False):
    """A whole encode, step by step: the kernel's step on one copy of the
    state and the plain `_step` on another, the reconstruction (halo row
    included), modes and levels equal after every step (the pad rows and
    cells below the frames aside: only the plain step writes them, and
    nothing reads them).  Returns the step count."""
    from context_adaptive_neural_network_based_prediction_tpu_torch \
        .parallel import wavefront

    plan, dp = wavefront._get_plan(h, w, n, qp, nf, dev, top, has_halo)
    st = wavefront._state(plan, v1_frames(kind, nf, h, w, 7), dev)
    if top:      # the halo row as a stripe above would have left it
        st["recon"].view(nf, top + h + n, w)[:, 0] = torch.from_numpy(
            np.random.default_rng(3).integers(0, 256, w)).int().to(dev)
    kst = {k: v.clone() for k, v in st.items()}
    step = v1_step.stepper(plan, dp, kst)
    nby, nbx = plan["nby"], plan["nbx"]
    parts = lambda s: (s["recon"].view(nf, top + h + n, w)[:, :top + h],
                       s["modes"].view(nf, nby + 1, nbx)[:, :nby],
                       s["qcoeffs"].view(nf, nby + 1, nbx, n, n)[:, :nby])
    for t in range(plan["n_steps"]):
        wavefront._step(plan, dp, st, t)
        step(t)
        for name, a, b in zip(("recon", "modes", "levels"), parts(st),
                              parts(kst)):
            assert torch.equal(a, b), (name, t)
    return plan["n_steps"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["natural", "flat", "binary"])
@pytest.mark.parametrize("qp", [0, 22, 32, 51])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_v1_step_kernel_equals_plain_step(dev, n, qp, kind):
    """The step kernel against the plain `_step`, step by step over a
    whole one-frame encode, at every block size, QP 0 (the largest levels)
    to 51, on natural, flat and binary 0 / 255 content; one launch a
    step."""
    h, w = (64, 96) if n == 32 else (4 * n, 6 * n) if n == 16 else (32, 48)
    v1_step.reset_launch_counts()
    steps = v1_kernel_against_plain(dev, h, w, n, qp, 1, kind)
    assert v1_step.launches == {n: steps}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_v1_step_kernel_batch_of_three_equals_plain_step(dev, n):
    v1_kernel_against_plain(dev, 3 * n, 5 * n, n, 27, 3, "natural")


@pytest.mark.cuda
@pytest.mark.parametrize("has_halo", [False, True])
@pytest.mark.parametrize("n", [8, 16, 32])
def test_v1_step_kernel_halo_plan_equals_plain_step(dev, n, has_halo):
    """A halo rank's plan (`top` = 1; `has_halo`: a stripe below
    another, whose first block row reads the halo row)."""
    v1_kernel_against_plain(dev, 2 * n, 5 * n, n, 30, 2, "natural", top=1,
                            has_halo=has_halo)


@pytest.mark.cuda
def test_v1_step_kernel_counts_its_launches(dev):
    """An encode launches the kernel once a step: `launches` and the
    tracer's `v1.step_kernel` counter both read the step count, and the
    result equals the CPU's plain encode."""
    from context_adaptive_neural_network_based_prediction_tpu_torch \
        .parallel import wavefront
    from context_adaptive_neural_network_based_prediction_tpu_torch.utils \
        import profiling

    frames = v1_frames("natural", 2, 48, 80, 11)
    plan, _ = wavefront._get_plan(48, 80, 16, 32, 2, dev)
    v1_step.reset_launch_counts()
    profiling.reset()
    profiling.enable()
    try:
        got = wavefront.encode_frames_wavefront_batch(frames, 32, device=dev)
        counted = profiling.counters().get("v1.step_kernel")
    finally:
        profiling.disable()
        profiling.reset()
    assert v1_step.launches == {16: plan["n_steps"]}
    assert counted == plan["n_steps"]
    want = wavefront.encode_frames_wavefront_batch(frames, 32, device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pnn_w4_fc_single", "pnn_w8_fc_single",
                                  "pnn_w4_refconv_single",
                                  "pnn_w8_refconv_single", "pnn_w16_single",
                                  "pnn_w32_single"])
def test_quantize_on_card_matches_jax_goldens(dev, name):
    """`quantize_pnn` with its float forward on the card (the FC and float
    merger kernels) against the JAX package's frozen form: integers equal,
    scales within 1e-4, biases within 1 + 1e-4 |bias|."""
    from context_adaptive_neural_network_based_prediction_tpu_torch \
        .evaluation import quantize_golden

    golden = quantize_golden.load(REPO)
    fc_forward.reset_launch_counts()
    merger.reset_launch_counts()
    q = quantize_golden.quantize(golden, name, dev)
    rep = quantize_golden.compare(golden, name, q, 1e-4)
    assert quantize_golden.within(rep, 1e-4), rep
    launched = sum(fc_forward.launches.values()) + sum(
        merger.launches.values())
    assert launched == (3 if "_fc_" in name else 1)


# ------------------------------------------------------------ host codec --

@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pnn_w4_fc_pair", "pnn_w8_fc_pair",
                                  "pnn_w4_refconv_single", "pnn_w16_pair",
                                  "pnn_w32_pair", "pnn_w32_single"])
def test_host_float_forward_at_one_context(dev, name):
    """The host encoder's float fallback: one context (N = 1) through the
    frozen float model's kernels (FC chain or float merger) against the
    plain versions, within 1e-4 of max |plain|.  The float w64 models
    (73 MiB each) are not copied to the card; the float merger at
    M = 512, N = 1 is in `test_float_merger_kernel_matches_plain`."""
    from context_adaptive_neural_network_based_prediction_tpu_torch.models \
        import pnn

    params, is_fc = zoo.load_frozen_params(os.path.join(
        REPO, "artifacts", "frozen", name + ".npz"))
    w = int(name.split("_")[1][1:])
    tp = zoo.params_from_numpy(params, dev)
    rng = np.random.default_rng(w)
    if is_fc:
        inputs = torch.from_numpy(rng.normal(0, 30, (1, 5 * w * w)).astype(
            np.float32)).to(dev)
    else:
        inputs = tuple(torch.from_numpy(rng.normal(0, 30, s).astype(
            np.float32)).to(dev) for s in ((1, w, 3 * w, 1),
                                           (1, 2 * w, w, 1)))
    fc_forward.reset_launch_counts()
    merger.reset_launch_counts()
    got = pnn.forward(tp, inputs, w, is_fc)
    counts = (sum(fc_forward.launches.values()),
              sum(merger.launches.values()))
    orig = fc_forward.fc_forward, merger.merger_forward
    fc_forward.fc_forward = lambda x, ws, bs, impl="kernel": orig[0](
        x, ws, bs, impl="plain")
    merger.merger_forward = lambda x, w_, b, act=False, impl="kernel": \
        orig[1](x, w_, b, act=act, impl="plain")
    try:
        want = pnn.forward(tp, inputs, w, is_fc)
    finally:
        fc_forward.fc_forward, merger.merger_forward = orig
    assert counts == ((4, 0) if is_fc else (0, 1))
    assert rel_err(got, want) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("policy,qp", [("regular", 27), ("switch", 37),
                                       ("substitution", 27)])
def test_host_encode_on_card_matches_jax_digests(dev, policy, qp):
    """`FrameEncoder` on the card (the quantized zoo's forwards through
    the integer merger kernel, w64 at M = 512) against
    `tests/golden_torch/host_codec.json`, decoded back by the port's
    decoder and, as an Annex-B stream, by its HM-syntax decoder."""
    from context_adaptive_neural_network_based_prediction_tpu_torch.codec \
        import decoder, encoder, hm_decoder, hm_encoder
    from context_adaptive_neural_network_based_prediction_tpu_torch \
        .evaluation import host_cases as hc

    with open(hc.GOLDEN) as f:
        want = json.load(f)["encodes"][f"natural128/{policy}/q{qp}"]
    bundle = (zoo.load_quantized_bundle(hc.MANIFEST_QUANTIZED,
                                        hc.mean_training())
              if policy != "regular" else None)
    frame = hc.load_frame("natural128")
    merger_int.reset_launch_counts()
    res = encoder.encode_frame(frame, qp, policy=policy, pnn=bundle,
                               device=dev)
    assert sha256(res.bitstream) == want["stream"]
    assert sha256(np.asarray(res.reconstruction, np.uint8)) == want["recon"]
    assert sha256(np.asarray(res.mode_map, np.int32)) == want["mode_map"]
    if policy != "regular":
        assert sum(merger_int.launches.values()) > 0
    dec = decoder.decode_frame(res.bitstream, pnn=bundle, device=dev)
    np.testing.assert_array_equal(dec.reconstruction, res.reconstruction)
    stream, res_hm = hm_encoder.encode_frame_hm(frame, qp, policy=policy,
                                                pnn=bundle, device=dev)
    hd = hm_decoder.decode_hm_stream(stream, policy=policy, pnn=bundle,
                                     device=dev, use_native="always")
    assert hd.hash_ok
    np.testing.assert_array_equal(hd.reconstruction, res_hm.reconstruction)


# ------------------------------------------------------------- training ----

def train_batch(w, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, w, 3 * w, 1), dtype=np.uint8),
            rng.integers(0, 256, (n, 2 * w, w, 1), dtype=np.uint8),
            rng.integers(0, 256, (n, w, w, 1), dtype=np.uint8))


TRAIN_KW = dict(coeff_l2=1.0, coeff_grad=0.5, random_masks=True,
                total_iters=40)


@pytest.mark.cuda
@pytest.mark.parametrize("w,fc", [(8, True), (16, False)],
                         ids=["fc_w8", "conv_w16"])
def test_train_step_on_card_matches_cpu(dev, w, fc):
    """One training step's loss and gradients on the card against the same
    step on the CPU in float64 (same init, batch and masks): loss within
    1e-5 relative; per leaf, 98% of the gradient entries within 1e-4 of
    the leaf's max |g| and all within 5e-2 (a LeakyReLU input within
    rounding of 0 may take the other slope).  The reference is float64:
    float32 gradients of sums over many positions cancel, and the CPU's
    own float32 ones are up to a few 1e-2 of a leaf's max off."""
    from context_adaptive_neural_network_based_prediction_tpu_torch.models \
        import training

    b = train_batch(w, 32, 1)
    wa, hl = training.draw_masks(torch.Generator().manual_seed(1), 32, w)
    out = {}
    for d, cast in (("cpu", torch.Tensor.double), (dev, None)):
        params = training.init_state(torch.Generator().manual_seed(0), w,
                                     fc, device=d).params
        if cast is not None:
            params = training.tree_map(cast, params)
        with training.exact_steps():
            out[str(d)] = training.loss_and_grads(
                params, *b, 86.8568, wa, hl, width_target=w,
                is_fully_connected=fc, coeff_l2=1.0, coeff_grad=0.5)
    (lc, _, gc), (lg, _, gg) = out["cpu"], out[str(dev)]
    assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
    gg = dict(_leaves(gg))
    for k, want in _leaves(gc):
        err = ((gg[k].cpu().double() - want).abs() / want.abs().max()).numpy()
        assert np.mean(err <= 1e-4) >= 0.98 and err.max() <= 5e-2, k


@pytest.mark.cuda
@pytest.mark.parametrize("w,fc", [(8, True), (16, False)],
                         ids=["fc_w8", "conv_w16"])
def test_resume_on_card_equals_uninterrupted_run(dev, w, fc, tmp_path):
    from context_adaptive_neural_network_based_prediction_tpu_torch.models \
        import training

    kw = dict(TRAIN_KW, width_target=w, is_fully_connected=fc)
    bs = [train_batch(w, 32, s) for s in range(6)]
    a, l, t = (np.stack([b[i] for b in bs]) for i in range(3))
    gen = torch.Generator().manual_seed(1)
    state = training.init_state(torch.Generator().manual_seed(0), w, fc,
                                device=dev)
    state, _ = training.train_chunk(state, gen, a[:3], l[:3], t[:3],
                                    86.8568, (0, 0), **kw)
    path = training.save_checkpoint(state, str(tmp_path), gen)
    whole, lw = training.train_chunk(state, gen, a[3:], l[3:], t[3:],
                                     86.8568, (0, 0), **kw)
    gen2 = torch.Generator()
    resumed = training.restore_checkpoint(path, w, device=dev,
                                          generator=gen2)
    resumed, lr = training.train_chunk(resumed, gen2, a[3:], l[3:], t[3:],
                                       86.8568, (0, 0), **kw)
    assert torch.equal(lw, lr)
    x = training.state_to_numpy(whole)
    y = training.state_to_numpy(resumed)
    for tree in (lambda s: s["params"], lambda s: s["opt_state"][0].mu,
                 lambda s: s["opt_state"][0].nu):
        want = dict(_leaves(tree(x)))
        got = dict(_leaves(tree(y)))
        assert got.keys() == want.keys()
        for k in want:
            assert np.array_equal(got[k], want[k]), k


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


@pytest.mark.cuda
def test_train_step_on_card_gives_the_flags_back(dev):
    from context_adaptive_neural_network_based_prediction_tpu_torch.models \
        import training

    flags = lambda: (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32,
                     torch.backends.cudnn.enabled)
    old = flags()
    try:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.enabled) = (True, True, True)
        state = training.init_state(torch.Generator().manual_seed(0), 16,
                                    False, device=dev)
        kw = dict(width_target=16, is_fully_connected=False,
                  random_masks=False)
        state, loss, _ = training.train_step(
            state, None, *train_batch(16, 8, 2), 86.8568, (0, 0),
            coeff_l2=1.0, coeff_grad=0.0, **kw)
        assert torch.isfinite(loss) and flags() == (True, True, True)
        with pytest.raises(ValueError):
            training.train_step(state, None, *train_batch(16, 8, 3),
                                86.8568, (0, 0), coeff_l2=0.0,
                                coeff_grad=0.0, **kw)
        assert flags() == (True, True, True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.enabled) = old


@pytest.mark.cuda
def test_kernel_forward_after_a_training_step_sees_the_new_weights(dev):
    """The FC kernel's prepared weights (`prepare_weight`, keyed by the
    tensor and its `_version`) follow the in-place Adam update."""
    from context_adaptive_neural_network_based_prediction_tpu_torch.models \
        import pnn, training

    state = training.init_state(torch.Generator().manual_seed(0), 8, True,
                                device=dev)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 30, (64, 320)).astype(np.float32)).to(dev)
    fc_forward.reset_launch_counts()
    before = pnn.forward(state.params, x, 8, True)
    state, _, _ = training.train_step(
        state, None, *train_batch(8, 32, 4), 86.8568, (0, 0),
        width_target=8, is_fully_connected=True, random_masks=False,
        coeff_l2=1.0, coeff_grad=0.0)
    after = pnn.forward(state.params, x, 8, True)
    assert sum(fc_forward.launches.values()) == 8
    with torch.no_grad():
        want = pnn.forward_train(state.params, x, 8, True)
    assert not torch.equal(before, after)
    assert rel_err(after, want) <= 1e-4


def _tiled_frame():
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:128, 0:64]
    return np.clip(128 + 45 * np.sin(xx / 11.0) + 35 * np.cos(yy / 8.0)
                   + rng.normal(0, 7, (128, 64)), 0, 255).astype(np.uint8)


@pytest.mark.cuda
def test_tiled_halo_v1_two_ranks_on_card_equal_single_device(dev):
    """Two Gloo ranks on the card: the v1 halo encode (`top` = 1 plans,
    the halo row exchanged between the step kernel's launches) equals the
    single-device encode, and each rank launched the kernel once a step
    of its stripe's schedule."""
    from context_adaptive_neural_network_based_prediction_tpu_torch \
        .parallel import mesh, tiled, wavefront

    frame = _tiled_frame()
    ranks = mesh.spawn_ranks(
        tiled.encode_cases, 2, device="cuda:0", timeout=600,
        args=([("encode_frame_tiled_halo", frame, 32,
                dict(block_size=16, device="cuda"))],))
    single = wavefront.encode_frame_wavefront(frame, 32, block_size=16,
                                              device=dev)
    plan, _ = wavefront._get_plan(64, 64, 16, 32, 1, dev)
    for (results, launches) in ranks:
        recon, modes, _ = results[0]
        np.testing.assert_array_equal(recon, single.reconstruction)
        np.testing.assert_array_equal(
            np.repeat(np.repeat(modes, 4, 0), 4, 1), single.mode_map)
        assert launches["v1_step"] == {16: plan["n_steps"]}
        assert not any(launches["unit_trial"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["regular", "switch"])
def test_tiled_halo_v2_two_ranks_on_card_equal_single_device(dev, policy):
    """Two Gloo ranks on the card: `encode_frame_tiled_halo_v2` equals
    the single-device kernel-path encode (reconstruction, mode map,
    stream) on both ranks; each rank launched the trial kernel, and under
    switch the integer merger."""
    from context_adaptive_neural_network_based_prediction_tpu_torch \
        .parallel import mesh, tiled

    bundle = zoo.load_bundle_npz(os.path.join(
        REPO, "tests", "golden_torch", "w2_nn_random_bundle.npz")) \
        if policy == "switch" else None
    frame = _tiled_frame()
    ranks = mesh.spawn_ranks(
        tiled.encode_cases, 2, device="cuda:0", timeout=600,
        args=([("encode_frame_tiled_halo_v2", frame, 37,
                dict(policy=policy, pnn=bundle, serialize=True,
                     device="cuda"))],))
    single = wavefront2.encode_frame_wavefront2(frame, 37, policy=policy,
                                                pnn=bundle, device=dev)
    for results, launches in ranks:
        got = results[0]
        np.testing.assert_array_equal(got.reconstruction,
                                      single.reconstruction)
        np.testing.assert_array_equal(got.mode_map, single.mode_map)
        assert got.bitstream == single.bitstream
        assert sum(launches["unit_trial"].values()) > 0
        assert (sum(launches["merger_int"].values()) > 0) == \
            (policy == "switch")


@pytest.mark.cuda
@pytest.mark.parametrize("w,fc,axis", [(4, True, {"data": 2, "model": 1}),
                                       (8, False, {"data": 1, "model": 2})],
                         ids=["fc_w4_dp2", "conv_w8_tp2"])
def test_sharded_chunk_on_card_matches_single_device(dev, w, fc, axis):
    """A 3-step chunk over 2 Gloo ranks on the card against the
    single-device chunk on the card: losses within 1e-5 relative, Adam
    moments within 1e-5 of each leaf's max |value|, parameters so too at
    all but 1e-4 of a leaf's entries and those within 2 K lr (Adam's
    update amplifies the rounding of gradients of the order of its eps)."""
    import math

    from context_adaptive_neural_network_based_prediction_tpu_torch \
        .models import training
    from context_adaptive_neural_network_based_prediction_tpu_torch \
        .parallel import mesh, sharded_training

    k = 3
    bs = [train_batch(w, 32, s) for s in range(k)]
    a, l, t = (np.stack([b[i] for b in bs]) for i in range(3))
    state = training.init_state(torch.Generator().manual_seed(0), w, fc,
                                device=dev)
    blob = training.state_to_numpy(state)
    gen = torch.Generator().manual_seed(1)
    got = mesh.spawn_ranks(
        sharded_training.chunk_from_state, 2, device="cuda:0", timeout=600,
        args=(axis, w, fc, blob, gen.get_state().numpy(), a, l, t, 86.8568),
        kwargs=dict(device="cuda"))
    ref_state, ref_losses = training.train_chunk(
        state, gen, a, l, t, 86.8568, (0, 0), width_target=w,
        is_fully_connected=fc, coeff_l2=1.0, coeff_grad=0.0,
        random_masks=True)
    ref = training.state_to_numpy(ref_state)
    losses, blob_k = got[0]
    np.testing.assert_allclose(losses, ref_losses.cpu().numpy(), rtol=1e-5,
                               atol=0)
    lr = float(training.learning_rate_schedule(w)(0))
    pairs = [(blob_k["params"], ref["params"], True),
             (blob_k["opt_state"][0].mu, ref["opt_state"][0].mu, False),
             (blob_k["opt_state"][0].nu, ref["opt_state"][0].nu, False)]
    for tree, want, is_params in pairs:
        got_l, want_l = dict(_leaves(tree)), dict(_leaves(want))
        for key, b in want_l.items():
            b = np.asarray(b)
            d = np.abs(np.asarray(got_l[key]) - b)
            off = int((d > 1e-5 * np.abs(b).max()).sum())
            if is_params:
                assert off <= math.ceil(1e-4 * d.size), (key, off)
                assert d.max() <= 2 * k * lr, key
            else:
                assert off == 0, key


def transform_blocks(n, seed, lo=-32768, hi=32767):
    """Seeded (B, n, n) int32 blocks over the 16-bit range, its extremes
    included."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    return np.concatenate([
        rng.integers(lo, hi + 1, (16, n, n)), np.full((1, n, n), lo),
        np.full((1, n, n), hi), np.where((yy + xx) % 2, lo, hi)[None]]
    ).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("n,dst", [(4, False), (4, True), (8, False),
                                   (16, False), (32, False)],
                         ids=["dct4", "dst4", "dct8", "dct16", "dct32"])
def test_transforms_on_card_equal_cpu(dev, n, dst):
    """The batched transforms and quantiser on CUDA tensors give the CPU's
    results (float64 products on the card, int64 elsewhere), at QP 0-51
    and both slice types."""
    x = torch.from_numpy(transform_blocks(n, 7 * n + dst))
    xd = x.to(dev)
    for fn in (transform.forward_transform, transform.inverse_transform):
        got = fn(xd, use_dst=dst)
        assert got.device == xd.device and got.dtype == torch.int32
        assert torch.equal(got.cpu(), fn(x, use_dst=dst)), fn.__name__
    for qp in range(52):
        for intra in (True, False):
            assert torch.equal(
                transform.quantize(xd, qp, is_intra_slice=intra).cpu(),
                transform.quantize(x, qp, is_intra_slice=intra)), (qp, intra)
        assert torch.equal(transform.dequantize(xd, qp).cpu(),
                           transform.dequantize(x, qp)), qp


@pytest.mark.cuda
@pytest.mark.parametrize("w", [4, 8, 16, 32])
def test_predict_via_hevc_mode_on_card_equals_cpu(dev, w):
    from context_adaptive_neural_network_based_prediction_tpu_torch.ops \
        import intra

    rng = np.random.default_rng(w)
    for h_ip, w_ip in ((w + 1, w + 1), (2 * w + 1, w + 1), (w + 1, 2 * w + 1),
                       (2 * w + 1, 2 * w + 1)):
        pat = rng.integers(0, 256, (h_ip, w_ip, 1), dtype=np.uint8)
        for mode in range(35):
            got = intra.predict_via_hevc_mode(pat, w, mode, device=dev)
            want = intra.predict_via_hevc_mode(pat, w, mode, device="cpu")
            np.testing.assert_array_equal(got, want, err_msg=f"mode {mode}")


@pytest.mark.cuda
def test_ycbcr_to_rgb_on_card_equals_numpy(dev):
    from context_adaptive_neural_network_based_prediction_tpu_torch.utils \
        import color

    cb, cr = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for y in (0, 16, 128, 235, 255):
        img = np.stack([np.full_like(cb, y), cb, cr], 2).astype(np.uint8)
        got = color.ycbcr_to_rgb(torch.from_numpy(img).to(dev))
        assert got.device == dev and got.dtype == torch.uint8
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      color.ycbcr_to_rgb(img))
