"""Tests of the port that need an NVIDIA card (marker `cuda`).

They hold the CUDA kernels against their plain PyTorch versions on the
card (exactly): the unit trial, also with a PNN prediction under the
substitution (`sub18`) and switch (`append`) policies, and the PNN's
integer merger at every map count of the codec, with random inputs and
inputs at the frozen models' caps.  The kernel path's encodes of the small
test frames, regular and NN policies, are held against the digests
captured from the JAX package.  Without a card they skip.  The file imports no JAX, so it runs on a machine without it:

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
from context_adaptive_neural_network_based_prediction_tpu_torch.models import (
    zoo)
from context_adaptive_neural_network_based_prediction_tpu_torch.ops import (
    merger_int, transform, unit_fused)
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
@pytest.mark.parametrize("m", [32, 64, 128, 256])
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
