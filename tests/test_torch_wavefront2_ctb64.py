"""The port's wavefront encoder at CTB 64 against the JAX package's, with zero
tolerance.

Config: CTB 64 (HM's intra_main_rext geometry: the 32-rooted quadtree in
each quadrant, then a 64x64 2Nx2N candidate with four forced TU32s), NxN
on, rate evolution off (the JAX package has none at CTB 64), policies
`regular`, `switch` and `substitution`.  The port runs on the CPU (plain
trial, plain merger).  Frames and bundles are those of
`tests/golden_torch/w2_ctb64.json`
(`scripts/capture_torch_port_golden_ctb64.py`): here the smooth seeded 64x128 frame at QP 37 with the random quantized
bundle of `w2_nn_random_bundle.npz` (its encodes choose 64x64 leaves); in
`test_torch_wavefront2_ctb64_natural.py` the 128x128 natural crop at QP
32 with the frozen singles zoo.

* The CTB-64 geometry tables (coding order, reference fill tables, PNN
  context tables) equal the JAX functions', and the port's CTB-64 plan
  (trial constants, per-(slot, frame) tables of a 2-frame switch plan and
  the 64 candidate's reference tables) equals what the JAX package's
  built CTB-64 encoder holds and gathers.
* The reconstruction, the 14 grids of `_assemble_arrays` and the stream
  equal the JAX package's digests, one frame a call (b = 1) and a batch
  of two (the frame and its mirror, b = 2); each batched frame equals its
  own b = 1 encode, and so does each frame of a CTB-64 stream.
* A live JAX comparison, the switch encode of the smooth frame, runs in
  `test_torch_wavefront2_ctb64_live.py`.
* `ctb=64, rate_evolve=True` raises `NotImplementedError` and `ctb=16`
  `ValueError`, as in the JAX package.
"""

import hashlib
import json
import os
import pickle

import numpy as np
import pytest
import torch

from context_adaptive_neural_network_based_prediction_tpu.codec import (
    nn_intra as j_nn_intra)
from context_adaptive_neural_network_based_prediction_tpu.models import (
    pnn_q as j_pnn_q)
from context_adaptive_neural_network_based_prediction_tpu.parallel import (
    wavefront2 as j_wavefront2)
from context_adaptive_neural_network_based_prediction_tpu_torch.codec import (
    nn_intra as t_nn_intra)
from context_adaptive_neural_network_based_prediction_tpu_torch.models import (
    zoo as t_zoo)
from context_adaptive_neural_network_based_prediction_tpu_torch.parallel import (
    wavefront2 as t_wavefront2)

from test_torch_tables import assert_same, closure_vars

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden_torch", "w2_ctb64.json")
FROZEN = os.path.join(REPO, "artifacts", "frozen")
MANIFEST = os.path.join(FROZEN, "manifest_quantized.txt")
MEAN_PKL = os.path.join(REPO, "artifacts", "training_set", "luminance",
                        "means", "mean_training.pkl")
RANDOM_BUNDLE = os.path.join(REPO, "tests", "golden_torch",
                             "w2_nn_random_bundle.npz")
GRIDS = ("m8", "q8", "s8", "m4", "q4", "m16", "q16", "s16", "m32", "q32",
         "s32", "m64", "q64", "s64")
ITEMS = ("recon",) + GRIDS + ("stream",)
POLICIES = ("regular", "switch", "substitution")
# (n_frames, frame index) of every digest of a (frame, policy).
RUNS = ((1, 0), (2, 0), (2, 1))


def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def frames():
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:64, 0:128]
    smooth = np.clip(128 + 40 * np.sin(xx / 37.0) + 30 * np.cos(yy / 41.0)
                     + rng.normal(0, 3, (64, 128)), 0, 255).astype(np.uint8)
    natural = np.load(os.path.join(REPO, "tests", "golden_hm",
                                   "128_full_q32_src.npy"))
    return {"smooth64x128": smooth, "natural128": natural}


def sha(a):
    if isinstance(a, (bytes, bytearray)):
        return hashlib.sha256(bytes(a)).hexdigest()
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def mean_training():
    with open(MEAN_PKL, "rb") as f:
        return float(pickle.load(f))


def port_bundle(name):
    if name == "random":
        return t_zoo.load_bundle_npz(RANDOM_BUNDLE)
    return t_zoo.load_quantized_bundle(MANIFEST, mean_training(),
                                       use_pair=False, widths=(4, 8, 16, 32))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def items(frame, qp, recon, grids, policy):
    res = t_wavefront2._arrays_to_result(frame, qp, (recon,) + grids, policy,
                                         True, ctb=64)
    out = {"recon": sha(np.asarray(recon, np.uint8)),
           "stream": sha(res.bitstream)}
    out.update((k, sha(np.asarray(g, np.int32))) for k, g in zip(GRIDS,
                                                                  grids))
    return out


def port_encodes(frame_name):
    """The port's CTB-64 encodes of one golden frame on the CPU: per policy
    {(n_frames, index): digests}, plus the b = 1 encode of the mirror."""
    g = golden()["encodes"]
    frame = frames()[frame_name]
    batch = np.stack([frame, frame[:, ::-1]])
    out = {}
    for policy in POLICIES:
        e = g[f"{frame_name}/{policy}/b1/0"]
        pnn = None if policy == "regular" else port_bundle(e["bundle"])
        kw = dict(policy=policy, pnn=pnn, ctb=64, device="cpu")
        runs = {}
        for f, fr in enumerate(batch):
            recon, grids = t_wavefront2.encode_arrays_wavefront2(
                fr, e["qp"], **kw)
            runs[("single", f)] = items(fr, e["qp"], recon, grids, policy)
        for f, (recon, grids) in enumerate(
                t_wavefront2.encode_arrays_wavefront2_batch(batch, e["qp"],
                                                            **kw)):
            runs[(2, f)] = items(batch[f], e["qp"], recon, grids, policy)
        runs[(1, 0)] = runs[("single", 0)]
        out[policy] = runs
    return out


@pytest.fixture(scope="module")
def port_smooth():
    return port_encodes("smooth64x128")


def check_golden(port, frame_name, policy, nf, f, item):
    want = golden()["encodes"][f"{frame_name}/{policy}/b{nf}/{f}"]
    assert port[policy][(nf, f)][item] == want[item], (
        f"{frame_name} {policy} b{nf} frame {f}: {item}")


@pytest.mark.parametrize("item", ITEMS)
@pytest.mark.parametrize("nf,f", RUNS)
@pytest.mark.parametrize("policy", POLICIES)
def test_smooth_encode_matches_jax_digests(port_smooth, policy, nf, f, item):
    check_golden(port_smooth, "smooth64x128", policy, nf, f, item)


@pytest.mark.parametrize("f", [0, 1])
@pytest.mark.parametrize("policy", POLICIES)
def test_smooth_batched_frame_equals_single(port_smooth, policy, f):
    assert port_smooth[policy][(2, f)] == port_smooth[policy][("single", f)]


def test_smooth_stream_at_ctb64_equals_single_frames(port_smooth):
    """`encode_stream_wavefront2` at CTB 64: three frames at batch 2 (one
    full batch and one padded) give each frame's own b = 1 stream."""
    frame = frames()["smooth64x128"]
    seq = [frame, np.ascontiguousarray(frame[:, ::-1]), frame]
    qp = golden()["encodes"]["smooth64x128/regular/b1/0"]["qp"]
    out = list(t_wavefront2.encode_stream_wavefront2(
        iter(seq), qp, batch=2, ctb=64, device="cpu"))
    want = [port_smooth["regular"][("single", f)] for f in (0, 1, 0)]
    assert [sha(r.bitstream) for r in out] == [w["stream"] for w in want]
    assert [sha(r.reconstruction) for r in out] == [w["recon"]
                                                   for w in want]


def test_golden_encodes_exercise_the_64_level():
    """The smooth frame's encodes choose 64x64 leaves; the natural
    frame's PNN policies code PNN PUs."""
    g = golden()["encodes"]
    assert all(e["leaf64"] > 0 for k, e in g.items()
               if k.startswith("smooth64x128"))
    assert all(e["pnn_pus"] > 0 for k, e in g.items()
               if k.startswith("natural128") and e["policy"] != "regular")


# -------------------------------------------------------------- tables --

@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("h,w", [(64, 128), (128, 128), (128, 320)])
def test_ctb64_geometry_tables(h, w, n):
    np.testing.assert_array_equal(t_wavefront2._coding_order4(h, w, 64),
                                  j_wavefront2._coding_order4(h, w, 64))
    assert t_wavefront2._z_offsets(64, n) == j_wavefront2._z_offsets(64, n)
    for a, b in zip(t_wavefront2._fill_tables(h, w, n, 64),
                    j_wavefront2._fill_tables(h, w, n, 64)):
        assert_same(a, b, f"fill tables n={n}")
    for a, b in zip(t_wavefront2._nn_ctx_tables(h, w, n, 64),
                    j_wavefront2._nn_ctx_tables(h, w, n, 64)):
        assert_same(a, b, f"nn ctx tables n={n}")


@pytest.fixture(scope="module")
def ctb64_tables():
    """The JAX package's CTB-64 encoder built for 2 frames (128x192, QP 32,
    switch with the frozen singles zoo; built, not compiled) and the
    port's plan and device plan (CPU) for the same."""
    quantized = {w: j_pnn_q.load_quantized(os.path.join(
        FROZEN, f"qpnn_w{w}_single.npz")) for w in (4, 8, 16, 32)}
    j_bundle = j_nn_intra.PnnBundle(
        {}, {w: str(q["kind"]) == "fc" for w, q in quantized.items()},
        86.85680942771248, quantized=quantized)
    t_bundle = t_nn_intra.PnnBundle(dict(quantized), 86.85680942771248)
    run = j_wavefront2._build_wavefront2(
        128, 192, 32, 1.0, "switch", j_bundle, ctb=64, enable_nxn=True,
        n_frames=2, rate_evolve=False)
    step = closure_vars(run.__wrapped__)["step"]
    plan = t_wavefront2._build_wavefront2(128, 192, 32, policy="switch",
                                          bundle=t_bundle, ctb=64,
                                          n_frames=2)
    return closure_vars(step), plan, t_wavefront2._device_plan(plan, "cpu")


@pytest.mark.parametrize("name", ["NF", "b_eff", "b_max", "n_planes",
                                  "W_sk", "OFF", "OFF8", "PH", "WIN", "cu8",
                                  "sbx", "sby", "lam",
                                  "MODE_BITS", "SB", "n_modes", "ctb"])
def test_ctb64_plan_scalars(ctb64_tables, name):
    jax_vars, plan, _ = ctb64_tables
    assert_same(jax_vars[name], plan["n_frames" if name == "NF" else name],
                name)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_ctb64_size_consts(ctb64_tables, n):
    jax_vars, plan, _ = ctb64_tables
    want = dict(jax_vars["size_consts"][n])
    want.pop("fused", None)
    assert_same(want, plan["size_consts"][n], f"size_consts[{n}]")


def jax_slot_ids(jax_vars, t):
    nf, b_max, sbx = jax_vars["NF"], jax_vars["b_max"], jax_vars["sbx"]
    by0 = max(0, -((sbx - 1 - t) // 2))
    by_ids = by0 + np.repeat(np.arange(b_max), nf)
    return by_ids, t - 2 * by_ids, np.tile(np.arange(nf), b_max)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_ctb64_per_slot_tables(ctb64_tables, n):
    """The reference selection and PNN context tables of every step,
    z-order sub-stage of the 64 CTB and (slot, frame) equal what the JAX
    step gathers (`refs_for_b`, `nn_predict_b`)."""
    jax_vars, plan, dp = ctb64_tables
    c = jax_vars["size_consts"][n]
    h, w, ctb = 128, 192, 64
    un = ctb // n
    subs = t_wavefront2._z_offsets(ctb, n)
    assert dp["sel"][n].shape[1] == len(subs) == un * un
    for t in range(plan["n_steps"]):
        by_ids, bx_ids, _ = jax_slot_ids(jax_vars, t)
        for k, (ly, lx) in enumerate(subs):
            by_n = np.clip(by_ids * un + ly // n, 0, h // n - 1)
            bx_n = np.clip(bx_ids * un + lx // n, 0, w // n - 1)
            sel = c["onehot"][c["smap"][0, by_n, bx_n]].argmax(-1)
            np.testing.assert_array_equal(dp["sel"][n][t, k].numpy(), sel)
            cls = c["nn_cmap"][0, by_n, bx_n]
            nd = dp["nn"][n]
            np.testing.assert_array_equal(nd["ok"][t, k].numpy(),
                                          c["nn_ok_c"][cls])
            np.testing.assert_array_equal(nd["am"][t, k].numpy(),
                                          c["nn_am_c"][cls])
            np.testing.assert_array_equal(nd["lm"][t, k].numpy(),
                                          c["nn_lm_c"][cls])


@pytest.mark.parametrize("tz", [0, 1, 2, 3])
def test_ctb64_candidate_reference_tables(ctb64_tables, tz):
    """The 64 candidate's per-sample tables equal the JAX step's gathers
    (:1360-1377): the plane, row and window column of the committed
    reconstruction, the DC-128 fill, and the inside-the-CU patch index."""
    jax_vars, plan, dp = ctb64_tables
    c32 = jax_vars["size_consts"][32]
    h, w = 128, 192
    PH, W_sk, WIN = plan["PH"], plan["W_sk"], plan["WIN"]
    n_planes, NF = jax_vars["n_planes"], jax_vars["NF"]
    c = dp["c64"]
    for t in range(plan["n_steps"]):
        by_ids, bx_ids, f_ids = jax_slot_ids(jax_vars, t)
        by_32 = np.clip(by_ids * 2 + (tz >> 1), 0, h // 32 - 1)
        bx_32 = np.clip(bx_ids * 2 + (tz & 1), 0, w // 32 - 1)
        trip = c32["ctab"][c32["cmap"][0, by_32, bx_32]]
        dpl, lys, rxs = trip[:, 0], trip[:, 1], trip[:, 2]
        okd = dpl > -5
        plane = np.clip(by_ids[:, None] + 1 + dpl, 0, n_planes - 1) * NF \
            + f_ids[:, None]
        wxi = np.clip(rxs, 0, WIN - 1)
        iy = dpl * 64 + lys
        ix = rxs - jax_vars["OFF"] - 128 * dpl
        inside = okd & (iy >= 0) & (iy < 64) & (ix >= 0) & (ix < 64)
        np.testing.assert_array_equal(c["okd"][t, tz].numpy(), okd)
        np.testing.assert_array_equal(c["inside"][t, tz].numpy(), inside)
        np.testing.assert_array_equal(
            c["out_idx"][t, tz].numpy(),
            (plane * PH + lys) * W_sk + t * 64 + wxi)
        np.testing.assert_array_equal(
            c["in_idx"][t, tz].numpy(),
            np.clip(iy, 0, 63) * 64 + np.clip(ix, 0, 63))


# -------------------------------------------------------------- refused --

@pytest.mark.parametrize("kwargs,exc", [
    (dict(ctb=64, rate_evolve=True), NotImplementedError),
    (dict(ctb=16), ValueError)])
def test_refused_configs_raise_as_in_jax(kwargs, exc):
    with pytest.raises(exc):
        j_wavefront2._build_wavefront2(128, 128, 32, 1.0, "regular", None,
                                       **kwargs)
    with pytest.raises(exc):
        t_wavefront2._build_wavefront2(128, 128, 32, **kwargs)
    with pytest.raises(exc):
        t_wavefront2.encode_frame_wavefront2(
            np.zeros((128, 128), np.uint8), 32, device="cpu", **kwargs)
