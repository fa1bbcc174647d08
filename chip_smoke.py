"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's two paths at 1080p (1056x1920, QP 32, CTB 32, NxN, live
rate evolution, one frame) through the entry points a user calls: the
regular policy, and the `switch` policy (the PNN as a signalled 36th mode)
with the frozen singles zoo (`artifacts/frozen/qpnn_w{4,8,16,32}_single.npz`,
no pair models, mean 86.8568 of
`artifacts/training_set/luminance/means/mean_training.pkl` for every
width).  It holds each hand-written kernel against its plain PyTorch
version.  Phases, each printing one line with its seconds:

  0  the device (torch and nvidia-smi); no CUDA device -> exit 1
  1  builds, all started together: nvcc of each CUDA source (the unit
     trial, the PNN's integer merger) and g++ of the CABAC packer
  2  kernel vs plain on the card: the unit trial for n = 4, 8, 16, 32 (31
     slots, seeded random inputs with nonzero rate rows, and extreme
     residuals), also with a PNN prediction under `sub18` and `append`;
     the merger for M = 32, 64, 128, 256 maps (31 slots, random inputs
     and inputs at the PNN's caps): every output exactly equal
  3  the small reference frames (64x96 synthetic, 128x128 natural) through
     the kernel path, regular (tests/golden_torch/w2_rate_evolve.json) and
     NN policies (tests/golden_torch/w2_nn.json), against the digests
     captured from the JAX package
  4  the 1080p regular encode through the kernel path: device and pack
     seconds, PSNR, bits, and trial launches per unit size, which must
     equal the trial calls of the step loop
  5  the regular encode of the frame's 544x960 crop through the kernel and
     through the plain trial: reconstruction, grids and stream identical
     (about a quarter of the frame, to keep the smoke inside its time
     limit)
  6  the 1080p switch encode through the kernel path: the same numbers,
     PNNS-coded PUs, trial launches, and merger launches per map count,
     which must equal the PNN calls of the step loop
  7  the same switch encode through the plain trial and plain merger:
     identical to phase 6
  8  per kernel, on phase-4 and phase-6 inputs: launches, max abs error,
     ms per call (CUDA events, calls queued back to back), the kernels'
     own device time (profiler), plain ms, bound ms, and for the merger
     the time of a float64 `torch.bmm` of the same shapes (library ms);
     per PNN width, the whole forward of one sub-stage: ms per call and
     the device activities the profiler sees

The line before the last is the kernels JSON, the last line
{"ok": true, "device": {...}}.  Any failure exits nonzero.  It imports
nothing of JAX and starts no process other than the compilers and
nvidia-smi.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
QP = 32
H, W = 1056, 1920
CROP = (544, 960)       # the regular path's plain comparison (phase 5)
UNIT_SUBSTAGES = {4: 64, 8: 16, 16: 4, 32: 1}     # trials per step per n
REPLACES = {
    4: "context_adaptive_neural_network_based_prediction_tpu/ops/"
       "unit_fused.py:785",
    8: "context_adaptive_neural_network_based_prediction_tpu/ops/"
       "unit_fused.py:785",
    16: "context_adaptive_neural_network_based_prediction_tpu/ops/"
        "unit_fused.py:870",
    32: "context_adaptive_neural_network_based_prediction_tpu/ops/"
        "unit_fused.py:870",
}
SOURCE = ("context_adaptive_neural_network_based_prediction_tpu_torch/ops/"
          "csrc/unit_trial.cu")
MERGER_SOURCE = ("context_adaptive_neural_network_based_prediction_tpu_torch/"
                 "ops/csrc/merger_int.cu")
MERGER_REPLACES = ("context_adaptive_neural_network_based_prediction_tpu/ops/"
                   "pallas/merger_int.py:63")
NN_MAPS = {4: 32, 8: 64, 16: 128, 32: 256}      # merger maps per PNN width
MANIFEST = os.path.join(REPO, "artifacts", "frozen", "manifest_quantized.txt")
MEAN_PKL = os.path.join(REPO, "artifacts", "training_set", "luminance",
                        "means", "mean_training.pkl")
# H100 SXM peaks (NVIDIA's data sheet): HBM 3.35 TB/s; 67 T/s for float32
# outside the tensor cores.  The int32 rate is read from the card (SM count
# and max SM clock, 64 int32 lanes per SM, a multiply-add counted as two).
HBM_BPS = 3.35e12
F32_OPS = 67e12
GRID_NAMES = ("m8", "q8", "s8", "m4", "q4", "m16", "q16", "s16", "m32",
              "q32", "s32")


def say(msg):
    print(msg, flush=True)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            say(f"[{self.name}] done in {time.perf_counter() - self.t0:.2f} s")


def bench_frame(h=H, w=W):
    """The 1080p benchmark frame: the JAX package's bench.py fallback
    generator (its ParkScene PNG is not in the repository)."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    f = (120 + 50 * np.sin(xx / 17.0) + 35 * np.cos(yy / 23.0)
         + rng.normal(0, 5, (h, w)))
    return np.clip(f, 0, 255).astype(np.uint8)


def golden_frames():
    """The two frames of tests/golden_torch/w2_rate_evolve.json."""
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:64, 0:96]
    synth = np.clip(128 + 45 * np.sin(xx / 11.0) + 35 * np.cos(yy / 8.0)
                    + rng.normal(0, 7, (64, 96)), 0, 255).astype(np.uint8)
    natural = np.load(os.path.join(REPO, "tests", "golden_hm",
                                   "128_full_q32_src.npy"))
    return {"synth64x96": synth, "natural128": natural}


def sha(a):
    if isinstance(a, (bytes, bytearray)):
        return hashlib.sha256(bytes(a)).hexdigest()
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def nn_bundles():
    """The random test bundle of w2_nn.json and the frozen singles zoo at
    the wavefront's widths (mean of `MEAN_PKL` for every width)."""
    from context_adaptive_neural_network_based_prediction_tpu_torch.models \
        import zoo

    with open(MEAN_PKL, "rb") as f:
        mean = float(pickle.load(f))
    return {
        "random": zoo.load_bundle_npz(os.path.join(
            REPO, "tests", "golden_torch", "w2_nn_random_bundle.npz")),
        "frozen_singles": zoo.load_quantized_bundle(
            MANIFEST, mean, use_pair=False, widths=(4, 8, 16, 32))}


def digest_items(recon, grids, stream):
    out = {"recon": sha(recon), "stream": sha(stream)}
    out.update({k: sha(np.asarray(g, np.int32))
                for k, g in zip(GRID_NAMES, grids)})
    return out


def pnn_pus(trees, policy, nn_widths):
    """PUs coded with the PNN mode (35 under switch, 18 at a model's width
    under substitution)."""
    count, stack = 0, list(trees)
    while stack:
        node = stack.pop()
        stack.extend(node.children)
        count += sum(1 for pu in node.pus
                     if (policy == "switch" and pu.mode == 35)
                     or (policy == "substitution" and pu.mode == 18
                         and pu.n in nn_widths))
    return count


def merger_inputs(rng, m, n, extreme=False):
    """Merger inputs (numpy): x (N, 80, M) int16, w (80, 16, M) int16, b
    (16, M) int32; random within the PNN's caps (activations 2047,
    weights 511, biases 2^30), or every product at the cap, one sign per
    slot (the largest sums)."""
    if extreme:
        sign = np.where(np.arange(n) % 2, -1, 1)[:, None, None]
        x = np.broadcast_to(2047 * sign, (n, 80, m))
        w = np.full((80, 16, m), 511)
        b = np.broadcast_to(np.where(np.arange(16)[:, None] % 2, -(1 << 30),
                                     1 << 30), (16, m))
    else:
        x = rng.integers(-2047, 2048, (n, 80, m))
        w = rng.integers(-511, 512, (80, 16, m))
        b = rng.integers(-(1 << 30), 1 << 30, (16, m))
    return [np.ascontiguousarray(a, dtype=t) for a, t in
            ((x, np.int16), (w, np.int16), (b, np.int32))]


def trial_inputs(rng, n, b, n_modes=35, extreme=False):
    """Seeded unit-trial inputs (as numpy): random content near a base
    level, or worst-case residuals; rate rows nonzero."""
    if extreme:
        rt = np.zeros((b, 2 * n + 1), np.int32)
        rl = np.zeros((b, 2 * n + 1), np.int32)
        og = np.zeros((b, n, n), np.int32)
        yy, xx = np.mgrid[0:n, 0:n]
        for i in range(b):
            kind = i % 4
            if kind == 0:
                og[i] = 255
            elif kind == 1:
                og[i] = 255 * ((yy + xx) % 2)
            elif kind == 2:
                og[i] = 255 * (xx % 2)
            else:
                rt[i], rl[i] = 255, 255
    else:
        base = rng.integers(0, 256, (b, 1))
        rt = np.clip(base + rng.integers(-60, 60, (b, 2 * n + 1)), 0, 255)
        rl = np.clip(base + rng.integers(-60, 60, (b, 2 * n + 1)), 0, 255)
        rl[:, 0] = rt[:, 0]
        og = np.clip(base[:, :, None] + rng.integers(-70, 70, (b, n, n)),
                     0, 255)
    mb = rng.uniform(1.0, 6.0, (b, n_modes)).astype(np.float32)
    rr = rng.integers(-400, 400, (8, b)).astype(np.int32)
    return [np.ascontiguousarray(x).astype(t) for x, t in
            ((rt, np.int32), (rl, np.int32), (og, np.int32),
             (mb, np.float32), (rr, np.int32))]


def max_abs_err(a, b):
    err = 0.0
    for x, y in zip(a, b):
        d = (x.double() - y.double()).abs().max().item() if x.numel() else 0
        err = max(err, d)
    return err


def assert_equal(a, b, what, names=("cost", "best", "rec", "q", "counts")):
    import torch

    if isinstance(a, torch.Tensor):
        a, b, names = (a,), (b,), ("out",)
    for name, x, y in zip(names, a, b):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            bad = (x != y).nonzero()[:4].tolist()
            raise AssertionError(f"{what}: {name} differs at {bad}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this smoke run needs one NVIDIA card",
              file=sys.stderr)
        return 1

    from context_adaptive_neural_network_based_prediction_tpu_torch import (
        _build_dir)
    from context_adaptive_neural_network_based_prediction_tpu_torch.codec \
        import native
    from context_adaptive_neural_network_based_prediction_tpu_torch.ops \
        import _cuda_build, merger_int, transform, unit_fused
    from context_adaptive_neural_network_based_prediction_tpu_torch.parallel \
        import wavefront2

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    # ---- phase 0: the device ----
    with Phase("0 device"):
        kind = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
        int_ops = card_int32_rate()
        say(f"device: {kind}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}; count {torch.cuda.device_count()}")
        say(f"nvidia-smi: {smi}; int32 rate {int_ops / 1e12:.2f} T/s")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: builds, all started together ----
    with Phase("1 build"):
        errors = []

        def run(fn):
            try:
                fn()
            except Exception as e:  # reported and re-raised below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(f,))
                   for f in (_cuda_build.load, native.load_library)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        for name in _cuda_build.NAMES + ("cabac_pack",):
            sec = _build_dir.seconds.get(name)
            say(f"build {name}: "
                + (f"{sec:.2f} s" if sec is not None else "cached"))

    # ---- phase 2: kernels vs plain ----
    with Phase("2 kernel vs plain"):
        t0 = time.perf_counter()
        plan, dp = wavefront2._get_plan(H, W, QP, 1.0, 32, True, True, dev)
        say(f"1080p plan and tables: {time.perf_counter() - t0:.2f} s")
        b = plan["b_eff"]
        rng = np.random.default_rng(2024)
        for n in (4, 8, 16, 32):
            tc = dp["trial"][n]
            for extreme in (False, True):
                args = [torch.from_numpy(x).to(dev)
                        for x in trial_inputs(rng, n, b, extreme=extreme)]
                got = unit_fused.trial_apply(tc, *args, impl="kernel")
                want = unit_fused.trial_apply(tc, *args, impl="plain")
                torch.cuda.synchronize()
                assert_equal(got, want, f"n={n} extreme={extreme}")
            say(f"n={n}: kernel == plain on {b} slots (random, extreme)")
        for policy in ("sub18", "append"):
            n_modes = 36 if policy == "append" else 35
            for n in (4, 8, 16, 32):
                c = wavefront2._unit_consts(n, QP, n_modes)
                tc = unit_fused.consts_from_numpy(unit_fused.build_consts(
                    n, n_modes, c, plan["SB"], plan["lam"],
                    transform.QUANT_SCALES[QP % 6],
                    transform.INV_QUANT_SCALES[QP % 6], b, nn_policy=policy,
                    groups={4: 1, 8: 1, 16: 6, 32: 36}[n]), device=dev)
                for extreme in (False, True):
                    rt, rl, og, mb, rr = trial_inputs(
                        rng, n, b, n_modes=n_modes, extreme=extreme)
                    nnp = np.clip(og + rng.integers(-3, 4, og.shape), 0, 255)
                    args = [torch.from_numpy(x).to(dev)
                            for x in (rt, rl, og, mb, rr)]
                    nn_pred = torch.from_numpy(nnp.astype(np.int32)).to(dev)
                    got = unit_fused.trial_apply(tc, *args, nn_pred=nn_pred)
                    want = unit_fused.trial_apply(tc, *args, impl="plain",
                                                  nn_pred=nn_pred)
                    torch.cuda.synchronize()
                    assert_equal(got, want, f"{policy} n={n} "
                                 f"extreme={extreme}")
            say(f"nn_policy {policy}: kernel == plain with a PNN prediction,"
                f" n = 4..32, {b} slots (random, extreme)")
        for m in NN_MAPS.values():
            for extreme in (False, True):
                x, w, bb = [torch.from_numpy(a).to(dev) for a in
                            merger_inputs(rng, m, b, extreme=extreme)]
                got = merger_int.merger_int_forward(x, w, bb)
                want = merger_int.merger_int_forward(x, w, bb, impl="plain")
                torch.cuda.synchronize()
                assert_equal(got, want, f"merger M={m} extreme={extreme}")
            say(f"merger M={m}: kernel == plain on {b} slots (random, caps)")

    # ---- phase 3: small frames against the JAX package's digests ----
    bundles = nn_bundles()
    with Phase("3 reference digests"):
        with open(os.path.join(REPO, "tests", "golden_torch",
                               "w2_rate_evolve.json")) as f:
            golden = json.load(f)
        frames = golden_frames()
        for name, frame in frames.items():
            recon, grids = wavefront2.encode_arrays_wavefront2(
                frame, QP, rate_evolve=True, device=dev)
            res = wavefront2._arrays_to_result(
                frame, QP, (recon,) + grids, "regular", True)
            want = golden["frames"][name]
            got = digest_items(recon, grids, res.bitstream)
            bad = [k for k in got if got[k] != want[k]]
            if bad:
                raise AssertionError(f"{name}: differs from the JAX "
                                     f"package's digests in {bad}")
            say(f"{name}: recon, 11 grids and stream match the JAX "
                f"package's digests ({len(res.bitstream)} bytes)")
        with open(os.path.join(REPO, "tests", "golden_torch",
                               "w2_nn.json")) as f:
            golden_nn = json.load(f)
        for key, want in golden_nn["encodes"].items():
            frame = frames[want["frame"]]
            bundle = bundles[want["bundle"]]
            merger_int.reset_launch_counts()
            recon, grids = wavefront2.encode_arrays_wavefront2(
                frame, want["qp"], policy=want["policy"], pnn=bundle,
                rate_evolve=want["rate_evolve"], device=dev)
            res = wavefront2._arrays_to_result(
                frame, want["qp"], (recon,) + grids, want["policy"], True)
            got = digest_items(recon, grids, res.bitstream)
            got["pnn_pus"] = pnn_pus(res.ctu_trees, want["policy"],
                                     list(bundle.quantized))
            bad = [k for k in got if got[k] != want[k]]
            if bad or not merger_int.launches:
                raise AssertionError(f"{key}: differs from the JAX "
                                     f"package's digests in {bad} (merger "
                                     f"launches {merger_int.launches})")
            say(f"{key} (QP {want['qp']}): recon, 11 grids and stream match "
                f"the JAX package's digests ({len(res.bitstream)} bytes, "
                f"{got['pnn_pus']} PNN-coded PUs)")

    # ---- phases 4-7: the 1080p paths ----
    frame = bench_frame()
    captured = {}
    orig_trial, orig_merger = unit_fused._kernel_trial, merger_int._kernel

    def capture_trial(tc, *args):    # one phase-4 input set per n
        # (ref_top, ref_left, orig, mode_bits, rate_rows); the regular
        # path passes no PNN prediction.
        if tc["n"] not in captured and args[5] is None:
            captured[tc["n"]] = (tc, [a.clone() for a in args[:5]])
        return orig_trial(tc, *args)

    def capture_merger(x, w, bb):     # one phase-6 input set per M
        key = ("merger", x.shape[2])
        if key not in captured:
            captured[key] = [a.clone() for a in (x, w, bb)]
        return orig_merger(x, w, bb)

    from context_adaptive_neural_network_based_prediction_tpu_torch.models \
        import pnn_q
    orig_predict = pnn_q.predict_pixels_q

    def capture_predict(q, inp, n, fc, mean, impl="kernel"):
        key = ("pnn", n)              # one phase-6 PNN input set per width
        if key not in captured:
            captured[key] = (q, [a.clone() for a in inp] if isinstance(
                inp, tuple) else inp.clone(), fc, mean)
        return orig_predict(q, inp, n, fc, mean, impl=impl)

    n_steps = plan["n_steps"]
    want_trials = {n: n_steps * k for n, k in UNIT_SUBSTAGES.items()}
    want_mergers = {NN_MAPS[n]: n_steps * k
                    for n, k in UNIT_SUBSTAGES.items()}
    frozen = bundles["frozen_singles"]

    def encode(frame, policy, impl, capture=None):
        """One encode, its counts read around the device half."""
        pnn = frozen if policy != "regular" else None
        h, w = frame.shape
        # The plan (host tables, constants and models on the card) is
        # built once per configuration, outside the timed device half.
        t0 = time.perf_counter()
        wavefront2._get_plan(h, w, QP, 1.0, 32, True, True, dev,
                             policy=policy, bundle=pnn)
        say(f"{h}x{w} {policy} plan: {time.perf_counter() - t0:.2f} s")
        torch.cuda.synchronize()
        unit_fused.reset_launch_counts()
        merger_int.reset_launch_counts()
        if capture:
            unit_fused._kernel_trial = capture_trial
            merger_int._kernel = capture_merger
            pnn_q.predict_pixels_q = capture_predict
        t0 = time.perf_counter()
        try:
            recon, grids = wavefront2.encode_arrays_wavefront2(
                frame, QP, policy=policy, pnn=pnn, rate_evolve=True,
                device=dev, impl=impl)
            torch.cuda.synchronize()
        finally:
            unit_fused._kernel_trial = orig_trial
            merger_int._kernel = orig_merger
            pnn_q.predict_pixels_q = orig_predict
        t_dev = time.perf_counter() - t0
        counts = (dict(unit_fused.launches), dict(merger_int.launches))
        t0 = time.perf_counter()
        res = wavefront2._arrays_to_result(frame, QP, (recon,) + grids,
                                           policy, True)
        t_pack = time.perf_counter() - t0
        mse = np.mean((recon.astype(np.float64) - frame) ** 2)
        psnr = 10 * np.log10(255.0 ** 2 / mse)
        if recon.shape != (h, w) or not 20.0 < psnr < 60.0:
            raise AssertionError(f"implausible output: {recon.shape}, "
                                 f"PSNR {psnr}")
        return recon, grids, res, t_dev, t_pack, psnr, counts

    def assert_same_encode(a, c, what):
        if not np.array_equal(a[0], c[0]):
            raise AssertionError(f"{what} reconstruction: kernel != plain")
        for name, x, y in zip(GRID_NAMES, a[1], c[1]):
            if not np.array_equal(x, y):
                raise AssertionError(f"{what} grid {name}: kernel != plain")
        if a[2].bitstream != c[2].bitstream:
            raise AssertionError(f"{what} stream: kernel != plain")

    with Phase("4 1080p kernel"):
        reg_k = encode(frame, "regular", "kernel", capture=True)
        _, _, res_k, t_dev, t_pack, psnr, (launches, _) = reg_k
        say(f"1080p kernel path: device half {t_dev:.3f} s, pack "
            f"{t_pack:.3f} s, PSNR {psnr:.4f} dB, {res_k.num_bits} bits, "
            f"launches {launches} (step loop trial calls {want_trials})")
        if launches != want_trials:
            raise AssertionError("kernel launches != trial calls")

    # The regular path's plain comparison runs on the frame's top-left
    # 544x960 crop (17 x 30 CTBs, about a quarter of the 1080p frame; 528
    # rows are not whole CTBs), to keep the smoke inside its time limit;
    # the switch path's runs at 1080p.
    with Phase("5 544x960 plain"):
        crop = np.ascontiguousarray(frame[:CROP[0], :CROP[1]])
        crop_k = encode(crop, "regular", "kernel")
        crop_p = encode(crop, "regular", "plain")
        assert_same_encode(crop_k, crop_p, "544x960")
        if crop_p[6][0] != {4: 0, 8: 0, 16: 0, 32: 0}:
            raise AssertionError("the plain path launched the trial kernel")
        say(f"544x960 regular: kernel path device half {crop_k[3]:.3f} s, "
            f"plain path {crop_p[3]:.3f} s; recon, 11 grids and stream "
            f"identical")

    with Phase("6 1080p switch kernel"):
        sw_k = encode(frame, "switch", "kernel", capture=True)
        _, _, res_s, t_dev_s, t_pack_s, psnr_s, (sw_trials, sw_mergers) = sw_k
        pus = pnn_pus(res_s.ctu_trees, "switch", list(frozen.quantized))
        say(f"1080p switch kernel path: device half {t_dev_s:.3f} s, pack "
            f"{t_pack_s:.3f} s, PSNR {psnr_s:.4f} dB, {res_s.num_bits} bits, "
            f"{pus} PNNS-coded PUs, trial launches {sw_trials}, merger "
            f"launches {sw_mergers} (step loop PNN calls {want_mergers})")
        if sw_trials != want_trials:
            raise AssertionError("switch: trial launches != trial calls")
        if sw_mergers != want_mergers:
            raise AssertionError("switch: merger launches != PNN calls")

    with Phase("7 1080p switch plain"):
        sw_p = encode(frame, "switch", "plain")
        assert_same_encode(sw_k, sw_p, "1080p switch")
        if sw_p[6][1] or sw_p[6][0] != {4: 0, 8: 0, 16: 0, 32: 0}:
            raise AssertionError("the plain path launched a kernel")
        say(f"1080p switch plain path: device half {sw_p[3]:.3f} s; recon, "
            f"11 grids and stream identical to the kernel path")

    # ---- phase 8: per-kernel numbers at the main paths' shapes ----
    with Phase("8 kernel timing"):
        rows = []
        for n in (4, 8, 16, 32):
            tc, args = captured[n]
            call = lambda impl: unit_fused.trial_apply(tc, *args, impl=impl)
            got, want = call("kernel"), call("plain")
            assert_equal(got, want, f"phase-4 inputs n={n}")
            bound_ms, bound_by = trial_bound_ms(tc, args, int_ops)
            rows.append(kernel_row(
                f"unit_trial_n{n}", SOURCE, REPLACES[n], launches[n],
                max_abs_err(got, want), lambda: call("kernel"),
                lambda: call("plain"), bound_ms, bound_by, None,
                ("trial_modes_kernel", "select_kernel")))
        for n, m in NN_MAPS.items():
            x, w, bb = captured[("merger", m)]
            call = lambda impl: merger_int.merger_int_forward(x, w, bb,
                                                              impl=impl)
            got, want = call("kernel"), call("plain")
            assert_equal(got, want, f"phase-6 inputs M={m}")
            xm = x.permute(2, 0, 1).to(torch.float64).contiguous()
            wm = w.permute(2, 0, 1).to(torch.float64).contiguous()
            lib = torch.bmm(xm, wm) + bb.T.to(torch.float64)[:, None, :]
            if not torch.equal(lib.to(torch.int32), want):
                raise AssertionError(f"fp64 bmm != merger at M={m}")
            library_ms = time_launches(lambda: torch.bmm(xm, wm))
            bound_ms, bound_by = merger_bound_ms(x, w, bb, int_ops)
            rows.append(kernel_row(
                f"merger_int_m{m}", MERGER_SOURCE, MERGER_REPLACES,
                sw_mergers[m], max_abs_err([got], [want]),
                lambda: call("kernel"), lambda: call("plain"), bound_ms,
                bound_by, library_ms, ("merger_int_kernel",)))
        for r in rows:
            say(f"{r['name']}: {r['launches']} launches, {r['ms']:.4f} ms "
                f"per call (kernels on the card {r['device_ms']} ms; plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms by "
                f"{r['bound_by']}, library {r['library_ms']} ms) on {smi}")
        for n in (4, 8, 16, 32):
            # The whole PNN forward of one sub-stage (31 slots), on its
            # phase-6 inputs: host-inclusive ms per call and what the
            # profiler sees on the card.
            q, inp, fc, mean = captured[("pnn", n)]
            inp = tuple(inp) if isinstance(inp, list) else inp
            fwd = lambda: pnn_q.predict_pixels_q(q, inp, n, fc, mean)
            ms = time_launches(fwd, reps=20)
            n_dev, dev_ms = device_activity(fwd)
            say(f"PNN forward w{n} ({'fc' if fc else 'conv'}): {ms:.4f} ms "
                f"per call, {n_dev} device activities per call taking "
                f"{dev_ms} ms on the card; x {want_mergers[NN_MAPS[n]]} "
                f"calls = {ms * want_mergers[NN_MAPS[n]] / 1e3:.3f} s of "
                f"the switch path")
        if all(r["device_ms"] is not None for r in rows):
            busy_t = sum(r["device_ms"] * r["launches"] for r in rows[:4])
            busy_m = sum(r["device_ms"] * r["launches"] for r in rows[4:])
            sw_t = sum(r["device_ms"] * sw_trials[n]
                       for r, n in zip(rows[:4], (4, 8, 16, 32)))
            say(f"1080p kernel path: trial kernels busy {busy_t / 1e3:.3f} s "
                f"of the {t_dev:.3f} s device half "
                f"({busy_t / 10 / t_dev:.1f}%)")
            say(f"1080p switch kernel path: trial kernels busy "
                f"{sw_t / 1e3:.3f} s, merger kernels {busy_m / 1e3:.3f} s of "
                f"the {t_dev_s:.3f} s device half "
                f"({(sw_t + busy_m) / 10 / t_dev_s:.1f}%)")
    say(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
    say(json.dumps({"kernels": rows}))
    say(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def kernel_row(name, source, replaces, launches, err, fn, plain_fn,
               bound_ms, bound_by, library_ms, device_keys):
    """One entry of the kernels JSON, timed on the card."""
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=err, ms=time_launches(fn),
        plain_ms=time_launches(plain_fn, reps=10), bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
        device_ms=kernel_device_ms(fn, device_keys))


def time_launches(fn, reps=50, warm=3):
    """Median ms of one call, each timed with its own CUDA events, the
    calls queued back to back."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, z in ev:
        a.record()
        fn()
        z.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(z) for a, z in ev]))


def kernel_device_ms(fn, keys, reps=20):
    """Device time per call of the kernels whose names contain one of
    `keys`, from the profiler's CUDA activity (None if the profiler
    records no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if any(k in e.key for k in keys):
            us += getattr(e, "device_time_total",
                          getattr(e, "cuda_time_total", 0.0))
    return us / reps / 1e3 if us > 0 else None


def device_activity(fn, reps=5):
    """(device activities (kernels, copies, sets) per call, their device
    ms per call) from the profiler's CUDA events; (None, None) if it
    records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.events()
           if getattr(e, "device_type", None) == cuda]
    if not evs:
        return None, None
    us = sum(e.time_range.elapsed_us() for e in evs)
    return len(evs) / reps, us / reps / 1e3


def card_int32_rate():
    """int32 operations per second of card 0: 64 int32 lanes per SM, a
    multiply-add counted as two, at the card's max SM clock
    (`nvidia-smi --query-gpu=clocks.max.sm`)."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    return 2 * 64 * sms * float(mhz) * 1e6


def trial_bound_ms(tc, args, int_ops):
    """The least time the card could take for one trial call: the larger
    of (bytes of inputs and tables read once + outputs written once) over
    the HBM rate, and the operations' time.  Operations per (slot, mode):
    the four integer transform passes, 2 n^3 multiply-adds each counted as
    two, at the card's int32 rate; about 72 per pixel for prediction,
    RDOQ, rate, sign hiding and reconstruction at the float32 rate.  The
    two kinds issue to separate units, so the larger time bounds."""
    n, nn = tc["n"], tc["nn"]
    b = args[0].shape[0]
    n_modes = tc["n_modes"]
    read = sum(a.numel() * a.element_size() for a in args)
    read += sum(tc[k].numel() * tc[k].element_size() for k in tc
                if k.startswith("k_"))
    written = b * 4 * 2 + b * nn * 4 * 2 + b * 8 * 4
    t_bytes = (read + written) / HBM_BPS
    t_ops = max(b * n_modes * 4 * 2 * n ** 3 / int_ops,
                b * n_modes * 72 * nn / F32_OPS)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def merger_bound_ms(x, w, b, int_ops):
    """The least time of one merger call: x, w, b read once and the (M, N,
    O) int32 output written once over the HBM rate, against N*P*O*M
    multiply-adds (two operations each) at the card's int32 rate."""
    n, p, m = x.shape
    o = w.shape[1]
    moved = sum(t.numel() * t.element_size() for t in (x, w, b)) \
        + m * n * o * 4
    t_bytes = moved / HBM_BPS
    t_ops = 2 * n * p * o * m / int_ops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


if __name__ == "__main__":
    sys.exit(main())
