"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's encode paths at 1080p (1056x1920, QP 32, CTB 32, NxN,
live rate evolution) through the entry points a user calls: the regular
policy, and the `switch` policy (the PNN as a signalled 36th mode) with
the frozen singles zoo (`artifacts/frozen/qpnn_w{4,8,16,32}_single.npz`,
no pair models, mean 86.8568 of
`artifacts/training_set/luminance/means/mean_training.pkl` for every
width), one frame per call and four (frame batching), the streaming
encoder, and the port's decoder on those streams; the CTB-64 encoder (HM's
intra_main_rext geometry) on the frame's top 1024 rows, and the Annex-B
output with deblocking and SAO (`encode_frame_wavefront2_hm`) at CTB 64
and 32, each stream decoded by stock HM-16.15; and the float PNN
prediction path (Tables I-V,
`evaluation/prediction_comparison.compare_on_channels`) on the 1080p
frame's luma with the six float singles of the chip copy; and the host
RDO codec behind the rate-distortion results (`FrameEncoder`, its Annex-B
output in luma and 4:2:0, the HM-syntax decoder, `compute_rate_psnr`)
with the whole w4-w64 quantized zoo and the float fallback; PNN
training (`models/training.py`) with checkpoint and resume, its trained
models frozen, served, quantized and encoded with; and the multi-rank
paths (tiled encoders, sharded training) on 2 ranks sharing the card.  It holds each
hand-written kernel against its plain PyTorch version.  Phases, each
printing one line with its seconds:

  0  the device (torch and nvidia-smi); no CUDA device -> exit 1
  1  builds, all started together: nvcc of each CUDA source (the unit
     trial, the PNN's integer merger, the float FC layer, the float
     merger) and g++ of the CABAC packer; registers and spills per kernel;
     the tensor-core instructions (HGMMA, HMMA) in the FC library's SASS
     (`cuobjdump -sass`, where the toolkit has it: none is a failure); the
     time and bytes of the FC weights' preparation (transposed hi/lo TF32
     split of the w8 chain)
  2  kernel vs plain on the card: the unit trial for n = 4, 8, 16, 32 (31
     slots, seeded random inputs with nonzero rate rows, and extreme
     residuals; n = 4 and 8 also at 1 slot), also with a PNN prediction
     under `sub18` and `append` (31 slots and 1); the merger for M = 32,
     64, 128, 256 maps (1, 17 and 31 slots, random inputs and inputs at
     the PNN's caps), and M = 512 (the w64 models; 1 and 31 slots):
     every output exactly equal.  The float
     FC chain at w = 4, 8, float32 and bfloat16 weights, N = 1, 7, 127,
     128, 129, 200, 256, 1024, 2048 (the tiling's and K splits' edges; max
     error <= 1e-4 of max |plain|); the float merger at M = 32 ... 512,
     N = 1, 31, 33, 256, 1024, 2048, with and without the activation
     (<= 1e-5); both float kernels give the same bits for the same inputs
  3  the small reference frames (64x96 synthetic, 128x128 natural) through
     the kernel path, regular (tests/golden_torch/w2_rate_evolve.json) and
     NN policies (tests/golden_torch/w2_nn.json), against the digests
     captured from the JAX package; and at CTB 64 (rate evolution off) the
     smooth 64x128 and the natural 128x128 frame under regular, switch and
     substitution, one frame a call (tests/golden_torch/w2_ctb64.json);
     the batched transforms and quantiser on the card against their numpy
     twins (n = 4 ... 32 and the DST, 16-bit blocks with the extremes and
     the 9-bit chain, QP 22 and 37), and `predict_via_hevc_mode` against
     `predict_one_mode_np`
  4  the 1080p regular encode through the kernel path: device and pack
     seconds, PSNR, bits, and trial launches per unit size, which must
     equal the trial calls of the step loop
  5  the regular encode of the frame's 288x960 crop through the kernel and
     through the plain trial: reconstruction, grids and stream identical
     (about a quarter of the frame, to keep the smoke inside its time
     limit)
  6  the 1080p switch encode through the kernel path: the same numbers,
     PNNS-coded PUs, trial launches, and merger launches per map count,
     which must equal the PNN calls of the step loop
  7  the switch encode of the 288x960 crop through the kernel path and
     through the plain trial and plain merger: identical (the crop keeps
     the smoke inside its time limit on slow hosts; phase 6 holds the
     1080p kernel path's launches)
 10  the 1080p regular encode of four distinct frames (the frame, its
     left-right and up-down flips, a 64-column roll) as one batch of 4:
     each frame identical to its own b = 1 kernel-path encode; the device
     half per frame against phase 4's, trial launches equal to the step
     loop's calls
 11  the 1080p switch encode of [frame, flip, flip, frame] as one batch:
     frames 0 and 3 identical to phase 6, frames 1 and 2 to each other;
     device half per frame, trial and merger launches
 12  `encode_stream_wavefront2` over 9 regular 1080p frames at batch 4
     (two full batches and one padded): each stream and reconstruction
     identical to its frame's b = 1 encode; end-to-end frames/s, with the
     stream's own device halves and packs timed inside the run, beside
     phase 10's device half plus pack
 13  the port's decoder on the card: the phase-4 regular, phase-6 switch
     and phase-11 frame-1 switch streams back to the encoder's
     reconstruction; seconds, and merger launches, which must equal the
     decoder's PNN forwards of conv models
 14  `encode_frame_wavefront2(ctb=64)`, regular, on the frame's top
     1024x1920 (16 x 30 CTBs, 60 steps, 16 slots), QP 32, rate evolution
     off: device and pack seconds, PSNR, bits, the 64x64 candidate's time
     per step (host, and CUDA events around it), trial launches per unit
     size, which must equal the step loop's calls (60 steps x 4
     quadrants); the port's decoder gives the reconstruction back from
     the stream
 15  `encode_frame_wavefront2_hm`, regular, loop filters on, at CTB 64 on
     the same 1024x1920 frame and at CTB 32 on phase 5's 288x960 crop
     with rate evolution on (phase 4's configuration; the mode map must be
     phase 5's): device, deblock, SAO-estimate, SAO-apply and HM-serialise
     seconds; stock HM (`artifacts/hm_bin/TAppDecoderStatic -b ... -o
     ...`) decodes each stream, confirms its picture hash ("(OK)") and
     writes the port's reconstruction
 16  the v1 wavefront encoder (`parallel/wavefront.py`, the uniform
     16x16 grid; on the card one launch of the v1 step kernel a step,
     `ops/csrc/v1_step.cu`, exactly as many launches as steps and none
     of another kernel): the JAX package's v1 test frames at block sizes
     8, 16 and 32 against tests/golden_torch/w1.json; the 1080p frame at
     QP 32 as one frame and as phase 10's batch of 4 (recon, modes,
     levels and stream against w1.json; device-half and host-half seconds
     a frame); the kernel's middle step at b = 1 and b = 64 (the four
     frames repeated; 61 and 3904 slots): aten ops, ms between CUDA
     events as the host issues it and queued behind a spin of the card,
     against its int32 bound and the plain step queued, and the b = 64
     device half (frame 4 equal to its b = 4 encode); the port's decoder on
     the stream; `encode_frame_wavefront_hm` (Annex-B, CTB 16, deblocking
     and SAO) against w1.json, decoded by stock HM ("(OK)", equal luma)
 17  the quantize path: `quantize_pnn` of the six float singles (default
     synthetic calibration, 256 samples, its float forward on the card
     through the FC and float merger kernels, whose launches are counted
     per model) against tests/golden_torch/quantize.* (weights and caps
     equal, scales within 1e-4 relative, biases within 1 + 1e-4 |bias|),
     every FC layer and float merger call of those runs against its plain
     version on the same inputs (FC <= 1e-4, merger <= 1e-5 of max
     |plain|), seconds per model; then a switch encode of the 128x128 natural frame
     with the port-quantized w4 / w8 refconv, w16 and w32 singles (trial
     and integer merger launches counted), decoded back by the port's
     decoder; the six quantized models written by `save_quantized` and
     read back by `load_quantized`, every array equal
  9  (runs before 8) the float prediction path on the card, per float
     single (w4/w8 FC, w4/w8 refconv, w16, w32): the forward on the
     natural frame's seeded contexts and the bf16 kernels against the JAX
     package's goldens (tests/golden_torch/float_pnn.*; masked contexts
     equal, forward <= 1e-4 of max |JAX|, FC <= 1e-4, merger <= 1e-5), its
     `compare_on_channels` rows (within 0.01 dB, win frequency within
     2/N); then `compare_on_channels` on the 1080p luma with 2048
     positions and the four default masks: PSNR rows, seconds, and
     kernel launches, which must equal the forwards' chunk calls
 18  (runs before 8) the host RDO codec (`codec/encoder.FrameEncoder`,
     HM-style RDO with RDOQ, CTB 64, deblocking and SAO, host numpy; the
     PNN forwards on the card one PU at a time): `encode_frame_hm` of the
     natural 128x128 and the 96x160 frame of tests/golden_hm, regular,
     switch and substitution with the whole quantized zoo (w4-w64, singles
     at QP 27, pairs at QP 37), against tests/golden_torch/host_codec.json
     (stream, reconstruction, mode map), each decoded back by the port's
     decoder, with seconds, PNN forwards, ms per forward, integer merger
     launches (== conv forwards, M = 512 for w64) and the share of the
     wall spent inside forwards (host time: context upload, forward,
     read-back); the Annex-B streams of `encode_frame_hm` (regular,
     switch) and `encode_frame_hm_420` (regular, the stored chroma planes)
     against the digests, given back by the port's `decode_hm_stream`
     (native parser) and the regular ones by stock HM ("(OK)", equal
     planes); the port's `decode_hm_stream` on every stock-HM stream of
     tests/golden_hm; the RD sweep over QP 22-37 for regular and switch
     (Annex-B rate): `compute_rate_psnr` at QP 22, the other points from
     the Annex-B streams above, decoded by `decode_hm_stream`, and
     `bd_rate_low_high_full`, equal to the captured numbers; and the float
     fallback (the float models of manifest_trained.txt only, widths 4-32,
     a switch encode at QP 37): FC and float merger launches at N = 1 (==
     4 x FC forwards and the conv forwards), every forward against its
     plain version (<= 1e-4 of max |plain|, the pixels near a tie counted
     by unit), the round trip exact, and the stream, reconstruction and
     mode map equal to the JAX package's where no coded PNN unit hit a
     tie
 19  (runs before 8) PNN training end to end: `TrainingPipeline` over the
     shipped crop shard `artifacts/training_set/luminance/thread_0/
     data_1.npz` (on-the-fly extraction, seed 0), the w8 FC and the w16
     conv PNN at batch 100 with random masks in two `train_chunk`s of 25
     steps (the LR boundaries at 25, 37 and 43), a checkpoint after the
     first restored and its second chunk equal to the uninterrupted run bit
     for bit, the first step's loss and gradients against the same step on
     the CPU in float64 (loss within 1e-5 relative; per leaf 98% of the
     gradients within 1e-4 of its max |g|, all within 5e-2), s/step and the
     loss at steps 1, 25 and 50 (finite, lower at 50), no kernel launched
     by training; 5 steps of the w64 conv PNN (s/step); both trained
     models frozen (`export_pnn.freeze_checkpoint`) and loaded back,
     `predict_by_batch` on 1024 contexts through the FC and float merger
     kernels (launches counted, every call against its plain version:
     FC <= 1e-4, merger <= 1e-5 of max |plain|), `PnnBundle.quantize`, and
     a switch encode of the 128x128 natural frame with the quantized
     trained w8 FC and w16 conv (w4, w32 from artifacts/frozen; trial and
     integer merger launches counted), decoded back by the port's decoder
 20  (runs before 8) the multi-rank paths: 2 ranks of one Gloo group on
     the card (`parallel/mesh.spawn_ranks`; they load phase 1's libraries
     and build none) run the tiled quadtree halo encode of the frame's top
     1024x1920 (regular, rate evolution off) and of a 128x256 crop under
     switch with the frozen singles, the v1 tiled halo and tiled encodes
     at block size 16, and 3-step sharded training chunks at batch 100
     (w8 FC at dp = 2, w16 conv at tp = 2) in float32, with the first
     step alone, and in float64; this process runs the single-device
     references first, alone on the card.  Every rank's encodes equal
     one device's (reconstruction, CU trees, mode map, stream), with each
     rank's trial and merger launches printed; the sharded losses within
     1e-5 relative, the first step's gradients against float64 as in
     phase 19, and after the float64 chunks the parameters and both Adam
     moments within 1e-5 of each leaf's max |value| at every entry; the
     ranks' and the references' seconds beside nvidia-smi's line
  8  per kernel, on phase-4, phase-6 and phase-9 inputs, and on the batched
     paths' (the trial at 124 slots from phase 10, the merger at N = 124
     from phase 11 and at N = 1 from phase 13's decode), CTB 64's (the
     trial at 16 slots from phase 14) and the quantize path's (phase 17:
     one FC layer at N = 256 for K = 80, 320 and 1200, the float merger at
     N = 256 for M = 32 ... 256, float32 weights) and the host codec's
     (phase 18: the integer merger at M = 512, N = 1; the FC chains and
     the float merger at N = 1): launches, max abs
     error, ms per call (CUDA events, calls queued back to back; where
     there is a library call, the kernel and it timed in turns, kernel,
     library, library, kernel, ...; and the same queued behind a spin of
     the card, so that the events time its work alone), the kernels' own
     device time (profiler; a session that dropped kernel records is
     profiled again), plain ms, bound ms (the least over a kernel's routes,
     named in `bound_route`: for the trial its exact ones, int32 on the
     CUDA cores or FP64 on the tensor cores, or "f32 operations" where
     its float32 work takes longer; for the FC PNN its float32-accurate
     ones), and the
     time of one library call of the same function where there is one
     (library ms): a float64 `torch.bmm` for the integer merger, a float32
     `torch.matmul` chain (TF32 off) for the FC PNN, a float32 `torch.bmm`
     for the float merger; the FC PNN and float merger also
     at the serving shapes of `scripts/profile_mfu.py` (bf16 weights, w8
     FC and the w16 merger at batch 256 and 2048); per PNN width, the
     whole quantized forward of one sub-stage: ms per call and the device
     activities the profiler sees; and the latency floor, an empty kernel
     launched through the same ctypes path (queued and profiler us,
     without and with 33 KB of shared memory, alone and alternating)

The line before the last is the kernels JSON, the last line
{"ok": true, "device": {...}}.  Any failure exits nonzero.  It imports
nothing of JAX and starts no process other than the compilers,
nvidia-smi, HM's decoder (`artifacts/hm_bin/TAppDecoderStatic`) and
phase 20's two ranks, which it joins inside the phase.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
QP = 32
H, W = 1056, 1920
CROP = (288, 960)       # the regular path's plain comparison (phase 5)
H64 = 1024              # CTB 64 needs rows in whole CTBs: the top 1024
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
PORT = "context_adaptive_neural_network_based_prediction_tpu_torch/"
FC_SOURCE = PORT + "ops/csrc/fc_forward.cu"
FC_REPLACES = ("context_adaptive_neural_network_based_prediction_tpu/ops/"
               "pallas/fc_forward.py:83")
FMERGER_SOURCE = PORT + "ops/csrc/merger.cu"
FMERGER_REPLACES = ("context_adaptive_neural_network_based_prediction_tpu/"
                    "ops/pallas/merger.py:69")
FLOAT_POSITIONS = 2048      # compare_on_channels positions on the 1080p luma
FC_CHECK_N = (1, 7, 127, 128, 129, 200, 256, 1024, 2048)
SPIN_CYCLES = 1_000_000     # about 0.5 ms of the card's clock (queued timing)
MERGER_CHECK_N = (1, 31, 33, 256, 1024, 2048)
SERVING_BATCHES = (256, 2048)   # scripts/profile_mfu.py's FC / merger rows
STREAM_FRAMES = 9           # the streaming phase: batches of 4, the last padded
MANIFEST = os.path.join(REPO, "artifacts", "frozen", "manifest_quantized.txt")
MEAN_PKL = os.path.join(REPO, "artifacts", "training_set", "luminance",
                        "means", "mean_training.pkl")
# H100 SXM peaks (NVIDIA's data sheet): HBM 3.35 TB/s; 67 T/s for float32
# outside the tensor cores; dense tensor cores 495 T/s in TF32, 989 T/s in
# bf16.  The int32 rate is read from the card (SM count and max SM clock,
# 64 int32 lanes per SM, a multiply-add counted as two).
HBM_BPS = 3.35e12
F32_OPS = 67e12
TF32_OPS = 495e12
BF16_OPS = 989e12
GRID_NAMES = ("m8", "q8", "s8", "m4", "q4", "m16", "q16", "s16", "m32",
              "q32", "s32", "m64", "q64", "s64")
HM_DECODER = os.path.join(REPO, "artifacts", "hm_bin", "TAppDecoderStatic")
# Phase 17: the six float singles of the chip copy, and the four whose
# quantized forms make the switch encode's zoo (width of each).
QUANTIZE_MODELS = ("pnn_w4_fc_single", "pnn_w8_fc_single",
                   "pnn_w4_refconv_single", "pnn_w8_refconv_single",
                   "pnn_w16_single", "pnn_w32_single")
QUANTIZE_SWITCH = {"pnn_w4_refconv_single": 4, "pnn_w8_refconv_single": 8,
                   "pnn_w16_single": 16, "pnn_w32_single": 32}
STEP_SPIN_CYCLES = 20_000_000   # about 10 ms: longer than a step's issue
# Phase 19: one shipped crop shard (60 crops of 320x320), the reference's
# batch of 100, two chunks of 25 steps, 5 steps of w64, 1024 contexts.
TRAIN_SHARD = os.path.join(REPO, "artifacts", "training_set", "luminance",
                           "thread_0", "data_1.npz")
TRAIN_BATCH, TRAIN_CHUNK, W64_STEPS, TRAIN_CONTEXTS = 100, 25, 5, 1024
# Phase 20: two ranks sharing the card (Gloo), the switch crop, the v1
# block size and the sharded chunk's steps.
RANKS, SWITCH_CROP, V1_BLOCK, SHARD_STEPS = 2, (128, 256), 16, 3
# The kernel of one trial call, by unit size (profiler names).
TRIAL_KERNELS = {4: ("trial_small_kernel",), 8: ("trial_small_kernel",),
                 16: ("trial_large_kernel",), 32: ("trial_large_kernel",)}


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


def ctb64_frames():
    """The two frames of tests/golden_torch/w2_ctb64.json."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:64, 0:128]
    smooth = np.clip(128 + 40 * np.sin(xx / 37.0) + 30 * np.cos(yy / 41.0)
                     + rng.normal(0, 3, (64, 128)), 0, 255).astype(np.uint8)
    natural = np.load(os.path.join(REPO, "tests", "golden_hm",
                                   "128_full_q32_src.npy"))
    return {"smooth64x128": smooth, "natural128": natural}


def run_hm_decoder(stream, tmp):
    """Stock HM-16.15's decode of an Annex-B stream: (its stdout, the
    decoded 8-bit samples, flat)."""
    bs, yuv = os.path.join(tmp, "hm.bin"), os.path.join(tmp, "hm.yuv")
    with open(bs, "wb") as f:
        f.write(stream)
    proc = subprocess.run([HM_DECODER, "-b", bs, "-o", yuv, "-d", "8"],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"TAppDecoderStatic exited {proc.returncode}: "
                             f"{proc.stdout[-500:]} {proc.stderr[-500:]}")
    return proc.stdout, np.fromfile(yuv, np.uint8)


def hm_decode(stream, h, w, tmp):
    """Stock HM-16.15's decode of a 4:0:0 stream: (its stdout, the decoded
    8-bit luma (h, w))."""
    out, luma = run_hm_decoder(stream, tmp)
    if luma.size != h * w:
        raise AssertionError(f"HM wrote {luma.size} samples, want {h * w}")
    return out, luma.reshape(h, w)


def v1_frame(spec):
    """A frame of tests/golden_torch/w1.json, made as its capture script
    makes it."""
    from context_adaptive_neural_network_based_prediction_tpu_torch \
        .evaluation.v1_frames import make_frame

    return make_frame(spec)


def _counted():
    from context_adaptive_neural_network_based_prediction_tpu_torch.ops \
        import fc_forward, merger, merger_int, unit_fused, v1_step

    return {"unit_trial": unit_fused, "merger_int": merger_int,
            "fc_forward": fc_forward, "merger": merger, "v1_step": v1_step}


def v1_n_steps(h, w, n):
    """The v1 wavefront's steps over an h x w frame of n x n blocks."""
    return (w // n - 1) + 2 * (h // n - 1) + 1


def reset_all_counts():
    """Every kernel wrapper's launch counts to 0."""
    for mod in _counted().values():
        mod.reset_launch_counts()


def read_all_counts():
    """Launches of each kernel since `reset_all_counts`."""
    return {k: sum(mod.launches.values()) for k, mod in _counted().items()}


def count_dispatched_ops(fn):
    """The aten ops one call of `fn` dispatches (views included)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    count = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            count[0] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return count[0]


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


def check_captured(got, want, what):
    if got != want:
        raise AssertionError(f"{what}: {got} != captured {want}")


def check_close(got, want, tol, what):
    """max |got - want| / max |want|; raises above `tol`."""
    err = ((got.double() - want.double()).abs().max()
           / want.double().abs().max().clamp_min(1e-30)).item()
    if not err <= tol:
        raise AssertionError(f"{what}: kernel differs from plain by {err:.3e}"
                             f" of max |plain| (tolerance {tol:g})")
    return err


def fc_layers(rng, w, dtype, dev):
    """Seeded FC PNN layers at width w: weights with the JAX package's init
    distributions, small random biases."""
    import torch

    dims = [(5 * w * w, 1200), (1200, 1200), (1200, 1200), (1200, w * w)]
    ws, bs = [], []
    for (k, d), sd in zip(dims, (0.01, 0.029, 0.029, 0.01)):
        ws.append(torch.from_numpy(rng.normal(0, sd, (k, d)).astype(
            np.float32)).to(dev, dtype))
        bs.append(torch.from_numpy(rng.normal(0, 0.1, d).astype(
            np.float32)).to(dev))
    return ws, bs


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


def save_quantized_checks(q_models):
    """Phase 17: each quantized model written by `save_quantized` and read
    back by `load_quantized`, every array equal in value, dtype and shape,
    and `kind` equal."""
    from context_adaptive_neural_network_based_prediction_tpu_torch.models \
        import pnn_q

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for name, q in q_models.items():
            path = os.path.join(tmp, f"qpnn_{name}.npz")
            pnn_q.save_quantized(path, q)
            back = pnn_q.load_quantized(path)
            bad = sorted(k for k in q if k != "kind" and not (
                back[k].dtype == np.asarray(q[k]).dtype
                and np.array_equal(back[k], np.asarray(q[k]))))
            if set(back) != set(q) or back["kind"] != q["kind"] or bad:
                raise AssertionError(f"save_quantized {name}: read back "
                                     f"differs in {bad}")
    say(f"save_quantized / load_quantized: the {len(q_models)} quantized "
        f"models read back equal (every array's value, dtype and shape, and "
        f"kind): {time.perf_counter() - t0:.2f} s")


def port_api_checks(dev):
    """Phase 3: the batched transforms and quantiser on the card against
    their numpy twins, on seeded (B, n, n) blocks over the 16-bit range
    (its extremes included) and on the chain of 9-bit residuals, for
    n = 4, 8, 16, 32 and the 4x4 DST, at QP 22 and 37 and both slice
    types; and `predict_via_hevc_mode` on the card against
    `predict_one_mode_np` for w = 4 ... 32, all 35 modes."""
    import torch

    from context_adaptive_neural_network_based_prediction_tpu_torch.ops \
        import intra, transform

    t0 = time.perf_counter()
    rng = np.random.default_rng(16)
    lo, hi = -32768, 32767
    for n, dst in ((4, False), (4, True), (8, False), (16, False),
                   (32, False)):
        yy, xx = np.mgrid[0:n, 0:n]
        full = np.concatenate([
            rng.integers(lo, hi + 1, (64, n, n)), np.full((1, n, n), lo),
            np.full((1, n, n), hi), np.where((yy + xx) % 2, lo, hi)[None]]
        ).astype(np.int32)
        resi = rng.integers(-255, 256, (64, n, n)).astype(np.int32)
        xd = torch.from_numpy(full).to(dev)
        checks = [
            ("forward_transform", transform.forward_transform(
                xd, use_dst=dst), transform.forward_transform_np(
                    full, use_dst=dst)),
            ("inverse_transform", transform.inverse_transform(
                xd, use_dst=dst), transform.inverse_transform_np(
                    full, use_dst=dst))]
        for qp in (22, 37):
            for intra_slice in (True, False):
                checks.append((f"quantize QP {qp} intra={intra_slice}",
                               transform.quantize(
                                   xd, qp, is_intra_slice=intra_slice),
                               transform.quantize_np(
                                   full, qp, is_intra_slice=intra_slice)))
            checks.append((f"dequantize QP {qp}",
                           transform.dequantize(xd, qp),
                           transform.dequantize_np(full, qp)))
            c = transform.forward_transform(torch.from_numpy(resi).to(dev),
                                            use_dst=dst)
            chain = transform.inverse_transform(transform.dequantize(
                transform.quantize(c, qp), qp), use_dst=dst)
            c_np = transform.forward_transform_np(resi, use_dst=dst)
            chain_np = transform.inverse_transform_np(transform.dequantize_np(
                transform.quantize_np(c_np, qp), qp), use_dst=dst)
            checks.append((f"9-bit chain QP {qp}", chain, chain_np))
        for what, got, want in checks:
            if got.device != xd.device or got.dtype != torch.int32 \
                    or not np.array_equal(got.cpu().numpy(), want):
                raise AssertionError(f"n={n} dst={dst} {what}: the card's "
                                     f"result differs from the numpy twin")
    say("forward_transform, inverse_transform, quantize, dequantize on the "
        "card == their numpy twins: n = 4, 8, 16, 32 and the DST, 16-bit "
        f"blocks with the extremes and the 9-bit chain, QP 22 and 37: "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    calls = 0
    for w in (4, 8, 16, 32):
        for h_ip, w_ip in ((w + 1, 2 * w + 1), (2 * w + 1, w + 1),
                           (2 * w + 1, 2 * w + 1)):
            pat = rng.integers(0, 256, (h_ip, w_ip, 1), dtype=np.uint8)
            ref_top, ref_left = intra.pad_intra_pattern(pat, w)
            for mode in range(35):
                got = intra.predict_via_hevc_mode(pat, w, mode, device=dev)
                want = intra.predict_one_mode_np(ref_top, ref_left, mode)
                calls += 1
                if got.shape != (w, w, 1) or not np.array_equal(
                        got[..., 0], want.astype(np.uint8)):
                    raise AssertionError(f"predict_via_hevc_mode w={w} "
                                         f"pattern {h_ip}x{w_ip} mode "
                                         f"{mode} != predict_one_mode_np")
    say(f"predict_via_hevc_mode on the card == predict_one_mode_np: "
        f"{calls} calls, w = 4 ... 32, three pattern sizes, 35 modes: "
        f"{time.perf_counter() - t0:.2f} s")


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
        import (_cuda_build, fc_forward, kernel_variants, merger, merger_int,
                transform, unit_fused)
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
        int_ops, f64_ops = card_rates()
        say(f"device: {kind}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}; count {torch.cuda.device_count()}")
        say(f"nvidia-smi: {smi}; int32 rate {int_ops / 1e12:.2f} T/s, FP64 "
            f"tensor cores {f64_ops / 1e12:.2f} T/s")
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
        for name in _cuda_build.NAMES:
            for line in _build_dir.output.get(name, "").splitlines():
                if "registers" in line or "spill" in line:
                    say(f"ptxas {name}: {line.split(':', 1)[-1].strip()}")
        say(tensor_core_sass(_cuda_build.build("fc_forward")))
        ws, _ = fc_layers(np.random.default_rng(8), 8, torch.float32, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prepared = [fc_forward.prepare_weight(w) for w in ws]
        torch.cuda.synchronize()
        prep_ms = (time.perf_counter() - t0) * 1e3
        prep_mb = sum(t.numel() * 4 for pair in prepared for t in pair) / 1e6
        say(f"fc_forward weight preparation (w8 chain, float32, hi and lo): "
            f"{prep_ms:.3f} ms, {prep_mb:.1f} MB on the card")

    # ---- phase 2: kernels vs plain ----
    with Phase("2 kernel vs plain"):
        t0 = time.perf_counter()
        plan, dp = wavefront2._get_plan(H, W, QP, 1.0, 32, True, True, dev)
        say(f"1080p plan and tables: {time.perf_counter() - t0:.2f} s")
        b = plan["b_eff"]
        rng = np.random.default_rng(2024)
        for n in (4, 8, 16, 32):
            tc = dp["trial"][n]
            # n = 4 and 8 (a cluster per slot) also at a single slot.
            for slots in ((b, 1) if n <= 8 else (b,)):
                for extreme in (False, True):
                    args = [torch.from_numpy(x).to(dev) for x in
                            trial_inputs(rng, n, slots, extreme=extreme)]
                    got = unit_fused.trial_apply(tc, *args, impl="kernel")
                    want = unit_fused.trial_apply(tc, *args, impl="plain")
                    torch.cuda.synchronize()
                    assert_equal(got, want, f"n={n} b={slots} "
                                 f"extreme={extreme}")
                say(f"n={n}: kernel == plain on {slots} slots (random, "
                    f"extreme)")
        for policy in ("sub18", "append"):
            n_modes = 36 if policy == "append" else 35
            for n in (4, 8, 16, 32):
                c = wavefront2._unit_consts(n, QP, n_modes)
                tc = unit_fused.consts_from_numpy(unit_fused.build_consts(
                    n, n_modes, c, plan["SB"], plan["lam"],
                    transform.QUANT_SCALES[QP % 6],
                    transform.INV_QUANT_SCALES[QP % 6], b, nn_policy=policy,
                    groups={4: 1, 8: 1, 16: 6, 32: 36}[n]), device=dev)
                for slots, extreme in ((b, False), (b, True), (1, True)):
                    rt, rl, og, mb, rr = trial_inputs(
                        rng, n, slots, n_modes=n_modes, extreme=extreme)
                    nnp = np.clip(og + rng.integers(-3, 4, og.shape), 0, 255)
                    args = [torch.from_numpy(x).to(dev)
                            for x in (rt, rl, og, mb, rr)]
                    nn_pred = torch.from_numpy(nnp.astype(np.int32)).to(dev)
                    got = unit_fused.trial_apply(tc, *args, nn_pred=nn_pred)
                    want = unit_fused.trial_apply(tc, *args, impl="plain",
                                                  nn_pred=nn_pred)
                    torch.cuda.synchronize()
                    assert_equal(got, want, f"{policy} n={n} b={slots} "
                                 f"extreme={extreme}")
            say(f"nn_policy {policy}: kernel == plain with a PNN prediction,"
                f" n = 4..32, {b} slots (random, extreme) and 1 slot")
        for m in NN_MAPS.values():
            for slots in (1, 17, b):
                for extreme in (False, True):
                    x, w, bb = [torch.from_numpy(a).to(dev) for a in
                                merger_inputs(rng, m, slots, extreme=extreme)]
                    got = merger_int.merger_int_forward(x, w, bb)
                    want = merger_int.merger_int_forward(x, w, bb,
                                                         impl="plain")
                    torch.cuda.synchronize()
                    assert_equal(got, want, f"merger M={m} N={slots} "
                                 f"extreme={extreme}")
            say(f"merger M={m}: kernel == plain on 1, 17 and {b} slots "
                f"(random, caps)")
        for slots in (1, b):        # the w64 models' merger, M = 512
            for extreme in (False, True):
                x, w, bb = [torch.from_numpy(a).to(dev) for a in
                            merger_inputs(rng, 512, slots, extreme=extreme)]
                got = merger_int.merger_int_forward(x, w, bb)
                want = merger_int.merger_int_forward(x, w, bb, impl="plain")
                torch.cuda.synchronize()
                assert_equal(got, want, f"merger M=512 N={slots} "
                             f"extreme={extreme}")
        say(f"merger M=512: kernel == plain on 1 and {b} slots (random, "
            f"the w64 caps)")
        for w in (4, 8):
            for dtype in (torch.float32, torch.bfloat16):
                ws, bs = fc_layers(rng, w, dtype, dev)
                worst = 0.0
                for n in FC_CHECK_N:
                    x = torch.from_numpy(rng.normal(0, 30, (
                        n, 5 * w * w)).astype(np.float32)).to(dev)
                    got = fc_forward.fc_forward(x, ws, bs)
                    want = fc_forward.fc_forward(x, ws, bs, impl="plain")
                    torch.cuda.synchronize()
                    worst = max(worst, check_close(
                        got, want, 1e-4, f"fc w={w} {dtype} N={n}"))
                    assert_equal(fc_forward.fc_forward(x, ws, bs), got,
                                 f"fc w={w} {dtype} N={n} repeated")
                say(f"fc_forward w={w} {dtype}: kernel == plain within "
                    f"{worst:.2e} of max |plain| at N = {FC_CHECK_N}; "
                    f"repeated calls equal bit for bit")
        for m in (32, 64, 128, 256, 512):
            worst = 0.0
            for n in MERGER_CHECK_N:
                x, w, bb = [torch.from_numpy(a.astype(np.float32)).to(dev)
                            for a in (rng.normal(0, 1, (n, 80, m)),
                                      rng.normal(0, 0.1, (80, 16, m)),
                                      rng.normal(0, 0.1, (16, m)))]
                for act in (False, True):
                    got = merger.merger_forward(x, w, bb, act=act)
                    want = merger.merger_forward(x, w, bb, act=act,
                                                 impl="plain")
                    torch.cuda.synchronize()
                    worst = max(worst, check_close(
                        got, want, 1e-5, f"float merger M={m} N={n} "
                        f"act={act}"))
                    assert_equal(merger.merger_forward(x, w, bb, act=act),
                                 got, f"float merger M={m} N={n} repeated")
            say(f"float merger M={m}: kernel == plain within {worst:.2e} "
                f"of max |plain| at N = {MERGER_CHECK_N}, with and without "
                f"the activation; repeated calls equal bit for bit")

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
        # CTB 64, rate evolution off, one frame a call (the batches of two
        # are held on the CPU, tests/test_torch_wavefront2_ctb64*.py, to
        # keep the smoke inside its time).
        with open(os.path.join(REPO, "tests", "golden_torch",
                               "w2_ctb64.json")) as f:
            golden64 = json.load(f)["encodes"]
        frames64 = ctb64_frames()
        for fname, policy, nf in sorted({
                (e["frame"], e["policy"], e["n_frames"])
                for e in golden64.values() if e["n_frames"] == 1}):
            e0 = golden64[f"{fname}/{policy}/b{nf}/0"]
            batch = np.stack([frames64[fname],
                              frames64[fname][:, ::-1]])[:nf]
            pnn = None if policy == "regular" else bundles[e0["bundle"]]
            unit_fused.reset_launch_counts()
            merger_int.reset_launch_counts()
            out = wavefront2.encode_arrays_wavefront2_batch(
                batch, e0["qp"], policy=policy, pnn=pnn, ctb=64, device=dev)
            n_trials = sum(unit_fused.launches.values())
            n_mergers = sum(merger_int.launches.values())
            for f, (recon, grids) in enumerate(out):
                key = f"{fname}/{policy}/b{nf}/{f}"
                res = wavefront2._arrays_to_result(
                    batch[f], e0["qp"], (recon,) + grids, policy, True,
                    ctb=64)
                got = digest_items(recon, grids, res.bitstream)
                bad = [k for k in got if got[k] != golden64[key][k]]
                if bad or not n_trials or (pnn is not None
                                           and not n_mergers):
                    raise AssertionError(
                        f"CTB 64 {key}: differs from the JAX package's "
                        f"digests in {bad} (trial launches {n_trials}, "
                        f"merger launches {n_mergers})")
                say(f"CTB 64 {key} (QP {e0['qp']}): recon, 14 grids and "
                    f"stream match the JAX package's digests "
                    f"({len(res.bitstream)} bytes, "
                    f"{int(np.sum(grids[13] == 0))} 64x64 leaves; trial "
                    f"launches {n_trials}, merger launches {n_mergers})")
        port_api_checks(dev)

    # ---- phases 4-7: the 1080p paths ----
    frame = bench_frame()
    captured = {}
    orig_trial, orig_merger = unit_fused._kernel_trial, merger_int._kernel

    def capture_trial(tc, *args):    # one input set per (n, slots)
        # (ref_top, ref_left, orig, mode_bits, rate_rows); the regular
        # path passes no PNN prediction.
        key = (tc["n"], args[0].shape[0])
        if key not in captured and args[5] is None:
            captured[key] = (tc, [None if a is None else a.clone()
                                  for a in args[:5]])
        return orig_trial(tc, *args)

    def capture_merger(x, w, bb):     # one input set per (M, N)
        key = ("merger", x.shape[2], x.shape[0])
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

    def encode_batch(frames, policy, capture=None):
        """One batched encode of (B, H, W) frames, its counts read around
        the device half: (per-frame [(recon, grids, result)], device
        seconds, pack seconds for all frames, counts)."""
        pnn = frozen if policy != "regular" else None
        nf, h, w = frames.shape
        t0 = time.perf_counter()
        wavefront2._get_plan(h, w, QP, 1.0, 32, True, True, dev,
                             policy=policy, bundle=pnn, n_frames=nf)
        say(f"{h}x{w} {policy} b={nf} plan: {time.perf_counter() - t0:.2f}"
            f" s")
        torch.cuda.synchronize()
        unit_fused.reset_launch_counts()
        merger_int.reset_launch_counts()
        if capture:
            unit_fused._kernel_trial = capture_trial
            merger_int._kernel = capture_merger
        t0 = time.perf_counter()
        try:
            out = wavefront2.encode_arrays_wavefront2_batch(
                frames, QP, policy=policy, pnn=pnn, rate_evolve=True,
                device=dev)
            torch.cuda.synchronize()
        finally:
            unit_fused._kernel_trial = orig_trial
            merger_int._kernel = orig_merger
        t_dev = time.perf_counter() - t0
        counts = (dict(unit_fused.launches), dict(merger_int.launches))
        t0 = time.perf_counter()
        results = [(recon, grids, wavefront2._arrays_to_result(
            f, QP, (recon,) + grids, policy, True))
            for f, (recon, grids) in zip(frames, out)]
        t_pack = time.perf_counter() - t0
        for f, (recon, _, _) in zip(frames, results):
            mse = np.mean((recon.astype(np.float64) - f) ** 2)
            if not 20.0 < 10 * np.log10(255.0 ** 2 / mse) < 60.0:
                raise AssertionError(f"implausible batched output: {mse}")
        return results, t_dev, t_pack, counts

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

    # The plain comparisons run on the frame's top-left 288x960 crop (9 x
    # 30 CTBs, about a seventh of the 1080p frame), to keep the smoke
    # inside its time limit with phase 20 on slow hosts.
    with Phase(f"5 {CROP[0]}x{CROP[1]} plain"):
        crop = np.ascontiguousarray(frame[:CROP[0], :CROP[1]])
        crop_k = encode(crop, "regular", "kernel")
        crop_p = encode(crop, "regular", "plain")
        assert_same_encode(crop_k, crop_p, f"{CROP[0]}x{CROP[1]}")
        if crop_p[6][0] != {4: 0, 8: 0, 16: 0, 32: 0}:
            raise AssertionError("the plain path launched the trial kernel")
        say(f"{CROP[0]}x{CROP[1]} regular: kernel path device half "
            f"{crop_k[3]:.3f} s, "
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

    with Phase(f"7 {CROP[0]}x{CROP[1]} switch plain"):
        sw_ck = encode(crop, "switch", "kernel")
        sw_p = encode(crop, "switch", "plain")
        assert_same_encode(sw_ck, sw_p, f"{CROP[0]}x{CROP[1]} switch")
        if sw_p[6][1] or sw_p[6][0] != {4: 0, 8: 0, 16: 0, 32: 0}:
            raise AssertionError("the plain path launched a kernel")
        if not sum(sw_ck[6][1].values()):
            raise AssertionError("the crop's switch kernel path launched "
                                 "no merger")
        say(f"{CROP[0]}x{CROP[1]} switch: kernel path device half "
            f"{sw_ck[3]:.3f} s, plain path {sw_p[3]:.3f} s; recon, 11 grids "
            f"and stream identical")

    # ---- phases 10-13: frame batching, streaming and decoding ----
    frames4 = np.stack([frame, np.ascontiguousarray(frame[:, ::-1]),
                        np.ascontiguousarray(frame[::-1]),
                        np.roll(frame, 64, axis=1)])
    with Phase("10 1080p regular b=4"):
        singles = [reg_k] + [encode(f, "regular", "kernel")
                             for f in frames4[1:]]
        b4, t_dev4, t_pack4, (b4_trials, _) = encode_batch(
            frames4, "regular", capture=True)
        for i, (one, got) in enumerate(zip(singles, b4)):
            assert_same_encode(got, one, f"1080p b=4 frame {i}")
        say(f"1080p regular b=4 (frame, left-right flip, up-down flip, "
            f"64-column roll): each frame identical to its b=1 encode; "
            f"device half {t_dev4:.3f} s = {t_dev4 / 4:.3f} s a frame "
            f"against b=1 {t_dev:.3f} s (phase 4; the other frames' b=1 "
            f"halves {', '.join(f'{x[3]:.3f}' for x in singles[1:])} s); "
            f"pack {t_pack4:.3f} s for 4 frames; trial launches {b4_trials}"
            f" (step loop trial calls {want_trials})")
        if b4_trials != want_trials:
            raise AssertionError("b=4: trial launches != trial calls")

    with Phase("11 1080p switch b=4"):
        sw4_frames = np.stack([frame, frames4[1], frames4[1], frame])
        sw4, t_dev_s4, t_pack_s4, (sw4_trials, sw4_mergers) = encode_batch(
            sw4_frames, "switch", capture=True)
        for i in (0, 3):
            assert_same_encode(sw4[i], sw_k, f"1080p switch b=4 frame {i}")
        assert_same_encode(sw4[1], sw4[2], "1080p switch b=4 frames 1, 2")
        say(f"1080p switch b=4 (frame, flip, flip, frame): frames 0 and 3 "
            f"identical to phase 6, frames 1 and 2 to each other; device "
            f"half {t_dev_s4:.3f} s = {t_dev_s4 / 4:.3f} s a frame against "
            f"b=1 {t_dev_s:.3f} s; pack {t_pack_s4:.3f} s; trial launches "
            f"{sw4_trials}, merger launches {sw4_mergers} (step loop PNN "
            f"calls {want_mergers})")
        if sw4_trials != want_trials or sw4_mergers != want_mergers:
            raise AssertionError("switch b=4: launches != step loop calls")

    with Phase("12 stream"):
        stream_in = [frames4[i % 4] for i in range(STREAM_FRAMES)]
        batches = -(-STREAM_FRAMES // 4)
        # The stream's own device halves (`run`, which ends with the copy
        # to the host) and packs, timed inside the same run.
        orig_run, orig_pack = wavefront2.run, wavefront2._host_pack_one
        spent = {"run": [], "pack": []}

        def timed(name, fn):
            def call(*args, **kwargs):
                t = time.perf_counter()
                out = fn(*args, **kwargs)
                spent[name].append(time.perf_counter() - t)
                return out
            return call

        torch.cuda.synchronize()
        unit_fused.reset_launch_counts()
        wavefront2.run = timed("run", orig_run)
        wavefront2._host_pack_one = timed("pack", orig_pack)
        t0 = time.perf_counter()
        try:
            streamed = list(wavefront2.encode_stream_wavefront2(
                iter(stream_in), QP, batch=4, rate_evolve=True, device=dev))
        finally:
            wavefront2.run, wavefront2._host_pack_one = orig_run, orig_pack
        t_stream = time.perf_counter() - t0
        st_trials = dict(unit_fused.launches)
        if len(streamed) != STREAM_FRAMES:
            raise AssertionError(f"stream gave {len(streamed)} results")
        for i, res in enumerate(streamed):
            one = singles[i % 4]
            if (res.bitstream != one[2].bitstream
                    or not np.array_equal(res.reconstruction, one[0])):
                raise AssertionError(f"stream frame {i} != its b=1 encode")
        if st_trials != {n: batches * k for n, k in want_trials.items()}:
            raise AssertionError(f"stream: trial launches {st_trials}")
        t_runs, t_packs = sum(spent["run"]), sum(spent["pack"])
        say(f"stream of {STREAM_FRAMES} regular 1080p frames at batch 4 "
            f"({batches} device runs, the last padded): each stream and "
            f"reconstruction identical to its frame's b=1 encode; "
            f"{t_stream:.3f} s end to end = "
            f"{STREAM_FRAMES / t_stream:.4f} frames/s; of it the device "
            f"halves {', '.join(f'{x:.3f}' for x in spent['run'])} s, the "
            f"packs {t_packs:.3f} s ({STREAM_FRAMES} frames), the rest "
            f"{t_stream - t_runs - t_packs:.3f} s; phase 10's device half "
            f"plus pack gives {4 / (t_dev4 + t_pack4):.4f} frames/s; trial "
            f"launches {st_trials}")

    from context_adaptive_neural_network_based_prediction_tpu_torch.codec \
        import decoder
    decode_mergers = {}
    with Phase("13 decode"):
        for what, stream, want, pnn in (
                ("1080p regular (phase 4)", res_k.bitstream, reg_k[0],
                 None),
                ("1080p switch (phase 6)", res_s.bitstream, sw_k[0], frozen),
                ("1080p switch b=4 frame 1 (phase 11)", sw4[1][2].bitstream,
                 sw4[1][0], frozen)):
            torch.cuda.synchronize()
            merger_int.reset_launch_counts()
            merger_int._kernel = capture_merger
            t0 = time.perf_counter()
            try:
                dec = decoder.FrameDecoder(stream, pnn=pnn, device=dev)
                out = dec.decode()
                torch.cuda.synchronize()
            finally:
                merger_int._kernel = orig_merger
            t_decode = time.perf_counter() - t0
            got = dict(merger_int.launches)
            conv = dec.pnn.forwards["conv"] if pnn is not None else 0
            fc = dec.pnn.forwards["fc"] if pnn is not None else 0
            if not np.array_equal(out.reconstruction, want):
                raise AssertionError(f"decode of {what} != the encoder's "
                                     f"reconstruction")
            if sum(got.values()) != conv or (pnn is not None and not conv):
                raise AssertionError(f"{what}: merger launches {got} != "
                                     f"conv PNN forwards {conv}")
            if what.startswith("1080p switch (phase 6)"):
                decode_mergers = got
            say(f"decode of the {what} stream on the card: "
                f"{t_decode:.3f} s, reconstruction identical to the "
                f"encoder's; PNN forwards conv {conv}, fc {fc}; merger "
                f"launches {got}")

    # ---- phases 14-15: CTB 64 and the Annex-B output ----
    frame64 = np.ascontiguousarray(frame[:H64])
    with Phase("14 CTB 64"):
        t0 = time.perf_counter()
        plan64, _ = wavefront2._get_plan(H64, W, QP, 1.0, 64, True, False,
                                         dev)
        say(f"{H64}x{W} CTB-64 plan: {time.perf_counter() - t0:.2f} s")
        want64 = {n: plan64["n_steps"] * 4 * k
                  for n, k in UNIT_SUBSTAGES.items()}
        orig_cand = wavefront2._candidate64
        cand_host, cand_events = [], []

        def timed_cand(*args):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            t = time.perf_counter()
            ev[0].record()
            out = orig_cand(*args)
            ev[1].record()
            cand_host.append(time.perf_counter() - t)
            cand_events.append(ev)
            return out

        torch.cuda.synchronize()
        unit_fused.reset_launch_counts()
        unit_fused._kernel_trial = capture_trial
        wavefront2._candidate64 = timed_cand
        t0 = time.perf_counter()
        try:
            recon64, grids64 = wavefront2.encode_arrays_wavefront2(
                frame64, QP, ctb=64, device=dev)
            torch.cuda.synchronize()
        finally:
            unit_fused._kernel_trial = orig_trial
            wavefront2._candidate64 = orig_cand
        t_dev64 = time.perf_counter() - t0
        launches64 = dict(unit_fused.launches)
        t0 = time.perf_counter()
        res64 = wavefront2._arrays_to_result(frame64, QP, (recon64,)
                                             + grids64, "regular", True,
                                             ctb=64)
        t_pack64 = time.perf_counter() - t0
        psnr64 = 10 * np.log10(255.0 ** 2 / np.mean(
            (recon64.astype(np.float64) - frame64) ** 2))
        cand_ms = [a.elapsed_time(b) for a, b in cand_events]
        if len(cand_ms) != plan64["n_steps"] or not 20 < psnr64 < 60:
            raise AssertionError(f"CTB 64: {len(cand_ms)} candidate calls, "
                                 f"PSNR {psnr64}")
        say(f"{H64}x{W} CTB-64 regular kernel path: device half "
            f"{t_dev64:.3f} s, pack {t_pack64:.3f} s, PSNR {psnr64:.4f} dB,"
            f" {res64.num_bits} bits, {int(np.sum(grids64[13] == 0))} "
            f"64x64 leaves of {grids64[13].size}; 64x64 candidate "
            f"{1e3 * sum(cand_host) / len(cand_host):.3f} ms a step on the "
            f"host, {sum(cand_ms) / len(cand_ms):.3f} ms a step between "
            f"its CUDA events ({sum(cand_ms) / 1e3:.3f} s of "
            f"{len(cand_ms)} steps); trial launches {launches64} (step "
            f"loop trial calls {want64}); {smi}")
        if launches64 != want64:
            raise AssertionError("CTB 64: trial launches != trial calls")
        t0 = time.perf_counter()
        dec64 = decoder.decode_frame(res64.bitstream, device=dev)
        if not np.array_equal(dec64.reconstruction, recon64):
            raise AssertionError("CTB 64: decode != the encoder's "
                                 "reconstruction")
        say(f"decode of the CTB-64 stream: {time.perf_counter() - t0:.3f} "
            f"s, reconstruction identical to the encoder's")

    from context_adaptive_neural_network_based_prediction_tpu_torch.codec \
        import deblock, hm_encoder, sao
    with Phase("15 Annex-B + stock HM"), \
            tempfile.TemporaryDirectory() as tmp:
        # The CTB-32 run is phase 5's crop (phase 4's
        # configuration), to keep the smoke inside its time.
        for what, fr, ctb, rate_evolve, want_modes in (
                (f"{H64}x{W} CTB 64", frame64, 64, False, None),
                (f"{CROP[0]}x{CROP[1]} CTB 32, rate evolution on", crop, 32,
                 True, crop_k[2].mode_map)):
            # The plan is built outside the timed device half, as in
            # phase 4.
            wavefront2._get_plan(*fr.shape, QP, 1.0, ctb, True, rate_evolve,
                                 dev)
            # Each part's seconds, timed around the functions the entry
            # point calls.
            clock = {}
            parts = ((wavefront2, "encode_arrays_wavefront2", "device"),
                     (deblock, "deblock_luma", "deblock"),
                     (sao, "estimate_frame", "sao_estimate"),
                     (sao, "apply_sao", "sao_apply"),
                     (hm_encoder, "assemble_hm_stream", "hm_serialise"))
            originals = [getattr(mod, attr) for mod, attr, _ in parts]

            def clocked(fn, key):
                def call(*args, **kwargs):
                    t = time.perf_counter()
                    out = fn(*args, **kwargs)
                    clock[key] = time.perf_counter() - t
                    return out
                return call

            for (mod, attr, key), fn in zip(parts, originals):
                setattr(mod, attr, clocked(fn, key))
            t0 = time.perf_counter()
            try:
                annexb, res_hm = wavefront2.encode_frame_wavefront2_hm(
                    fr, QP, ctb=ctb, rate_evolve=rate_evolve, device=dev)
            finally:
                for (mod, attr, _), fn in zip(parts, originals):
                    setattr(mod, attr, fn)
            t_all = time.perf_counter() - t0
            if set(clock) != {key for _, _, key in parts}:
                raise AssertionError(f"Annex-B parts not all run: {clock}")
            if want_modes is not None and not np.array_equal(
                    res_hm.mode_map, want_modes):
                raise AssertionError("CTB-32 Annex-B encode: mode map != "
                                     "phase 5's")
            t0 = time.perf_counter()
            out, luma = hm_decode(annexb, *fr.shape, tmp)
            t_hm = time.perf_counter() - t0
            if "(OK)" not in out or not np.array_equal(
                    luma, res_hm.reconstruction):
                raise AssertionError(f"{what}: stock HM's decode differs "
                                     f"or its hash check failed: {out}")
            psnr_hm = 10 * np.log10(255.0 ** 2 / np.mean(
                (res_hm.reconstruction.astype(np.float64) - fr) ** 2))
            say(f"{what} Annex-B (deblocking + SAO): {t_all:.3f} s; "
                + ", ".join(f"{k} {v:.3f} s" for k, v in clock.items())
                + f"; {len(annexb) * 8} bits, PSNR {psnr_hm:.4f} dB; stock "
                f"HM decoded it in {t_hm:.3f} s, hash (OK), reconstruction "
                f"identical" + ("; mode map identical to phase 5's kernel "
                                "path" if want_modes is not None else "")
                + f"; {smi}")

    # ---- phases 16-17: the v1 wavefront and the quantize path ----
    from context_adaptive_neural_network_based_prediction_tpu_torch.codec \
        import nn_intra
    from context_adaptive_neural_network_based_prediction_tpu_torch \
        .evaluation import quantize_golden
    from context_adaptive_neural_network_based_prediction_tpu_torch.ops \
        import v1_step
    from context_adaptive_neural_network_based_prediction_tpu_torch.parallel \
        import wavefront
    with open(os.path.join(REPO, "tests", "golden_torch", "w1.json")) as f:
        golden_v1 = json.load(f)["cases"]
    with Phase("16 v1 wavefront"), tempfile.TemporaryDirectory() as tmp:
        # The v1 step kernel (ops/csrc/v1_step.cu) runs once a step; no
        # other kernel of the port runs here.
        reset_all_counts()
        v1_steps = 0
        for name, g in golden_v1.items():
            if "block_size" not in g or "frames" in g or "loop_filters" in g \
                    or g["frame"]["kind"] == "bench":
                continue
            fr = v1_frame(g["frame"])
            res = wavefront.encode_frame_wavefront(
                fr, g["qp"], block_size=g["block_size"], device=dev)
            _, m1, q1 = wavefront.encode_frames_wavefront_batch(
                fr[None], g["qp"], block_size=g["block_size"], device=dev)
            v1_steps += 2 * v1_n_steps(*fr.shape, g["block_size"])
            got = (sha(res.reconstruction), sha(m1[0].astype(np.int32)),
                   sha(q1[0].astype(np.int32)), sha(res.bitstream))
            if got != (g["recon"], g["modes"], g["qcoeffs"], g["stream"]):
                raise AssertionError(f"v1 {name}: differs from the JAX "
                                     f"package's digests")
        say("v1 small frames (the JAX package's v1 test frames, block sizes "
            "8, 16, 32): recon, modes, levels and stream match w1.json")
        g1 = golden_v1["bench1056x1920_q32_n16"]
        t0 = time.perf_counter()
        plan1, dp1 = wavefront._get_plan(H, W, 16, QP, 1, dev)
        plan4, _ = wavefront._get_plan(H, W, 16, QP, 4, dev)
        say(f"v1 plans (b = 1 and 4): {time.perf_counter() - t0:.2f} s")
        v1_times = {}
        for b, frames_v1 in ((1, frame[None]), (4, frames4)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            recons, modes, qcoeffs = wavefront.encode_frames_wavefront_batch(
                frames_v1, QP, device=dev)
            t_dev1 = time.perf_counter() - t0
            v1_steps += plan1["n_steps"]
            t0 = time.perf_counter()
            results = [wavefront._result(frames_v1[f], QP, 16, recons[f],
                                         modes[f], qcoeffs[f], True)
                       for f in range(b)]
            t_pack1 = time.perf_counter() - t0
            want = ([g1] if b == 1 else
                    golden_v1["bench1056x1920_q32_n16_b4"]["frames"])
            for f, w_ in enumerate(want):
                got = (sha(recons[f]), sha(modes[f].astype(np.int32)),
                       sha(qcoeffs[f].astype(np.int32)))
                if got != (w_["recon"], w_["modes"], w_["qcoeffs"]):
                    raise AssertionError(f"v1 1080p b={b} frame {f}: "
                                         f"differs from w1.json")
            if b == 1 and sha(results[0].bitstream) != g1["stream"]:
                raise AssertionError("v1 1080p stream differs from w1.json")
            if b == 4 and not np.array_equal(recons[0], v1_res.reconstruction):
                raise AssertionError("v1 b=4 frame 0 != its b=1 encode")
            if b == 1:
                v1_res = results[0]
            v1_times[b] = (t_dev1, t_pack1)
            psnr1 = 10 * np.log10(255.0 ** 2 / np.mean(
                (recons[0].astype(np.float64) - frames_v1[0]) ** 2))
            say(f"v1 1080p b={b} (n = 16, QP 32, {plan1['n_steps']} steps, "
                f"{(plan1 if b == 1 else plan4)['b_eff']} slots a step): "
                f"device half {t_dev1:.3f} s = {t_dev1 / b:.4f} s a frame, "
                f"host half (CU trees + native pack) {t_pack1 / b:.4f} s a "
                f"frame; frame 0 PSNR {psnr1:.4f} dB, "
                f"{results[0].num_bits} bits; recon, modes and levels "
                f"match w1.json" + ("; stream too" if b == 1 else
                                    "; frame 0 equals its b=1 encode")
                + f"; {smi}")
        got_counts = read_all_counts()
        want_counts = dict.fromkeys(got_counts, 0)
        want_counts["v1_step"] = v1_steps
        if got_counts != want_counts:
            raise AssertionError(f"v1 launches {got_counts}, want "
                                 f"{want_counts} (one v1 step kernel a step)")
        # The kernel's step at the 1080p frame's middle step, at b = 1 (61
        # slots) and b = 64 (3904 slots, the benchmark cell's batch; the
        # four frames repeated): its aten ops, its time between CUDA
        # events as the host issues it, and queued behind a spin of the
        # card (its device work alone), against the plain `_step` queued
        # on the same state.  A step is idempotent: its blocks read only
        # earlier steps' output.  No profiler here: a profile of a whole
        # v1 run, or of ten steps inside it, left phase 8's kernel
        # profiles without records.
        st_probe = {}
        orig_stepper = wavefront._stepper

        def probing(plan_, dp_, st_):
            step = orig_stepper(plan_, dp_, st_)
            mid_ = plan_["n_steps"] // 2

            def probe_step(t):
                step(t)
                if t == mid_:
                    one = lambda: step(t)
                    plain = lambda: wavefront._step(plan_, dp_, st_, t)
                    st_probe[plan_["n_frames"]] = dict(
                        blocks=v1_step.blocks_on_frame(plan_, t)
                        * plan_["n_frames"], slots=plan_["b_eff"],
                        ops=count_dispatched_ops(one),
                        host_ms=time_launches(one, reps=20),
                        queued_ms=time_queued(one),
                        plain_ms=time_queued(plain, reps=5))
            return probe_step

        frames64 = np.tile(frames4, (16, 1, 1))
        wavefront._stepper = probing
        try:
            for fr64 in (frame[None], frames64):
                wavefront.encode_frames_wavefront_batch(fr64, QP, device=dev)
        finally:
            wavefront._stepper = orig_stepper
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r64, _, _ = wavefront.encode_frames_wavefront_batch(frames64, QP,
                                                            device=dev)
        t_dev64 = time.perf_counter() - t0
        if not np.array_equal(r64[4], recons[0]):
            raise AssertionError("v1 b=64 frame 4 != its b=4 encode")
        step_ms = 1e3 * v1_times[1][0] / plan1["n_steps"]
        for b, pr in sorted(st_probe.items()):
            # int32 operations: 35 modes x 4 n^3 multiply-adds a block.
            bound_ms = 1e3 * pr["blocks"] * 35 * 4 * 16 ** 3 * 2 / 33.45e12
            say(f"v1 step kernel, 1080p step {plan1['n_steps'] // 2}, b={b} "
                f"({pr['blocks']} blocks of {pr['slots']} slots): "
                f"{pr['ops']} aten ops, {pr['host_ms']:.4f} ms between CUDA "
                f"events as the host issues it, {pr['queued_ms']:.4f} ms "
                f"queued (bound {bound_ms:.4f} ms, int32 operations); the "
                f"plain step {pr['plain_ms']:.4f} ms queued"
                + (f"; a step of the b=1 device half {step_ms:.4f} ms"
                   if b == 1 else f"; b=64 device half {t_dev64:.3f} s = "
                   f"{1e3 * t_dev64 / 64:.3f} ms a frame, frame 4 equal to "
                   f"its b=4 encode") + f"; {smi}")
        t0 = time.perf_counter()
        dec_v1 = decoder.decode_frame(v1_res.bitstream, device=dev)
        if not np.array_equal(dec_v1.reconstruction, v1_res.reconstruction):
            raise AssertionError("v1 1080p: decode != the encoder's "
                                 "reconstruction")
        say(f"decode of the v1 1080p stream: {time.perf_counter() - t0:.3f} "
            f"s, reconstruction identical to the encoder's")
        t0 = time.perf_counter()
        annexb_v1, res_hm_v1 = wavefront.encode_frame_wavefront_hm(
            frame, QP, device=dev)
        t_hm_enc = time.perf_counter() - t0
        h_lf = golden_v1["bench1056x1920_q32_hm_lf"]
        if (sha(annexb_v1), sha(res_hm_v1.reconstruction)) != (
                h_lf["stream"], h_lf["recon"]):
            raise AssertionError("v1 Annex-B 1080p: differs from w1.json")
        t0 = time.perf_counter()
        out, luma = hm_decode(annexb_v1, H, W, tmp)
        if "(OK)" not in out or not np.array_equal(
                luma, res_hm_v1.reconstruction):
            raise AssertionError(f"v1 Annex-B: stock HM's decode differs or "
                                 f"its hash check failed: {out}")
        say(f"v1 1080p Annex-B (CTB 16, deblocking + SAO): {t_hm_enc:.3f} s,"
            f" {len(annexb_v1) * 8} bits, stream and final reconstruction "
            f"match w1.json; stock HM decoded it in "
            f"{time.perf_counter() - t0:.3f} s, hash (OK), reconstruction "
            f"identical; {smi}")

    with Phase("17 quantize"):
        golden_q = quantize_golden.load(REPO)
        with open(MEAN_PKL, "rb") as f:
            mean_q = float(pickle.load(f))
        quantized, q_inputs, q_launches, q_models = {}, {}, {}, {}
        # Every FC layer and float merger call of the quantize runs is
        # kept, held against its plain version after the run, and the first
        # of each shape is phase 8's input for its row.
        orig_qfc, orig_qfm = fc_forward.fc_forward, merger.merger_forward
        q_calls = []

        def capture_qfc(x, weights, biases, impl="kernel"):
            q_calls.append(("fc", x.clone(), weights, biases, False))
            return orig_qfc(x, weights, biases, impl=impl)

        def capture_qfm(x, w, b, act=False, impl="kernel"):
            q_calls.append(("fmerger", x.clone(), w, b, act))
            return orig_qfm(x, w, b, act=act, impl=impl)

        reset_all_counts()
        for name in QUANTIZE_MODELS:
            fc_forward.reset_launch_counts()
            merger.reset_launch_counts()
            q_calls.clear()
            fc_forward.fc_forward = capture_qfc
            merger.merger_forward = capture_qfm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                q = quantize_golden.quantize(golden_q, name, dev)
                torch.cuda.synchronize()
            finally:
                fc_forward.fc_forward = orig_qfc
                merger.merger_forward = orig_qfm
            t_q = time.perf_counter() - t0
            launched = {("fc", k): v for k, v in fc_forward.launches.items()}
            launched.update({("merger", k): v
                             for k, v in merger.launches.items()})
            rep = quantize_golden.compare(golden_q, name, q, 1e-4)
            want_launches = 3 if "_fc_" in name else 1
            if not quantize_golden.within(rep, 1e-4) or sum(
                    launched.values()) != want_launches:
                raise AssertionError(f"quantize {name}: {rep}, kernel "
                                     f"launches {launched}")
            for (op, size), v in launched.items():
                key = ("fc", size[0]) if op == "fc" else ("fmerger", size)
                q_launches[key] = q_launches.get(key, 0) + v
            errs = []
            for op, x, ws, bs, act in q_calls:
                if op == "fc":
                    call = lambda impl: orig_qfc(x, ws, bs, impl=impl)
                    key, tol = ("fc", ws[0].shape[0]), 1e-4
                else:
                    call = lambda impl: orig_qfm(x, ws, bs, act=act,
                                                 impl=impl)
                    key, tol = ("fmerger", x.shape[2]), 1e-5
                errs.append(check_close(call("kernel"), call("plain"), tol,
                                        f"quantize {name} {key}"))
                q_inputs.setdefault(key, (x, ws, bs, act))
            say(f"quantize {name} (n_samples 256, float forward on the "
                f"card): {t_q:.3f} s; weights and caps equal the JAX "
                f"package's, scales within {rep['max_rel']:.2e} relative, "
                f"biases within {rep['max_bias_diff']}; kernel launches "
                f"{launched}, each call against its plain version within "
                f"{max(errs):.2e} of max |plain|")
            if name in QUANTIZE_SWITCH:
                quantized[QUANTIZE_SWITCH[name]] = q
            q_models[name] = q
        save_quantized_checks(q_models)
        frame_q = golden_frames()["natural128"]
        bundle_q = nn_intra.PnnBundle(quantized, mean_q)
        reset_all_counts()
        t0 = time.perf_counter()
        res_q = wavefront2.encode_frame_wavefront2(
            frame_q, QP, policy="switch", pnn=bundle_q, rate_evolve=True,
            device=dev)
        t_q_enc = time.perf_counter() - t0
        got_counts = read_all_counts()
        if not (got_counts["unit_trial"] and got_counts["merger_int"]):
            raise AssertionError(f"switch with the port-quantized zoo: "
                                 f"kernel launches {got_counts}")
        dec_q = decoder.decode_frame(res_q.bitstream, pnn=bundle_q,
                                     device=dev)
        if not np.array_equal(dec_q.reconstruction, res_q.reconstruction):
            raise AssertionError("switch with the port-quantized zoo: "
                                 "decode != the encoder's reconstruction")
        say(f"128x128 switch encode with the port-quantized singles "
            f"(w4/w8 refconv, w16, w32): {t_q_enc:.3f} s, "
            f"{res_q.num_bits} bits, "
            f"{pnn_pus(res_q.ctu_trees, 'switch', [4, 8, 16, 32])} "
            f"PNN-coded PUs, kernel launches {got_counts}; the port's "
            f"decoder gives the reconstruction back")

    # ---- phase 9 (before 8): the float prediction path ----
    from context_adaptive_neural_network_based_prediction_tpu_torch \
        .evaluation import float_golden, prediction_comparison
    from context_adaptive_neural_network_based_prediction_tpu_torch.models \
        import zoo

    orig_fc, orig_fmerger = fc_forward.fc_forward, merger.merger_forward

    def capture_fc(x, weights, biases, impl="kernel"):
        key = ("fc", x.shape[1])        # one path input set per width
        if key not in captured:
            captured[key] = (x.clone(), weights, biases)
        return orig_fc(x, weights, biases, impl=impl)

    def capture_fmerger(x, w, b, act=False, impl="kernel"):
        key = ("fmerger", x.shape[2])   # one path input set per M
        if key not in captured:
            captured[key] = (x.clone(), w, b, act)
        return orig_fmerger(x, w, b, act=act, impl=impl)

    float_launches, float_seconds = {}, {}
    with Phase("9 float path"):
        golden = float_golden.load(REPO)
        for key, err in float_golden.check_pallas(golden, dev).items():
            tol = 1e-4 if key.startswith("fc") else 1e-5
            if not err <= tol:
                raise AssertionError(f"{key}: bf16 kernel differs from the "
                                     f"JAX package's Pallas kernel by {err}")
            say(f"{key} (bf16 weights) vs the JAX package's Pallas kernel "
                f"(interpret mode): {err:.2e} of max |Pallas|")
        luma = frame[None, :, :, None]
        with open(MEAN_PKL, "rb") as f:
            mean = float(pickle.load(f))
        for name in float_golden.MODELS:
            rep = float_golden.check_model(golden, name, dev)
            cmp = float_golden.check_comparison(golden, name, dev)
            if not (rep["contexts_equal"] and rep["forward_rel_err"] <= 1e-4
                    and cmp["max_psnr_diff"] <= 0.01
                    and cmp["max_win_diff"] <= 2 / cmp["n"]):
                raise AssertionError(f"{name}: differs from the JAX "
                                     f"package's goldens: {rep}, {cmp}")
            say(f"{name}: natural frame vs the JAX package's goldens: masked "
                f"contexts equal, forward {rep['forward_rel_err']:.2e} of max "
                f"|JAX|, comparison rows within {cmp['max_psnr_diff']:.2e} dB"
                f" and {cmp['max_win_diff']:.4f} win frequency")
            w = float_golden.model_width(name)
            params, is_fc = zoo.load_frozen_params(os.path.join(
                REPO, "artifacts", "frozen", name + ".npz"))
            torch.cuda.synchronize()
            fc_forward.reset_launch_counts()
            merger.reset_launch_counts()
            fc_forward.fc_forward = capture_fc
            merger.merger_forward = capture_fmerger
            t0 = time.perf_counter()
            try:
                rows = prediction_comparison.compare_on_channels(
                    luma, w, params, is_fc, mean,
                    nb_positions_per_image=FLOAT_POSITIONS, device=dev)
                torch.cuda.synchronize()
            finally:
                fc_forward.fc_forward = orig_fc
                merger.merger_forward = orig_fmerger
            float_seconds[name] = time.perf_counter() - t0
            got = {("fc", k): v for k, v in fc_forward.launches.items()}
            got.update({("merger", k): v
                        for k, v in merger.launches.items()})
            want = {k: v * len(prediction_comparison.DEFAULT_VAL_MASKS)
                    for k, v in float_golden.forward_launches(
                        name, FLOAT_POSITIONS).items()}
            float_launches[name] = got
            if got != want:
                raise AssertionError(f"{name}: kernel launches {got} != the "
                                     f"forwards' chunk calls {want}")
            for r in rows:
                vals = (r.mean_psnr_pnn, r.mean_psnr_hevc_best,
                        r.pnn_win_frequency)
                if not (np.all(np.isfinite(vals)) and 10 < vals[0] < 60
                        and 10 < vals[1] < 60 and 0 <= vals[2] <= 1):
                    raise AssertionError(f"{name}: implausible row {r}")
                say(f"{name} 1080p masks ({r.width_mask_above}, "
                    f"{r.height_mask_left}): PNN {r.mean_psnr_pnn:.4f} dB, "
                    f"best HEVC {r.mean_psnr_hevc_best:.4f} dB, PNN wins "
                    f"{r.pnn_win_frequency:.4f}")
            say(f"{name} 1080p compare_on_channels: "
                f"{float_seconds[name]:.3f} s, {FLOAT_POSITIONS} positions x "
                f"{len(rows)} masks, kernel launches {got} (the forwards' "
                f"chunk calls)")
            busy_ms, top = device_breakdown(
                lambda: prediction_comparison.compare_on_channels(
                    luma, w, params, is_fc, mean,
                    nb_positions_per_image=FLOAT_POSITIONS, device=dev))
            say(f"{name} 1080p compare_on_channels under the profiler: "
                f"device busy {busy_ms} ms; by time: {top}")

    # ---- phase 18 (before 8): the host RDO codec ----
    with Phase("18 host codec"):
        host_launches = host_codec_phase(dev, smi, captured)

    # ---- phase 19 (before 8): PNN training end to end ----
    with Phase("19 training"):
        training_phase(dev, smi)

    # ---- phase 20 (before 8): two ranks on the card ----
    with Phase("20 multi-rank"):
        multi_rank_phase(dev, smi)

    # ---- phase 8: per-kernel numbers at the main paths' shapes ----
    with Phase("8 kernel timing"):
        rows = []

        def trial_row(name, n, slots, n_launches, what):
            tc, args = captured[(n, slots)]
            call = lambda impl: unit_fused.trial_apply(tc, *args, impl=impl)
            got, want = call("kernel"), call("plain")
            assert_equal(got, want, f"{what} inputs n={n}")
            bound_ms, bound_by, route = trial_bound_ms(tc, args, int_ops,
                                                       f64_ops)
            rows.append(kernel_row(
                name, SOURCE, REPLACES[n], n_launches,
                max_abs_err(got, want), lambda: call("kernel"),
                lambda: call("plain"), bound_ms, bound_by, None,
                TRIAL_KERNELS[n]))
            rows[-1]["bound_route"] = route

        def merger_row(name, m, slots, n_launches, what):
            x, w, bb = captured[("merger", m, slots)]
            call = lambda impl: merger_int.merger_int_forward(x, w, bb,
                                                              impl=impl)
            got, want = call("kernel"), call("plain")
            assert_equal(got, want, f"{what} inputs M={m}")
            xm = x.permute(2, 0, 1).to(torch.float64).contiguous()
            wm = w.permute(2, 0, 1).to(torch.float64).contiguous()
            lib = torch.bmm(xm, wm) + bb.T.to(torch.float64)[:, None, :]
            if not torch.equal(lib.to(torch.int32), want):
                raise AssertionError(f"fp64 bmm != merger at M={m}")
            bound_ms, bound_by = merger_bound_ms(x, w, bb, int_ops)
            rows.append(kernel_row(
                name, MERGER_SOURCE, MERGER_REPLACES, n_launches,
                max_abs_err([got], [want]), lambda: call("kernel"),
                lambda: call("plain"), bound_ms, bound_by,
                lambda: torch.bmm(xm, wm), ("merger_int_vec_kernel",)))

        b1 = plan["b_eff"]
        for n in (4, 8, 16, 32):
            trial_row(f"unit_trial_n{n}", n, b1, launches[n], "phase-4")
        for n, m in NN_MAPS.items():
            merger_row(f"merger_int_m{m}", m, b1, sw_mergers[m], "phase-6")
        rows += float_kernel_rows(captured, float_launches, q_inputs,
                                  q_launches, dev, host_launches)
        # The batched paths' shapes: the trial at b_eff = 4 x 31 slots
        # (phase 10), the merger at N = 124 (phase 11) and at N = 1 (the
        # decoder, phase 13).
        for n in (4, 8, 16, 32):
            trial_row(f"unit_trial_n{n}_b{4 * b1}", n, 4 * b1, b4_trials[n],
                      "phase-10")
        for n, m in NN_MAPS.items():
            merger_row(f"merger_int_m{m}_n{4 * b1}", m, 4 * b1,
                       sw4_mergers[m], "phase-11")
        # CTB 64 (phase 14): the trial at 16 slots.
        for n in (4, 8, 16, 32):
            trial_row(f"unit_trial_n{n}_ctb64", n, plan64["b_eff"],
                      launches64[n], "phase-14")
        for m in NN_MAPS.values():
            if ("merger", m, 1) in captured:
                merger_row(f"merger_int_m{m}_n1_decoder", m, 1,
                           decode_mergers.get(m, 0), "phase-13")
        # The host RDO encoder's w64 forwards (phase 18): M = 512, N = 1.
        merger_row("merger_int_m512_n1_host", 512, 1,
                   host_launches["merger_int_m512_n1_host"], "phase-18")
        with tempfile.TemporaryDirectory() as tmp:
            for case, (us, dev_us) in kernel_variants.empty_floor(
                    dev, tmp).items():
                say(f"empty launch (ctypes, 31 blocks x 256 threads), {case}:"
                    f" queued {us[0]:.4f} / {us[1]:.4f} us, on the card "
                    f"{dev_us[0]} / {dev_us[1]} us (latency floor) on {smi}")
        for r in rows:
            route = f" ({r['bound_route']})" if "bound_route" in r else ""
            say(f"{r['name']}: {r['launches']} launches, {r['ms']:.4f} ms "
                f"per call (queued {r['queued_ms']:.4f} ms; kernels on the "
                f"card {r['device_ms']} ms; plain {r['plain_ms']:.4f} ms, "
                f"bound {r['bound_ms']:.6f} ms by {r['bound_by']}{route}, "
                f"library {r['library_ms']} ms, queued "
                f"{r['library_queued_ms']} ms) on {smi}")
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
        # Busy shares, each printed where the profiler kept every row it
        # reads (it drops a session's records now and then).
        named = {r["name"]: r for r in rows}

        def busy(names, counts):
            pairs = [(named[name], counts[key]) for name, key in names]
            if any(r["device_ms"] is None for r, _ in pairs):
                return None
            return sum(r["device_ms"] * k for r, k in pairs) / 1e3

        def trials(suffix=""):
            return [(f"unit_trial_n{n}{suffix}", n) for n in (4, 8, 16, 32)]

        def mergers(suffix=""):
            return [(f"merger_int_m{m}{suffix}", m) for m in NN_MAPS.values()]

        busy_t, sw_t = busy(trials(), launches), busy(trials(), sw_trials)
        busy_m = busy(mergers(), sw_mergers)
        busy_t4 = busy(trials(f"_b{4 * b1}"), b4_trials)
        busy_m4 = busy(mergers(f"_n{4 * b1}"), sw4_mergers)
        if busy_t is not None:
            say(f"1080p kernel path: trial kernels busy {busy_t:.3f} s of "
                f"the {t_dev:.3f} s device half "
                f"({100 * busy_t / t_dev:.1f}%)")
        if sw_t is not None and busy_m is not None:
            say(f"1080p switch kernel path: trial kernels busy {sw_t:.3f} s,"
                f" merger kernels {busy_m:.3f} s of the {t_dev_s:.3f} s "
                f"device half ({100 * (sw_t + busy_m) / t_dev_s:.1f}%)")
        if busy_t4 is not None:
            say(f"1080p regular b=4: trial kernels busy {busy_t4:.3f} s of "
                f"the {t_dev4:.3f} s device half "
                f"({100 * busy_t4 / t_dev4:.1f}%)")
        if busy_m4 is not None:
            say(f"1080p switch b=4: merger kernels busy {busy_m4:.3f} s of "
                f"the {t_dev_s4:.3f} s device half "
                f"({100 * busy_m4 / t_dev_s4:.1f}%)")
        for r in rows[8:]:
            if r["name"].endswith("_path") and r["device_ms"] is not None:
                calls = r["launches"] // r["launches_per_call"]
                say(f"{r['name']}: kernels busy "
                    f"{r['device_ms'] * calls / 1e3:.4f} s of the 1080p "
                    f"comparison ({calls} calls)")
    for name, sec in float_seconds.items():
        say(f"float path {name}: 1080p compare_on_channels {sec:.3f} s")
    for r in rows:
        r.pop("launches_per_call", None)
    say(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
    say(json.dumps({"kernels": rows}))
    say(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def training_phase(dev, smi, *, batch=TRAIN_BATCH, chunk=TRAIN_CHUNK,
                   w64_steps=W64_STEPS, n_contexts=TRAIN_CONTEXTS):
    """Phase 19, PNN training end to end on `dev`: the shipped crop shard
    through `TrainingPipeline` (on-the-fly extraction, seed 0), the w8 FC
    and w16 conv PNNs trained in two `train_chunk`s with random masks (the
    schedule's boundaries at 25, 37 and 43 of `2 * chunk` iterations), a
    checkpoint after the first chunk restored and its second chunk held
    equal to the uninterrupted run bit for bit, the first step's loss and
    gradients held against the same step on the CPU in float64 (float32
    gradients of sums over 1e5 positions cancel, so the CPU's float32 step
    is no tight reference);
    `w64_steps` steps of
    the w64 conv PNN (timing); then both trained models frozen
    (`export_pnn.freeze_checkpoint`), loaded back (`zoo.load_frozen_params`),
    run by `predict_by_batch` on `n_contexts` contexts through kernels 4
    and 5 (every call against its plain version, launches counted),
    quantized (`PnnBundle.quantize`), and a switch encode of the 128x128
    natural frame with them (w4 and w32 from artifacts/frozen) decoded
    back by the port's decoder.  Training itself launches no kernel of the
    port.  On a card every kernel of the path must have launched."""
    import torch

    from context_adaptive_neural_network_based_prediction_tpu_torch.cli \
        import export_pnn
    from context_adaptive_neural_network_based_prediction_tpu_torch.codec \
        import decoder, nn_intra
    from context_adaptive_neural_network_based_prediction_tpu_torch.data \
        import datasets, masking
    from context_adaptive_neural_network_based_prediction_tpu_torch.data \
        .pipeline import TrainingPipeline
    from context_adaptive_neural_network_based_prediction_tpu_torch.models \
        import pnn, training, zoo
    from context_adaptive_neural_network_based_prediction_tpu_torch.ops \
        import fc_forward, merger
    from context_adaptive_neural_network_based_prediction_tpu_torch.parallel \
        import wavefront2

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    mean = datasets.load_mean_training(MEAN_PKL)
    total = 2 * chunk
    frozen = {}
    tmp = tempfile.mkdtemp(prefix="train_")
    try:
        shards = os.path.join(tmp, "shards", "thread_0")
        os.makedirs(shards)
        os.symlink(TRAIN_SHARD, os.path.join(shards, "data_1.npz"))
        for w, fc in ((8, True), (16, False), (64, False)):
            name = f"w{w} {'fc' if fc else 'conv'}"
            steps = w64_steps if w == 64 else total
            pipe = TrainingPipeline(os.path.dirname(shards), batch, w,
                                    is_extraction_on_the_fly=True, seed=0)
            it = pipe.batches()
            t0 = time.perf_counter()
            bs = [next(it) for _ in range(steps)]
            stacked = [np.stack([b[i] for b in bs]) for i in range(3)]
            t_pipe = time.perf_counter() - t0
            kw = dict(width_target=w, is_fully_connected=fc, coeff_l2=1.0,
                      coeff_grad=0.0, random_masks=True, total_iters=total)
            init = lambda d: training.init_state(
                torch.Generator().manual_seed(0), w, fc, total_iters=total,
                device=d)
            gen = torch.Generator().manual_seed(1)
            reset_all_counts()
            if w == 64:
                state = init(dev)
                sync()
                t0 = time.perf_counter()
                state, losses = training.train_chunk(
                    state, gen, *stacked, mean, (0, 0), **kw)
                sync()
                sec = time.perf_counter() - t0
                if not torch.isfinite(losses).all() or any(
                        read_all_counts().values()):
                    raise AssertionError(f"{name}: losses {losses}, kernel "
                                         f"launches {read_all_counts()}")
                say(f"train {name} (512 maps), batch {batch}: {steps} steps "
                    f"in {sec:.3f} s = {sec / steps:.4f} s/step (the first "
                    f"included); loss {float(losses[0]):.2f} -> "
                    f"{float(losses[-1]):.2f}; {smi}")
                continue
            # The first step on the card against the same step on the CPU
            # in float64 (same init, batch and masks: the generator's first
            # draw).  Per leaf, relative to its max |g|: a LeakyReLU input
            # within rounding of 0 that takes the other slope moves the
            # gradients of its map's params by up to 0.9 of that unit's
            # share, hence the 98% and the 5e-2.
            wa, hl = training.draw_masks(torch.Generator().manual_seed(1),
                                         batch, w)
            step = lambda params: training.loss_and_grads(
                params, *bs[0], mean, wa, hl, width_target=w,
                is_fully_connected=fc, coeff_l2=1.0, coeff_grad=0.0)
            with training.exact_steps():
                l_ref, _, g_ref = step(training.tree_map(
                    torch.Tensor.double, init("cpu").params))
                l_dev, _, g_dev = step(init(dev).params)
            loss_err = abs(float(l_dev) - float(l_ref)) / abs(float(l_ref))
            g_dev = dict(_leaves(g_dev))
            worst, share = 0.0, 1.0
            for k, want in _leaves(g_ref):
                err = ((g_dev[k].cpu().double() - want).abs()
                       / want.abs().max()).numpy()
                worst = max(worst, float(err.max()))
                share = min(share, float(np.mean(err <= 1e-4)))
            if not (loss_err <= 1e-5 and share >= 0.98 and worst <= 5e-2):
                raise AssertionError(
                    f"{name}: first step on {dev} vs float64 on the CPU: "
                    f"loss {loss_err:.2e} relative, gradients within 1e-4 of "
                    f"max |g| in {share:.4f} of a leaf, worst {worst:.2e}")
            state = init(dev)
            sync()
            t0 = time.perf_counter()
            state, l1 = training.train_chunk(
                state, gen, *(a[:chunk] for a in stacked), mean, (0, 0),
                **kw)
            sync()
            t1 = time.perf_counter()
            ckpt = training.save_checkpoint(state, os.path.join(tmp, name),
                                            gen)
            t2 = time.perf_counter()
            state, l2 = training.train_chunk(
                state, gen, *(a[chunk:] for a in stacked), mean, (0, 0),
                **kw)
            sync()
            t3 = time.perf_counter()
            gen_r = torch.Generator()
            resumed = training.restore_checkpoint(ckpt, w, device=dev,
                                                  generator=gen_r)
            t4 = time.perf_counter()
            resumed, l2r = training.train_chunk(
                resumed, gen_r, *(a[chunk:] for a in stacked), mean, (0, 0),
                **kw)
            sync()
            counts = read_all_counts()
            same = torch.equal(l2, l2r) and all(
                torch.equal(x, y) for tree in (
                    lambda s: s.params, lambda s: s.opt_state[0].mu,
                    lambda s: s.opt_state[0].nu)
                for (_, x), (_, y) in zip(sorted(_leaves(tree(state))),
                                          sorted(_leaves(tree(resumed)))))
            losses = torch.cat([l1, l2]).cpu().numpy()
            if not same or any(counts.values()):
                raise AssertionError(f"{name}: resumed run differs from the "
                                     f"uninterrupted one ({same}) or kernel "
                                     f"launches {counts}")
            if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]
                    and float(l1[0]) == float(l_dev)):
                raise AssertionError(f"{name}: losses {losses}")
            say(f"train {name}, batch {batch}, random masks, LR boundaries "
                f"at {total // 2}, {3 * total // 4}, {7 * total // 8}: "
                f"pipeline {t_pipe:.3f} s for {steps} batches; chunk 1 "
                f"{(t1 - t0) / chunk:.4f} s/step (first step included), "
                f"chunk 2 {(t3 - t2) / chunk:.4f} s/step; loss at steps 1, "
                f"{chunk}, {total}: {losses[0]:.3f}, {losses[chunk - 1]:.3f}"
                f", {losses[-1]:.3f}; checkpoint at {chunk} ({t2 - t1:.3f} s"
                f" to write, {t4 - t3:.3f} s to restore) resumed: chunk 2 "
                f"equal bit for bit (params, Adam moments, losses); first "
                f"step vs float64 on the CPU: loss {loss_err:.2e} relative, "
                f"gradients within 1e-4 of a leaf's max |g| in at least "
                f"{share:.4f} of its entries, worst {worst:.2e}; no kernel "
                f"launched; {smi}")
            path = training.save_checkpoint(state, os.path.join(tmp, name))
            npz = os.path.join(tmp, "frozen", f"pnn_w{w}.npz")
            export_pnn.freeze_checkpoint(path, npz)
            frozen[w] = zoo.load_frozen_params(npz)

        # Serve: the frozen models' forward through kernels 4 and 5, on
        # contexts of the shard with the left mask at w.
        calls = []
        orig_fc, orig_fm = fc_forward.fc_forward, merger.merger_forward

        def keep_fc(x, weights, biases, impl="kernel"):
            calls.append(("fc", x.clone(), weights, biases, False))
            return orig_fc(x, weights, biases, impl=impl)

        def keep_fm(x, w_, b, act=False, impl="kernel"):
            calls.append(("fmerger", x.clone(), w_, b, act))
            return orig_fm(x, w_, b, act=act, impl=impl)

        for w, (params, fc) in frozen.items():
            a, l, t = next(TrainingPipeline(
                os.path.dirname(shards), n_contexts, w,
                is_extraction_on_the_fly=True, seed=1).batches())
            pre = masking.preprocess_context_portions_targets(
                a, l, t, mean, (0, w), fc)
            inputs = pre[0] if fc else (pre[0], pre[1])
            tparams = zoo.params_from_numpy(params, dev)
            calls.clear()
            reset_all_counts()
            fc_forward.fc_forward, merger.merger_forward = keep_fc, keep_fm
            sync()
            t0 = time.perf_counter()
            try:
                pred = zoo.predict_by_batch(tparams, inputs, w, fc)
            finally:
                fc_forward.fc_forward, merger.merger_forward = (orig_fc,
                                                                orig_fm)
            sec = time.perf_counter() - t0
            counts = read_all_counts()
            want = {"fc_forward": 4 if fc else 0, "merger": 0 if fc else 1}
            if on_card and any(counts[k] != v for k, v in want.items()):
                raise AssertionError(f"w{w} forward: launches {counts}")
            errs = []
            for op, x, ws, bs_, act in calls:
                if op == "fc":
                    call = lambda impl: orig_fc(x, ws, bs_, impl=impl)
                else:
                    call = lambda impl: orig_fm(x, ws, bs_, act=act,
                                                impl=impl)
                errs.append(check_close(call("kernel"), call("plain"),
                                        1e-4 if op == "fc" else 1e-5,
                                        f"trained w{w} {op}"))
            with torch.no_grad():
                x = (torch.from_numpy(inputs).to(dev) if fc else tuple(
                    torch.from_numpy(v).to(dev) for v in inputs))
                plain = pnn.forward_train(tparams, x, w, fc)
            err = check_close(torch.from_numpy(pred), plain.cpu(), 1e-4,
                              f"trained w{w} forward")
            if not np.all(np.isfinite(pred)) or pred.shape != (
                    n_contexts, w, w, 1):
                raise AssertionError(f"w{w} forward: {pred.shape}")
            say(f"trained w{w} frozen and reloaded: predict_by_batch on "
                f"{n_contexts} contexts {sec:.4f} s, kernel launches "
                f"{counts}, each call against its plain version within "
                f"{max(errs):.2e} of max |plain|, the whole forward within "
                f"{err:.2e} of the plain chain")

        # Quantize the trained models and encode with them.
        reset_all_counts()
        t0 = time.perf_counter()
        trained = nn_intra.PnnBundle(
            None, mean, params={w: p for w, (p, _) in frozen.items()}).quantize(
            device=dev)
        sync()
        t_q = time.perf_counter() - t0
        q_counts = read_all_counts()
        if on_card and not (q_counts["fc_forward"] and q_counts["merger"]):
            raise AssertionError(f"quantize: launches {q_counts}")
        rest = zoo.load_quantized_bundle(MANIFEST, mean, use_pair=False,
                                         widths=(4, 32))
        bundle = nn_intra.PnnBundle({**rest.quantized, **trained.quantized},
                                    mean)
        frame = golden_frames()["natural128"]
        reset_all_counts()
        t0 = time.perf_counter()
        res = wavefront2.encode_frame_wavefront2(
            frame, QP, policy="switch", pnn=bundle, rate_evolve=True,
            device=dev)
        t_enc = time.perf_counter() - t0
        e_counts = read_all_counts()
        if on_card and not (e_counts["unit_trial"]
                            and e_counts["merger_int"]):
            raise AssertionError(f"switch encode: launches {e_counts}")
        dec = decoder.decode_frame(res.bitstream, pnn=bundle, device=dev)
        if not np.array_equal(dec.reconstruction, res.reconstruction):
            raise AssertionError("switch encode with the trained models: "
                                 "decode != the encoder's reconstruction")
        kinds = {w: str(np.asarray(q["kind"]))
                 for w, q in sorted(bundle.quantized.items())}
        say(f"trained w8 FC and w16 conv quantized in {t_q:.3f} s (kernel "
            f"launches {q_counts}); 128x128 switch encode with them (w4, "
            f"w32 frozen; kinds {kinds}): {t_enc:.3f} s, {res.num_bits} bits,"
            f" {pnn_pus(res.ctu_trees, 'switch', [4, 8, 16, 32])} PNN-coded "
            f"PUs, kernel launches {e_counts}; the port's decoder gives the "
            f"reconstruction back")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def tree_digest(trees):
    """sha256 of the CU trees (splits, PU modes, TU flags and levels): the
    decided grids of an `EncodeResult`."""
    h = hashlib.sha256()
    stack = list(reversed(trees))
    while stack:
        nd = stack.pop()
        h.update(repr((nd.x, nd.y, nd.size, nd.depth, bool(nd.split),
                       bool(nd.part_nxn))).encode())
        for pu in nd.pus:
            h.update(repr((pu.x, pu.y, pu.n, int(pu.mode))).encode())
            for tu in pu.tus:
                h.update(repr((tu.x, tu.y, tu.n, tu.cbf)).encode())
                if tu.coeffs is not None:
                    h.update(np.asarray(tu.coeffs, np.int32).tobytes())
        stack.extend(reversed(nd.children))
    return h.hexdigest()


def multi_rank_phase(dev, smi, *, h=H64, w=W, switch_crop=SWITCH_CROP,
                     batch=TRAIN_BATCH, steps=SHARD_STEPS):
    """Phase 20, the multi-rank paths on `dev`.  First this process runs
    the single-device references alone on `dev`; then `RANKS` ranks of one
    Gloo group on the card (`parallel/mesh.spawn_ranks`, one `spawn`
    process each; they load the kernels phase 1 built and build none) run,
    in one group, (a) `encode_frame_tiled_halo_v2`, regular, QP 32, NxN
    on, rate evolution off, on the frame's top h x w (1024 x 1920: stripes
    of 16 CTB rows); (b) the same under switch with the frozen singles zoo
    on the top-left `switch_crop`; (c) the v1 `encode_frame_tiled_halo` at
    block size 16 on the h x w crop, and `encode_frame_tiled`; (d) the
    sharded training chunk of `steps` steps at `batch` from the shipped
    crop shard, w8 FC at dp = 2 and w16 conv at tp = 2: in float32, its
    first step alone in float32, and in float64.  Checks: (a), (b)
    reconstruction, CU trees (every decided grid), mode map and stream
    equal to one device on every rank, each rank's trial launches (a, b)
    and integer merger launches (b) nonzero on a card; (c) the halo
    encode's reconstruction and modes equal `encode_frame_wavefront`'s;
    (d) the float32 losses within 1e-5 relative of the single-device
    chunk's at every step; the first step's gradients, sharded and
    single-device, against float64 on `dev` as phase 19 holds them (per
    leaf 98% within 1e-4 of its max |g|, all within 5e-2); and after the
    float64 chunks the parameters and both Adam moments within 1e-5 of
    each leaf's max |value| at every entry (float32's state after
    `steps` steps is printed, not held: Adam turns float32 gradients
    summed in another order into update differences past 1e-5).  A
    rank's failure or the group's timeout fails the phase.  Returns the
    seconds."""
    import torch

    from context_adaptive_neural_network_based_prediction_tpu_torch import (
        _build_dir)
    from context_adaptive_neural_network_based_prediction_tpu_torch.data \
        import datasets
    from context_adaptive_neural_network_based_prediction_tpu_torch.data \
        .pipeline import TrainingPipeline
    from context_adaptive_neural_network_based_prediction_tpu_torch.models \
        import training, zoo
    from context_adaptive_neural_network_based_prediction_tpu_torch.parallel \
        import mesh, sharded_training, tiled, wavefront, wavefront2

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    rank_dev = "cuda" if on_card else "cpu"
    t_phase = time.perf_counter()
    frame = bench_frame()[:h, :w]
    sw_frame = bench_frame()[:switch_crop[0], :switch_crop[1]]
    zoo_s = nn_bundles()["frozen_singles"]
    mean = datasets.load_mean_training(MEAN_PKL)
    tmp = tempfile.mkdtemp(prefix="ranks_")
    try:
        shards = os.path.join(tmp, "shards", "thread_0")
        os.makedirs(shards)
        os.symlink(TRAIN_SHARD, os.path.join(shards, "data_1.npz"))
        train = {}
        for wt, fc, axis in ((8, True, {"data": RANKS, "model": 1}),
                             (16, False, {"data": 1, "model": RANKS})):
            it = TrainingPipeline(os.path.dirname(shards), batch, wt,
                                  is_extraction_on_the_fly=True,
                                  seed=0).batches()
            bs = [next(it) for _ in range(steps)]
            stacked = [np.stack([b[i] for b in bs]) for i in range(3)]
            state = training.init_state(torch.Generator().manual_seed(0),
                                        wt, fc, device="cpu")
            gen = torch.Generator().manual_seed(1)
            train[wt] = (fc, axis, training.state_to_numpy(state),
                         gen.get_state().numpy(), stacked)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # The single-device references, alone on the card.
    refs = {}
    for what, fr, policy, pnn in (("a", frame, "regular", None),
                                  ("b", sw_frame, "switch", zoo_s)):
        sync()
        t0 = time.perf_counter()
        single = wavefront2.encode_frame_wavefront2(fr, QP, policy=policy,
                                                    pnn=pnn, device=dev)
        sync()
        refs[what] = (single, time.perf_counter() - t0)
    t0 = time.perf_counter()
    v1 = wavefront.encode_frame_wavefront(frame, QP, block_size=V1_BLOCK,
                                          serialize=False, device=dev)
    sync()
    refs["c"] = (v1, time.perf_counter() - t0)
    for wt in (8, 16):
        fc, axis, blob, gstate, stacked = train[wt]
        gen = torch.Generator()
        gen.set_state(torch.as_tensor(gstate))
        wa, hl = training.draw_masks(_generator_copy(gen), batch, wt)
        state = training.state_from_numpy(blob, dev)
        with training.exact_steps():
            g64 = training.loss_and_grads(
                training.tree_map(torch.Tensor.double, state.params),
                *[x[0] for x in stacked], mean, wa, hl, width_target=wt,
                is_fully_connected=fc, coeff_l2=1.0, coeff_grad=0.0)[2]
            g32 = training.loss_and_grads(
                state.params, *[x[0] for x in stacked], mean, wa, hl,
                width_target=wt, is_fully_connected=fc, coeff_l2=1.0,
                coeff_grad=0.0)[2]
        out = {}
        for dtype in (torch.float64, torch.float32):
            sync()
            t0 = time.perf_counter()
            ref_state, ref_losses = training.train_chunk(
                training.cast_state(state, dtype), _generator_copy(gen),
                *stacked, mean, (0, 0), width_target=wt,
                is_fully_connected=fc, coeff_l2=1.0, coeff_grad=0.0,
                random_masks=True)
            sync()
            out[dtype] = (training.state_to_numpy(ref_state),
                          ref_losses.cpu().numpy(),
                          time.perf_counter() - t0)
        refs[wt] = (out, zoo.params_to_numpy(g64), zoo.params_to_numpy(g32))
    t_refs = time.perf_counter() - t_phase

    # The ranks, after the references: each side's seconds are its own.
    calls = {
        "a tiled halo v2 regular": (tiled.encode_cases, ([(
            "encode_frame_tiled_halo_v2", frame, QP,
            dict(policy="regular", serialize=True, device=rank_dev))],),
            None),
        "b tiled halo v2 switch": (tiled.encode_cases, ([(
            "encode_frame_tiled_halo_v2", sw_frame, QP,
            dict(policy="switch", pnn=zoo_s, serialize=True,
                 device=rank_dev))],), None),
        "c v1 tiled halo + tiled": (tiled.encode_cases, ([
            ("encode_frame_tiled_halo", frame, QP,
             dict(block_size=V1_BLOCK, device=rank_dev)),
            ("encode_frame_tiled", frame, QP,
             dict(block_size=V1_BLOCK, device=rank_dev))],), None)}
    for wt in (8, 16):
        fc, axis, blob, gstate, stacked = train[wt]
        for name, k, wide in (("float32", steps, False),
                              ("first step", 1, False),
                              ("float64", steps, True)):
            calls[f"d w{wt} {name}"] = (
                sharded_training.chunk_from_state,
                (axis, wt, fc, blob, gstate, *[x[:k] for x in stacked],
                 mean), dict(float64=wide, device=rank_dev))
    calls["built"] = (_build_dir.built, (), None)
    t0 = time.perf_counter()
    got = mesh.spawn_ranks(mesh.run_calls, RANKS,
                           device="cuda:0" if on_card else "cpu",
                           timeout=600, args=(list(calls.values()),))
    t_ranks = time.perf_counter() - t0
    ranks = [dict(zip(calls, out)) for out in got]
    for r, out in enumerate(ranks):
        if out["built"][0]:
            raise AssertionError(f"rank {r} built {out['built'][0]}: the "
                                 f"ranks must load phase 1's libraries")
        say(f"rank {r}: " + "; ".join(
            f"{n} {sec:.3f} s" for n, (_, sec) in out.items()
            if n != "built"))
    say(f"{RANKS} ranks on {rank_dev} (Gloo, sharing the card): spawn to "
        f"results {t_ranks:.3f} s; the references before them, alone, "
        f"{t_refs:.3f} s; {smi}")

    # (a) and (b): the quadtree halo encode against one device.
    for what, key in (("a", "a tiled halo v2 regular"),
                      ("b", "b tiled halo v2 switch")):
        single, sec = refs[what]
        policy = single.policy
        want = (single.reconstruction.tobytes(), single.mode_map.tobytes(),
                tree_digest(single.ctu_trees), single.bitstream)
        for r, out in enumerate(ranks):
            (results, launches), rsec = out[key]
            res = results[0]
            have = (res.reconstruction.tobytes(), res.mode_map.tobytes(),
                    tree_digest(res.ctu_trees), res.bitstream)
            for name, x, y in zip(("recon", "mode map", "trees", "stream"),
                                  have, want):
                if x != y:
                    raise AssertionError(f"phase 20 ({what}) rank {r}: "
                                         f"{name} differs from one device")
            trials = sum(launches["unit_trial"].values())
            mergers = sum(launches["merger_int"].values())
            if on_card and (trials == 0 or (policy == "switch")
                            != (mergers > 0)):
                raise AssertionError(f"phase 20 ({what}) rank {r}: trial "
                                     f"launches {trials}, merger "
                                     f"{mergers}")
            say(f"({what}) {res.reconstruction.shape[0]}x"
                f"{res.reconstruction.shape[1]} {policy} tiled halo v2, "
                f"rank {r}: {rsec:.3f} s, trial launches "
                f"{dict(sorted(launches['unit_trial'].items()))} "
                f"(total {trials}), merger launches "
                f"{dict(sorted(launches['merger_int'].items()))} "
                f"(total {mergers}); equal to one device")
        say(f"({what}) one device (alone): {sec:.3f} s, "
            f"{len(single.bitstream)} bytes")

    # (c) the v1 halo encode against one device.
    v1, sec = refs["c"]
    for r, out in enumerate(ranks):
        (results, launched), rsec = out["c v1 tiled halo + tiled"]
        (recon, modes, _), (ind, _, _) = results
        if on_card and not sum(launched["v1_step"].values()):
            raise AssertionError(f"phase 20 (c) rank {r}: no v1 step "
                                 f"kernel launch ({launched})")
        if not np.array_equal(recon, v1.reconstruction) or not \
                np.array_equal(np.repeat(np.repeat(modes, V1_BLOCK // 4, 0),
                                         V1_BLOCK // 4, 1), v1.mode_map):
            raise AssertionError(f"phase 20 (c) rank {r}: v1 halo differs "
                                 f"from one device")
        if ind.shape != frame.shape:
            raise AssertionError(f"phase 20 (c): tiled shape {ind.shape}")
    say(f"(c) v1 n={V1_BLOCK} {h}x{w}: tiled halo equal to one device "
        f"({sec:.3f} s there, alone); independent stripes "
        f"{'equal' if np.array_equal(ind, v1.reconstruction) else 'differ'}"
        f" at the stripe boundary")

    # (d) the sharded chunks against one device and float64.
    def grads_ok(got, want, what):
        worst, got = 0.0, dict(_leaves(got))
        for key, b in _leaves(want):
            err = np.abs(np.asarray(got[key], np.float64) - b) \
                / np.abs(b).max()
            worst = max(worst, float(err.max()))
            if np.mean(err <= 1e-4) < 0.98 or err.max() > 5e-2:
                raise AssertionError(f"phase 20 (d) {what} {key}: first "
                                     f"step gradients off float64 by "
                                     f"{err.max():.3g}")
        return worst

    def state_err(got, want):
        """Per part (params, mu, nu): the worst |difference| / the leaf's
        max |value|, and the entries past 1e-5 of it."""
        out = {}
        for part, tree, ref in (
                ("params", got["params"], want["params"]),
                ("mu", got["opt_state"][0].mu, want["opt_state"][0].mu),
                ("nu", got["opt_state"][0].nu, want["opt_state"][0].nu)):
            have, worst, off = dict(_leaves(tree)), 0.0, 0
            for key, b in _leaves(ref):
                b = np.asarray(b, np.float64)
                d = np.abs(np.asarray(have[key], np.float64) - b)
                m = float(np.abs(b).max()) or 1.0
                worst = max(worst, float(d.max()) / m)
                off += int((d > 1e-5 * m).sum())
            out[part] = (worst, off)
        return out

    def rel(a, b):
        return float(np.max(np.abs(a - b) / np.abs(b)))

    c1 = np.float32(1 - training.B1)
    for wt in (8, 16):
        fc, axis, _, _, _ = train[wt]
        out, g64, g32 = refs[wt]
        ref32, ref_losses, sec = out[torch.float32]
        ref64, ref_losses64, sec64 = out[torch.float64]
        single_err = grads_ok(g32, g64, f"w{wt} one device")
        total = sum(np.size(b) for _, b in _leaves(ref64["params"]))
        for r, rk in enumerate(ranks):
            (losses, got), rsec = rk[f"d w{wt} float32"]
            (_, first), _ = rk[f"d w{wt} first step"]
            (losses64, got64), rsec64 = rk[f"d w{wt} float64"]
            e32, e64 = rel(losses, ref_losses), rel(losses64, ref_losses64)
            if e32 > 1e-5 or e64 > 1e-5:
                raise AssertionError(f"phase 20 (d) w{wt} rank {r}: loss "
                                     f"rel error {e32:.3g} (float32), "
                                     f"{e64:.3g} (float64)")
            g_sharded = training.tree_map(
                lambda mu: np.asarray(mu) / c1, first["opt_state"][0].mu)
            sharded_err = grads_ok(g_sharded, g64, f"w{wt} rank {r}")
            s64, s32 = state_err(got64, ref64), state_err(got, ref32)
            for part, (worst, off) in s64.items():
                if off:
                    raise AssertionError(
                        f"phase 20 (d) w{wt} rank {r}: float64 {part} "
                        f"{off} entries past 1e-5 of their leaf's max "
                        f"(worst {worst:.3g})")
            fmt = lambda e: ", ".join(f"{p} {w_:.2e} ({o} past 1e-5)"
                                      for p, (w_, o) in e.items())
            say(f"(d) w{wt} {'FC' if fc else 'conv'} {axis}: {steps} steps "
                f"at batch {batch}, rank {r} {rsec:.3f} s float32, "
                f"{rsec64:.3f} s float64; one device {sec:.3f} / "
                f"{sec64:.3f} s (alone); loss rel error {e32:.2e} "
                f"(float64 {e64:.2e}); first step's gradients off float64 "
                f"by at most {sharded_err:.2e} (one device {single_err:.2e})"
                f" of a leaf's max; after {steps} steps, of {total} "
                f"parameters, max rel to the leaf's max: float64 {fmt(s64)};"
                f" float32 (not held) {fmt(s32)}; losses "
                f"{[round(float(x), 3) for x in losses]}")
    total = time.perf_counter() - t_phase
    say(f"phase 20: {total:.1f} s ({t_refs:.1f} s the references, "
        f"{t_ranks:.1f} s the ranks) on {smi}")
    return total


def _generator_copy(gen):
    """A CPU generator in `gen`'s state (draws from it leave `gen` as it
    was)."""
    import torch

    copy = torch.Generator()
    copy.set_state(gen.get_state())
    return copy


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def hm_decode_420(stream, h, w, tmp):
    """Stock HM-16.15's decode of a 4:2:0 stream: (its stdout, (y, cb, cr)
    8-bit planes)."""
    out, raw = run_hm_decoder(stream, tmp)
    c = (h // 2) * (w // 2)
    if raw.size != h * w + 2 * c:
        raise AssertionError(f"HM wrote {raw.size} samples, want "
                             f"{h * w + 2 * c}")
    return out, (raw[:h * w].reshape(h, w),
                 raw[h * w:h * w + c].reshape(h // 2, w // 2),
                 raw[h * w + c:].reshape(h // 2, w // 2))


def host_codec_phase(dev, smi, captured):
    """Phase 18, the host RDO codec on the card: `FrameEncoder` digests
    against `tests/golden_torch/host_codec.json` (each stream decoded back
    by the port's decoder), the Annex-B streams (stock HM on the regular
    ones, the port's HM-syntax decoder on all), every stock-HM stream of
    `tests/golden_hm/`, the RD sweep and BD-rates, and the float fallback.
    Captures the N = 1 inputs of the integer merger (M = 512 included) and
    of the float kernels into `captured` for phase 8.  Returns the
    launches of the main path by row name."""
    import torch

    from context_adaptive_neural_network_based_prediction_tpu_torch.codec \
        import decoder, hm_decoder, hm_encoder, nn_intra
    from context_adaptive_neural_network_based_prediction_tpu_torch \
        .evaluation import host_cases as hc, performance
    from context_adaptive_neural_network_based_prediction_tpu_torch.models \
        import zoo
    from context_adaptive_neural_network_based_prediction_tpu_torch.ops \
        import merger_int
    from context_adaptive_neural_network_based_prediction_tpu_torch.utils \
        import metrics

    t_phase = time.perf_counter()
    with open(hc.GOLDEN) as f:
        golden = json.load(f)
    arrays = np.load(hc.GOLDEN_NPZ)
    mean = hc.mean_training()
    zoo_b = zoo.load_quantized_bundle(hc.MANIFEST_QUANTIZED, mean)
    launches = {}
    orig_mkernel = merger_int._kernel
    orig_forward = nn_intra.PnnPredictor._forward
    fwd_s = [0.0]

    def capture_merger(x, w, bb):        # one N = 1 input set per M
        key = ("merger", x.shape[2], x.shape[0])
        if key not in captured:
            captured[key] = [a.clone() for a in (x, w, bb)]
        return orig_mkernel(x, w, bb)

    # Host time of each forward: context upload, forward and read-back
    # (the read-back waits for the card); cache hits are not timed.
    def timed_forward(self, above, left, n, mean, pos):
        done = sum(self.forwards.values())
        t0 = time.perf_counter()
        out = orig_forward(self, above, left, n, mean, pos)
        if sum(self.forwards.values()) != done:
            fwd_s[0] += time.perf_counter() - t0
        return out

    def zoo_pred(policy):
        return (nn_intra.PnnPredictor(zoo_b, device=dev)
                if policy != "regular" else None)

    # 18a: FrameEncoder (through `encode_frame_hm`, which also gives the
    # Annex-B stream the RD sweep reads) against the JAX package's digests.
    rd_frame = hc.load_frame(hc.RD_FRAME)
    rd_streams = {}         # (policy, qp) -> (stream, result, seconds)
    for frame_name, policy, qp in hc.ENCODES:
        key = f"{frame_name}/{policy}/q{qp}"
        want = golden["encodes"][key]
        pred = zoo_pred(policy)
        fwd_s[0] = 0.0
        torch.cuda.synchronize()
        reset_all_counts()
        merger_int._kernel = capture_merger
        nn_intra.PnnPredictor._forward = timed_forward
        t0 = time.perf_counter()
        try:
            stream, res = hm_encoder.encode_frame_hm(
                hc.load_frame(frame_name), qp, policy=policy, pnn=pred,
                device=dev)
            torch.cuda.synchronize()
        finally:
            merger_int._kernel = orig_mkernel
            nn_intra.PnnPredictor._forward = orig_forward
        sec = time.perf_counter() - t0
        counts = read_all_counts()
        per_m = dict(merger_int.launches)
        for m, k in per_m.items():
            name = f"merger_int_m{m}_n1_host"
            launches[name] = launches.get(name, 0) + k
        check_captured(sha(res.bitstream), want["stream"], f"{key} stream")
        check_captured(sha(np.asarray(res.reconstruction, np.uint8)),
                       want["recon"], f"{key} reconstruction")
        check_captured(sha(np.asarray(res.mode_map, np.int32)),
                       want["mode_map"], f"{key} mode map")
        fwd = dict(pred.forwards) if pred is not None else {"fc": 0,
                                                             "conv": 0}
        if counts["merger_int"] != fwd["conv"] or counts["fc_forward"] \
                or counts["merger"] or counts["unit_trial"]:
            raise AssertionError(f"{key}: launches {counts} against "
                                 f"forwards {fwd}")
        if policy != "regular" and fwd["conv"] == 0:
            raise AssertionError(f"{key}: no conv forward ran")
        t0 = time.perf_counter()
        dec = decoder.decode_frame(res.bitstream, pnn=zoo_b, device=dev)
        t_dec = time.perf_counter() - t0
        if not np.array_equal(dec.reconstruction, res.reconstruction):
            raise AssertionError(f"{key}: the port's decoder differs")
        n_fwd = fwd["fc"] + fwd["conv"]
        ms_fwd = (f"{1e3 * fwd_s[0] / n_fwd:.3f} ms per forward (host: "
                  f"upload, forward, read-back), {100 * fwd_s[0] / sec:.2f}% "
                  f"of the wall inside forwards" if n_fwd else "no forward")
        say(f"host {key}: encode_frame_hm {sec:.3f} s, {len(res.bitstream)} "
            f"bytes == JAX digests (stream, recon, mode map); PNN forwards "
            f"{fwd}, {ms_fwd}; merger launches {per_m} (== conv forwards), "
            f"FC launches 0 (the quantized FC runs no kernel), PNN PUs "
            f"{want['pnn_pus']}; decode {t_dec:.3f} s, reconstruction equal")
        if frame_name == hc.RD_FRAME and policy in hc.RD_POLICIES:
            rd_streams[policy, qp] = (stream, res, sec)

    # 18b: Annex-B streams, the port's HM-syntax decoder and stock HM.
    with tempfile.TemporaryDirectory() as tmp:
        for name, frame_name, policy, qp, chroma in hc.ANNEXB:
            want = golden["annexb"][name]
            y = hc.load_frame(frame_name)
            t0 = time.perf_counter()
            if chroma:
                cb, cr = arrays[f"{name}/cb_src"], arrays[f"{name}/cr_src"]
                stream, res, rec_cb, rec_cr = hm_encoder.encode_frame_hm_420(
                    (y, cb, cr), qp, policy=policy, pnn=zoo_pred(policy),
                    device=dev)
                mine = (res.reconstruction, rec_cb, rec_cr)
                check_captured(sha(rec_cb), want["recon_cb"], f"{name} cb")
                check_captured(sha(rec_cr), want["recon_cr"], f"{name} cr")
            else:
                stream, res = hm_encoder.encode_frame_hm(
                    y, qp, policy=policy, pnn=zoo_pred(policy), device=dev)
                mine = (res.reconstruction, None, None)
            t_enc = time.perf_counter() - t0
            check_captured(sha(stream), want["stream"], f"{name} stream")
            check_captured(sha(np.asarray(res.reconstruction, np.uint8)),
                           want["recon"], f"{name} reconstruction")
            dec = hm_decoder.decode_hm_stream(
                stream, use_native="always", policy=policy,
                pnn=zoo_b if policy != "regular" else None, device=dev)
            got = (dec.reconstruction, dec.reconstruction_cb,
                   dec.reconstruction_cr)
            if not dec.hash_ok or not all(
                    (g is None and m is None) or np.array_equal(g, m)
                    for g, m in zip(got, mine)):
                raise AssertionError(f"{name}: the port's HM decoder differs")
            hm_note = ""
            if policy == "regular":
                h, w = y.shape
                if chroma:
                    out, planes = hm_decode_420(stream, h, w, tmp)
                else:
                    out, luma = hm_decode(stream, h, w, tmp)
                    planes = (luma, None, None)
                if "(OK)" not in out or not all(
                        m is None or np.array_equal(p, m)
                        for p, m in zip(planes, mine)):
                    raise AssertionError(f"{name}: stock HM differs: "
                                         f"{out[-300:]}")
                hm_note = "; stock HM (OK), planes equal"
            say(f"host {name}: {len(stream)} bytes in {t_enc:.3f} s == JAX "
                f"digests; the port's decode_hm_stream (native parser) "
                f"gives it back, hash OK{hm_note}")
            if frame_name == hc.RD_FRAME and not chroma \
                    and policy in hc.RD_POLICIES:
                rd_streams[policy, qp] = (stream, res, t_enc)

    # 18c: every stock-HM stream of tests/golden_hm.
    n_streams = 0
    for path in sorted(glob.glob(os.path.join(REPO, "tests", "golden_hm",
                                              "*.bin"))):
        with open(path, "rb") as f:
            dec = hm_decoder.decode_hm_stream(f.read(), use_native="always")
        base = path[:-4]
        if os.path.basename(path).startswith("420"):
            with np.load(base + "_rec.npz") as z:
                want = (z["y"], z["cb"], z["cr"])
            got = (dec.reconstruction, dec.reconstruction_cb,
                   dec.reconstruction_cr)
        else:
            want, got = (np.load(base + "_rec.npy"),), (dec.reconstruction,)
        if not dec.hash_ok or not all(np.array_equal(g, w)
                                      for g, w in zip(got, want)):
            raise AssertionError(f"{path}: the port's HM decoder differs")
        n_streams += 1
    say(f"host: the port's decode_hm_stream on {n_streams} stock-HM streams "
        f"(luma and 4:2:0): every plane equal to its stored reconstruction")

    # 18d: the RD sweep.  `compute_rate_psnr` encodes the QPs that 18a and
    # 18b did not; the other points come from their Annex-B streams,
    # decoded as `compute_rate_psnr` decodes them.
    h, w = rd_frame.shape
    curves, run_qps = {}, set()
    t0 = time.perf_counter()
    for policy in hc.RD_POLICIES:
        pnn_b = zoo_b if policy != "regular" else None
        curves[policy] = []
        for qp in hc.RD_QPS:
            if (policy, qp) not in rd_streams:
                run_qps.add(qp)
                curves[policy].append(performance.compute_rate_psnr(
                    rd_frame, qp, policy=policy, pnn=pnn_b,
                    use_hm_container=True, device=dev))
                continue
            stream, res, sec = rd_streams[policy, qp]
            t1 = time.perf_counter()
            hd = hm_decoder.decode_hm_stream(stream, policy=policy,
                                             pnn=pnn_b, device=dev)
            if not hd.hash_ok or not np.array_equal(hd.reconstruction,
                                                    res.reconstruction):
                raise AssertionError(f"RD {policy} QP {qp}: the decode "
                                     f"differs")
            curves[policy].append(performance.RdPoint(
                qp=qp, rate_bpp=len(stream) * 8 / (h * w),
                psnr_db=float(metrics.compute_psnr(rd_frame,
                                                   hd.reconstruction)),
                encode_time_s=sec, decode_time_s=time.perf_counter() - t1))
        check_captured([[p.qp, p.rate_bpp, p.psnr_db]
                        for p in curves[policy]], golden["rd"][policy],
                       f"RD {policy}")
    bd = performance.bd_rate_low_high_full(curves["regular"],
                                           curves["switch"])
    want = golden["rd"]["bd_switch_vs_regular"]
    if any(abs(bd[k] - want[k]) > 1e-9 for k in want):
        raise AssertionError(f"BD-rates {bd} != captured {want}")
    say(f"host RD sweep ({hc.RD_FRAME}, QP {hc.RD_QPS}, Annex-B rate, "
        f"checked through the HM-syntax decoder): rates and PSNRs == JAX in "
        f"{time.perf_counter() - t0:.3f} s (compute_rate_psnr at QP "
        f"{sorted(run_qps)}, the other points from the streams of 18a / "
        f"18b); BD-rate switch vs regular: low {bd['low']:.6f} %, high "
        f"{bd['high']:.6f} %, full {bd['full']:.6f} % (== JAX within 1e-9; "
        f"the port's faithfulness, not the paper's result)")

    float_fallback_checks(dev, captured, golden, mean, launches)
    say(f"host codec phase: {time.perf_counter() - t_phase:.1f} s on {smi}")
    return launches


def float_fallback_checks(dev, captured, golden, mean, launches):
    """Phase 18e: one switch encode with a bundle of float models only, so
    that the PNN forwards run the FC and float merger kernels at N = 1.
    Every forward (through the kernels, counted) is held against its plain
    version on the same inputs (not counted); pixels within the float
    tolerance of a .5 tie are counted, by unit.  The stream must equal the
    JAX package's where no coded PNN unit had such a pixel."""
    import torch

    from context_adaptive_neural_network_based_prediction_tpu_torch.codec \
        import decoder, encoder, nn_intra
    from context_adaptive_neural_network_based_prediction_tpu_torch \
        .evaluation import host_cases as hc
    from context_adaptive_neural_network_based_prediction_tpu_torch.models \
        import pnn, zoo
    from context_adaptive_neural_network_based_prediction_tpu_torch.ops \
        import fc_forward, merger

    fbundle = zoo.load_codec_bundle(hc.MANIFEST_TRAINED, mean,
                                    widths=hc.FLOAT_WIDTHS)
    frame_name, qp = hc.FLOAT_ENCODE
    orig_fc, orig_fm = fc_forward.fc_forward, merger.merger_forward
    orig_pixels, orig_net = pnn.predict_uint8, pnn.forward
    orig_unit = nn_intra.PnnPredictor._forward
    stats = {"forwards": 0, "near_ties": 0, "flips": 0, "worst": 0.0}
    held, tied = {}, set()

    def capture_fc(x, weights, biases, impl="kernel"):
        key = ("fc1", x.shape[1])
        if impl == "kernel" and key not in captured:
            captured[key] = (x.clone(), weights, biases)
        return orig_fc(x, weights, biases, impl=impl)

    def capture_fm(x, w, b, act=False, impl="kernel"):
        key = ("fmerger1", x.shape[2])
        if impl == "kernel" and key not in captured:
            captured[key] = (x.clone(), w, b, act)
        return orig_fm(x, w, b, act=act, impl=impl)

    def plain_forward(params, inputs, n, is_fc):
        saved = fc_forward.fc_forward, merger.merger_forward
        fc_forward.fc_forward = lambda x, ws, bs, impl="kernel": orig_fc(
            x, ws, bs, impl="plain")
        merger.merger_forward = lambda x, w, b, act=False, impl="kernel": \
            orig_fm(x, w, b, act=act, impl="plain")
        try:
            return orig_net(params, inputs, n, is_fc)
        finally:
            fc_forward.fc_forward, merger.merger_forward = saved

    def unit_forward(self, above, left, n, mean, pos):
        held["unit"] = tuple(pos) + (n,)
        return orig_unit(self, above, left, n, mean, pos)

    def checked_forward(params, inputs, n, is_fc):
        raw = orig_net(params, inputs, n, is_fc)
        want = plain_forward(params, inputs, n, is_fc)
        scale = want.abs().max().item()
        err = (raw - want).abs().max().item()
        stats["worst"] = max(stats["worst"], err / max(scale, 1e-30))
        if err > 1e-4 * scale:
            raise AssertionError(f"float w{n}: kernels differ from plain by "
                                 f"{err} (max |plain| {scale})")
        held["want"], held["scale"] = want[0, :, :, 0], scale
        return raw

    # `predict_uint8` rounds the kernels' output as it always does; the
    # plain output rounded the same way must agree off the ties.
    def checked_pixels(params, inputs, n, is_fc, mean_training):
        got = orig_pixels(params, inputs, n, is_fc, mean_training)
        want, scale = held.pop("want"), held.pop("scale")
        px = torch.clamp(want + float(np.float32(mean_training)), 0, 255)
        tie = ((px - px.floor() - 0.5).abs() <= 1e-4 * scale)
        differ = got[0].to(torch.int32) != torch.round(px).to(torch.int32)
        if (differ & ~tie).any():
            raise AssertionError(f"float w{n}: a pixel off a tie differs")
        if tie.any():
            tied.add(held["unit"])
        stats["near_ties"] += int(tie.sum())
        stats["flips"] += int(differ.sum())
        stats["forwards"] += 1
        return got

    pred = nn_intra.PnnPredictor(fbundle, device=dev)
    torch.cuda.synchronize()
    reset_all_counts()
    fc_forward.fc_forward, merger.merger_forward = capture_fc, capture_fm
    pnn.forward, pnn.predict_uint8 = checked_forward, checked_pixels
    nn_intra.PnnPredictor._forward = unit_forward
    t0 = time.perf_counter()
    try:
        res = encoder.encode_frame(hc.load_frame(frame_name), qp,
                                   policy="switch", pnn=pred, device=dev)
        torch.cuda.synchronize()
    finally:
        fc_forward.fc_forward, merger.merger_forward = orig_fc, orig_fm
        pnn.forward, pnn.predict_uint8 = orig_net, orig_pixels
        nn_intra.PnnPredictor._forward = orig_unit
    t_run = time.perf_counter() - t0
    counts = read_all_counts()
    ff = dict(pred.float_forwards)
    fc_counts, fm_counts = dict(fc_forward.launches), dict(merger.launches)
    if counts["fc_forward"] != 4 * ff["fc"] or counts["merger"] != ff[
            "conv"] or counts["merger_int"] != 0 or not ff["fc"] \
            or not ff["conv"] or stats["forwards"] != ff["fc"] + ff["conv"]:
        raise AssertionError(f"float fallback: launches {counts} against "
                             f"float forwards {ff}")
    for k, w in ((80, 4), (320, 8)):     # a forward's first layer
        launches[f"fc_forward_w{w}_n1_host"] = 4 * fc_counts.get(
            (k, 1200), 0)
    for m, c in fm_counts.items():
        launches[f"merger_m{m}_n1_host"] = c
    dec = decoder.decode_frame(res.bitstream, pnn=fbundle, device=dev)
    if not np.array_equal(dec.reconstruction, res.reconstruction):
        raise AssertionError("float fallback: the port's decoder differs")
    # The units whose PNN prediction the stream codes: the TUs of the PUs
    # coded with the PNN mode.
    coded, stack = set(), list(res.ctu_trees)
    while stack:
        node = stack.pop()
        stack.extend(node.children)
        coded.update((tu.x, tu.y, tu.n) for pu in node.pus
                     if pu.mode == encoder.PNNS_MODE for tu in pu.tus)
    key = f"{frame_name}/switch/q{qp}"
    fwant = golden["float"][key]
    same = {"stream": sha(res.bitstream) == fwant["stream"],
            "recon": sha(np.asarray(res.reconstruction, np.uint8))
            == fwant["recon"],
            "mode map": sha(np.asarray(res.mode_map, np.int32))
            == fwant["mode_map"]}
    hit = coded & tied
    if not hit:
        for what, ok in same.items():
            if not ok:
                raise AssertionError(f"float fallback {key}: the {what} "
                                     f"differs from the JAX package's")
    verdict = ("required, as no coded PNN unit hit a tie" if not hit else
               f"not required, as {len(hit)} of the {len(coded)} coded PNN "
               f"units hit one")
    say(f"host float fallback ({frame_name} switch QP {qp}, float models "
        f"only): encode {t_run:.3f} s with every forward also run "
        f"plain, float forwards {ff}, FC launches {fc_counts} (4 layers a "
        f"forward), float merger launches {fm_counts}; kernels vs plain "
        f"within {stats['worst']:.2e} of max |plain| over "
        f"{stats['forwards']} forwards, {stats['near_ties']} pixels within "
        f"that tolerance of a tie in {len(tied)} units, {stats['flips']} "
        f"rounded the other way; round trip exact; stream, reconstruction "
        f"and mode map {'==' if all(same.values()) else '!='} the JAX "
        f"package's float encode ({verdict})")


def kernel_row(name, source, replaces, launches, err, fn, plain_fn,
               bound_ms, bound_by, library_fn, device_keys):
    """One entry of the kernels JSON, timed on the card: the kernel and the
    library call (if there is one) in turns, as the host issues them (ms,
    library_ms) and queued behind a spin so that the card runs them back
    to back (queued_ms, library_queued_ms: device time, no host cost)."""
    if library_fn is None:
        ms, library_ms = time_launches(fn), None
        queued_ms = time_in_turns(fn, fn, queued=True)[0]
        library_queued_ms = None
    else:
        ms, library_ms = time_in_turns(fn, library_fn)
        queued_ms, library_queued_ms = time_in_turns(fn, library_fn,
                                                     queued=True)
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=err, ms=ms,
        plain_ms=time_launches(plain_fn, reps=10), bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
        device_ms=kernel_device_ms(fn, device_keys), queued_ms=queued_ms,
        library_queued_ms=library_queued_ms)


def float_kernel_rows(captured, float_launches, q_inputs, q_launches, dev,
                      host_launches):
    """Rows of the float PNN's kernels: the FC chain (w4, w8) and the float
    merger (M = 32, 64, 128, 256) on the inputs of the 1080p comparison's
    first chunk (float32 weights, N = 1024), and the serving shapes of
    `scripts/profile_mfu.py` (bf16 weights of the frozen w8 FC and w16
    models, w8 FC and M = 128 merger at batch 256 and 2048, seeded
    inputs).  Serving rows carry the path's launch count of the kernel at
    that width.  Then the quantize path's (phase 17: `q_inputs`, the first
    call of each shape, and `q_launches`, the launches of that shape over
    the six models): one FC layer at N = 256 per input width K (80, 320,
    1200; float32 weights) and the float merger at N = 256 per M.  Last
    the host encoder's float fallback (phase 18): the FC chain (w4, w8)
    and the float merger per M at N = 1, float32 weights, with that
    encode's launches (`host_launches`)."""
    import torch

    from context_adaptive_neural_network_based_prediction_tpu_torch.models \
        import zoo
    from context_adaptive_neural_network_based_prediction_tpu_torch.ops \
        import fc_forward, merger

    rng = np.random.default_rng(77)
    rows = []
    fc_models = {80: "pnn_w4_fc_single", 320: "pnn_w8_fc_single"}
    merger_models = {32: "pnn_w4_refconv_single",
                     64: "pnn_w8_refconv_single", 128: "pnn_w16_single",
                     256: "pnn_w32_single"}

    def fc_row(name, x, ws, bs, launches):
        call = lambda impl: fc_forward.fc_forward(x, ws, bs, impl=impl)
        got, want = call("kernel"), call("plain")
        check_close(got, want, 1e-4, name)
        wf = [w.float() for w in ws]

        def lib():
            h = x
            for i, (w, b) in enumerate(zip(wf, bs)):
                h = torch.matmul(h, w) + b
                if i < len(wf) - 1:
                    h = torch.maximum(0.1 * h, h)
            return h

        check_close(lib(), want, 1e-4, name + " (library chain)")
        bound_ms, bound_by, route = fc_bound_ms(x, ws, bs)
        row = kernel_row(name, FC_SOURCE, FC_REPLACES, launches,
                         max_abs_err([got], [want]), lambda: call("kernel"),
                         lambda: call("plain"), bound_ms, bound_by, lib,
                         ("fc_tc_kernel", "fc_split_reduce_kernel"))
        row["bound_route"] = route
        row["launches_per_call"] = len(ws)
        rows.append(row)

    def merger_row(name, x, w, b, act, launches):
        call = lambda impl: merger.merger_forward(x, w, b, act=act, impl=impl)
        got, want = call("kernel"), call("plain")
        check_close(got, want, 1e-5, name)
        xm = x.permute(2, 0, 1).contiguous()                  # (M, N, P)
        wm = w.float().permute(2, 0, 1).contiguous()          # (M, P, O)
        lib = torch.bmm(xm, wm).permute(1, 2, 0) + b
        if act:
            lib = torch.maximum(0.1 * lib, lib)
        check_close(lib, want, 1e-5, name + " (library bmm)")
        bound_ms, bound_by = fmerger_bound_ms(x, w, b)
        row = kernel_row(name, FMERGER_SOURCE, FMERGER_REPLACES, launches,
                         max_abs_err([got], [want]), lambda: call("kernel"),
                         lambda: call("plain"), bound_ms, bound_by,
                         lambda: torch.bmm(xm, wm),
                         ("merger_staged_kernel",))
        row["launches_per_call"] = 1
        rows.append(row)

    for k_in, model in fc_models.items():
        x, ws, bs = captured[("fc", k_in)]
        w = int(round((k_in / 5) ** 0.5))
        fc_row(f"fc_forward_w{w}_n{x.shape[0]}_path", x, ws, bs,
               sum(float_launches[model].values()))
    for m, model in merger_models.items():
        x, w, b, act = captured[("fmerger", m)]
        merger_row(f"merger_m{m}_n{x.shape[0]}_path", x, w, b, act,
                   float_launches[model][("merger", m)])
    for model, kind in (("pnn_w8_fc_single", "fc"),
                        ("pnn_w16_single", "merger")):
        params, _ = zoo.load_frozen_params(os.path.join(
            REPO, "artifacts", "frozen", model + ".npz"))
        tp = zoo.params_from_numpy(params, dev, torch.bfloat16)
        for n in SERVING_BATCHES:
            if kind == "fc":
                fc = tp["fully_connected"]
                x = torch.from_numpy(rng.normal(0, 30, (n, 320)).astype(
                    np.float32)).to(dev)
                fc_row(f"fc_forward_w8_n{n}_bf16_serving", x,
                       [fc[f"weights_{i}"] for i in range(4)],
                       [fc[f"biases_{i}"] for i in range(4)],
                       sum(float_launches[model].values()))
            else:
                cm = tp["convolutional"]["merger"][
                    "channelwise_fully_connected_merger"]
                x = torch.from_numpy(rng.normal(0, 1, (n, 80, 128)).astype(
                    np.float32)).to(dev)
                merger_row(f"merger_m128_n{n}_bf16_serving", x,
                           cm["weights"], cm["biases"], True,
                           float_launches[model][("merger", 128)])
    for (kind, size), (x, ws, bs, act) in sorted(q_inputs.items()):
        if kind == "fc":
            fc_row(f"fc_forward_k{size}_n{x.shape[0]}_quantize", x, ws, bs,
                   q_launches[(kind, size)])
        else:
            merger_row(f"merger_m{size}_n{x.shape[0]}_quantize", x, ws, bs,
                       act, q_launches[(kind, size)])
    for k_in, w in ((80, 4), (320, 8)):
        x, ws, bs = captured[("fc1", k_in)]
        fc_row(f"fc_forward_w{w}_n1_host", x, ws, bs,
               host_launches[f"fc_forward_w{w}_n1_host"])
    for key in sorted(k for k in captured if k[0] == "fmerger1"):
        x, w, b, act = captured[key]
        merger_row(f"merger_m{key[1]}_n1_host", x, w, b, act,
                   host_launches[f"merger_m{key[1]}_n1_host"])
    return rows


def fc_bound_ms(x, ws, bs):
    """The least time of one FC chain: x, the weights and biases read once
    and the (N, w^2) output written once over the HBM rate, against the
    chain's multiply-adds (two operations each) by the fastest route that
    keeps float32's accuracy: float32 outside the tensor cores, three TF32
    products per product (split operands), and for bfloat16 weights
    (exact in TF32 and bf16) two TF32 products or three bf16 ones (x split
    into three bf16 pieces).  Returns (ms, bytes or operations, route)."""
    import torch

    n = x.shape[0]
    moved = x.numel() * 4 + sum(t.numel() * t.element_size()
                                for t in list(ws) + list(bs)) \
        + n * ws[-1].shape[1] * 4
    t_bytes = moved / HBM_BPS
    ops = 2 * n * sum(w.shape[0] * w.shape[1] for w in ws)
    routes = {"f32": ops / F32_OPS, "3xTF32": 3 * ops / TF32_OPS}
    if ws[0].dtype != torch.float32:
        routes.update({"2xTF32": 2 * ops / TF32_OPS,
                       "3xBF16": 3 * ops / BF16_OPS})
    route = min(routes, key=routes.get)
    t_ops = routes[route]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", route)


def fmerger_bound_ms(x, w, b):
    """The least time of one float merger call: x, w, b read once and the
    (N, O, M) output written once over the HBM rate, against N*P*O*M
    multiply-adds (two operations each) at the float32 rate outside the
    tensor cores."""
    n, p, m = x.shape
    o = w.shape[1]
    moved = sum(t.numel() * t.element_size() for t in (x, w, b)) \
        + n * o * m * 4
    t_bytes = moved / HBM_BPS
    t_ops = 2 * n * p * o * m / F32_OPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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


def time_queued(fn, reps=10, warm=2):
    """Median ms of one call of `fn` issued while the card spins for
    about 10 ms (`STEP_SPIN_CYCLES`, longer than the host takes to issue
    it), so its CUDA events time the card's work alone."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, z = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        torch.cuda._sleep(STEP_SPIN_CYCLES)
        a.record()
        fn()
        z.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(z))
    return float(np.median(times))


def time_in_turns(fn, other, reps=50, warm=3, queued=False):
    """Median ms of one call of `fn` and of `other`, timed in turns (fn,
    other, other, fn, ...), each call with its own CUDA events, the calls
    queued back to back.  `queued`: each call is issued while the card
    spins for about 0.5 ms, so the events time the card's work alone."""
    import torch

    for _ in range(warm):
        fn()
        other()
    torch.cuda.synchronize()
    times = ([], [])
    ev = []
    for i in range(reps):
        for j in ((0, 1) if i % 2 == 0 else (1, 0)):
            a, z = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            if queued:
                torch.cuda._sleep(SPIN_CYCLES)
            a.record()
            (fn, other)[j]()
            z.record()
            ev.append((j, a, z))
    torch.cuda.synchronize()
    for j, a, z in ev:
        times[j].append(a.elapsed_time(z))
    return float(np.median(times[0])), float(np.median(times[1]))


def tensor_core_sass(lib_path):
    """A line with the count of tensor-core instructions (HGMMA, HMMA) in
    the SASS of the built library, from `cuobjdump -sass`; raises if the
    toolkit has `cuobjdump` and there are none."""
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return "fc_forward SASS: cuobjdump not found, not counted"
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300).stdout
    counts = {op: sum(1 for line in sass.splitlines()
                      if f" {op}." in line or f" {op} " in line)
              for op in ("HGMMA", "HMMA")}
    if not sum(counts.values()):
        raise AssertionError("no tensor-core instruction in fc_forward's "
                             "SASS")
    return (f"fc_forward SASS: {counts['HGMMA']} HGMMA and {counts['HMMA']}"
            f" HMMA instructions (cuobjdump -sass)")


def kernel_device_ms(fn, keys, reps=20, tries=3):
    """Device time per call of the kernels whose names contain one of
    `keys`, from the profiler's CUDA activity.  The profiler drops a
    session's kernel records now and then (all of them, or some), so a
    session counts only if every matching kernel has a whole number of
    records per call; otherwise it is profiled again, up to `tries` times
    (None if no session had them all)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages()
                 if any(k in e.key for k in keys)]
        if found and all(e.count % reps == 0 for e in found):
            us = sum(getattr(e, "device_time_total",
                             getattr(e, "cuda_time_total", 0.0))
                     for e in found)
            if us > 0:
                return us / reps / 1e3
    return None


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


def device_breakdown(fn, n_top=4):
    """One profiled call of `fn`: (device ms of all its CUDA activities,
    the `n_top` largest by name as "name ms (count)"), or (None, None) if
    the profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    by_name: dict = {}
    for e in prof.events():
        if getattr(e, "device_type", None) == cuda:
            us, k = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), k + 1)
    if not by_name:
        return None, None
    total = sum(us for us, _ in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n_top]
    return total, "; ".join(f"{name[:60]} {us / 1e3:.3f} ms ({k})"
                            for name, (us, k) in top)


def card_rates():
    """(int32, FP64 tensor-core) operations per second of card 0 at its max
    SM clock (`nvidia-smi --query-gpu=clocks.max.sm`), a multiply-add
    counted as two: 64 int32 lanes per SM; 256 FP64 tensor-core
    operations a clock per SM."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    clock = sms * float(mhz) * 1e6
    return 2 * 64 * clock, 256 * clock


def trial_bound_ms(tc, args, int_ops, f64_ops):
    """The least time the card could take for one trial call: the larger
    of (bytes of inputs and tables read once + outputs written once) over
    the HBM rate, and the operations' time.  Operations per (slot, mode):
    the four integer transform passes, 2 n^3 multiply-adds each counted as
    two, by the fastest exact route (int32 on the CUDA cores, or FP64 on
    the tensor cores: every product and partial sum below 2^53); about 72
    per pixel for prediction, RDOQ, rate, sign hiding and reconstruction at
    the float32 rate.  The two kinds issue to separate units, so the larger
    time bounds.  Only the tables the kernel of size n reads count.
    Returns (ms, bytes or operations, the route of the term that sets the
    bound: the transforms' route, or "f32 operations" where the float32
    work is the larger)."""
    from context_adaptive_neural_network_based_prediction_tpu_torch.ops \
        import unit_fused

    n, nn = tc["n"], tc["nn"]
    b = args[0].shape[0]
    n_modes = tc["n_modes"]
    read = sum(a.numel() * a.element_size() for a in args if a is not None)
    read += sum(tc[k].numel() * tc[k].element_size() for k in
                unit_fused.table_keys(n) + unit_fused.PARAM_KEYS)
    written = b * 4 * 2 + b * nn * 4 * 2 + b * 8 * 4
    t_bytes = (read + written) / HBM_BPS
    transform_ops = b * n_modes * 4 * 2 * n ** 3
    routes = {"int32": transform_ops / int_ops,
              "f64 tensor cores": transform_ops / f64_ops}
    route = min(routes, key=routes.get)
    t_f32 = b * n_modes * 72 * nn / F32_OPS
    if t_f32 > routes[route]:
        route = "f32 operations"
    t_ops = max(routes.get(route, 0.0), t_f32)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", route)


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
