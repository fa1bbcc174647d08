"""Variants of the port's kernels, timed on one NVIDIA card: the
measurements behind the FC kernel's tiling plan, the float merger's
shape, the integer merger's shape and the unit trial's design (PERF.md).

    python -m context_adaptive_neural_network_based_prediction_tpu_torch.ops.kernel_variants [sections]

Each variant is a source of `csrc/` with a few lines replaced, built with
the port's nvcc flags into a temporary directory and called through
ctypes; the time of a call is the median of calls queued behind a spin of
the card, in turns with the other variants and the library call (the
card's time, no host cost).  Sections:

  fc-sweep   every tile width and K split of the FC layer at the path's
             layer shapes, float32 and bfloat16 weights, against `plan`
  fc-probes  the 1024 x 1200 x 1200 layer with the loads, the split, the
             operand source, the wait depth, the warpgroups and the
             products per stage changed one at a time (timing only: the
             probes that skip work give wrong outputs)
  merger     the float merger with other warps, slots and block sizes,
             without the position split, against `torch.bmm`
  merger-int the integer merger with other maps per block and warps per
             block, at the codec's M = 32 ... 256 and N = 31, against
             float64 `torch.bmm` (every variant checked exact)
  trial      the unit trial at 31 slots, every variant checked exact,
             timed queued and on the profiler's clock, in turns: at n = 4
             and 8 clusters of 4, 2 and 1 blocks a slot; at n = 16 and 32
             the shapes of `TRIAL_LARGE_VARIANTS` (cluster size, warps a
             mode, threads and blocks an SM); at every n the two-launch
             design (a block per slot and mode, then a select kernel)
  trial-probes  the same, with probes of the select's cost: two
             release/acquire cluster barriers more, and no select (timing
             only: wrong results)
  trial-stress  many back-to-back trial calls at n = 4, 8, 16 and 32 (31
             slots) through the kernel's entry point, the outputs held
             against the first call's bits every few thousand calls: the
             final design, then (n = 4 and 8) the select as first written
             (a launch error ends the process, so that one comes last)
  trial-clusters  how many clusters of each size the card holds at once
             (`cudaOccupancyMaxActiveClusters`) for the n = 16 / 32
             kernel's blocks as built (31 slots need 31 for one wave)
  trial-host the trial wrapper's host-inclusive us per call at n = 4 and
             8, timed as `chip_smoke.py` phase 8 times it but in turns
             (n = 4, 8, 8, 4), in several rounds, beside its host us
  empty      the latency floor: an empty kernel through the same ctypes
             path, queued and on the profiler's clock, without and with
             33 KB of static shared memory, alone and alternating
  host       the wrappers' host cost per call and per piece

Nothing here runs at import; the card is required (no CPU fallback).
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from . import _cuda_build, fc_forward, merger, merger_int, unit_fused

SPIN_CYCLES = 1_000_000
FC_SHAPES = ((1024, 80, 1200), (1024, 320, 1200), (1024, 1200, 1200),
             (2048, 1200, 1200), (256, 1200, 1200), (256, 320, 1200),
             (1024, 1200, 16), (1024, 1200, 64), (2048, 1200, 64),
             (7, 1200, 1200))
_LOOP_ONE = ("    wgmma_commit();\n    if (i > 0) {\n      wgmma_wait<1>();",
             "    wgmma_commit();\n    wgmma_wait<1>();\n    release(i - 1);")
FC_PROBES = {
    "base": [],
    "no loads after the first fill": [(
        "        mbar_expect_tx(full, STAGE_BYTES);",
        "        if (i >= stages) { mbar_arrive(full); continue; }\n"
        "        mbar_expect_tx(full, STAGE_BYTES);")],
    "no split of x": [(
        "      f.lo[s][i] = tf32_rna(v - __uint_as_float(f.hi[s][i]));",
        "      f.lo[s][i] = f.hi[s][i];")],
    "no fragment loads after the first": [
        ("    load_frag(f1, stage_x(i), warp, lane);\n", "    f1 = f0;\n"),
        ("    wait_full(i);\n    load_frag(f0, stage_x(i), warp, lane);\n  }",
         "    wait_full(i);\n  }")],
    "wait depth 2": [(_LOOP_ONE[0], _LOOP_ONE[0].replace("<1>", "<2>")),
                     (_LOOP_ONE[1], _LOOP_ONE[1].replace("<1>", "<2>"))],
    "wait depth 0": [(_LOOP_ONE[1], _LOOP_ONE[1].replace("<1>", "<0>"))],
    "products twice per stage": [
        ("    issue<BN, SPLIT_W>(acc, f0, b_hi(i), b_hi(i) + B_BYTES);",
         "    issue<BN, SPLIT_W>(acc, f0, b_hi(i), b_hi(i) + B_BYTES);\n"
         "    issue<BN, SPLIT_W>(acc, f0, b_hi(i), b_hi(i) + B_BYTES);"),
        ("    issue<BN, SPLIT_W>(acc, f1, b_hi(i), b_hi(i) + B_BYTES);",
         "    issue<BN, SPLIT_W>(acc, f1, b_hi(i), b_hi(i) + B_BYTES);\n"
         "    issue<BN, SPLIT_W>(acc, f1, b_hi(i), b_hi(i) + B_BYTES);")],
    "two consumer warpgroups (128 rows)": [
        ("constexpr int BM = 64;", "constexpr int BM = 128;"),
        ("constexpr int THREADS = 128 + 32;",
         "constexpr int THREADS = 256 + 32;"),
        ("mbar_init(bars + 8 * (MAX_STAGES + s), 4);",
         "mbar_init(bars + 8 * (MAX_STAGES + s), 8);"),
        ("  if (warp == 4) {", "  if (warp == 8) {"),
        ("return reinterpret_cast<const float*>(smem + (i % stages) * "
         "STAGE_BYTES);",
         "return reinterpret_cast<const float*>(smem + (i % stages) * "
         "STAGE_BYTES) + (warp >> 2) * 64 * BK;"),
        ("stage_x(0), warp, lane);", "stage_x(0), warp & 3, lane);"),
        ("load_frag(f1, stage_x(i), warp, lane);",
         "load_frag(f1, stage_x(i), warp & 3, lane);"),
        ("load_frag(f0, stage_x(i), warp, lane);",
         "load_frag(f0, stage_x(i), warp & 3, lane);")],
}
MERGER_VARIANTS = {
    "base": [],
    "no position split": [
        ("  if (per <= WARPS * SLOTS / 2) {", "  if (false) {")],
    "8 warps x 4 slots": [
        ("constexpr int WARPS = 16;", "constexpr int WARPS = 8;"),
        ("constexpr int SLOTS = 2;", "constexpr int SLOTS = 4;")],
    "16 slots per block at least": [
        ("constexpr int MIN_BLOCK_SLOTS = 8;",
         "constexpr int MIN_BLOCK_SLOTS = 16;")],
    "4 positions ahead": [("constexpr int PU = 8;", "constexpr int PU = 4;")],
}
MERGER_INT_VARIANTS = {
    "base": [],
    "one slot a block": [("constexpr int SLOTS2_FROM = 128;",
                          "constexpr int SLOTS2_FROM = 1 << 30;")],
    "2 slots from M = 64": [("constexpr int SLOTS2_FROM = 128;",
                             "constexpr int SLOTS2_FROM = 64;")],
    "2 slots at M = 256 only": [("constexpr int SLOTS2_FROM = 128;",
                                 "constexpr int SLOTS2_FROM = 256;")],
    "16 warps, 2 blocks an SM": [
        ("constexpr int WARPS = 8;", "constexpr int WARPS = 16;"),
        ("constexpr int MIN_BLOCKS = 1;", "constexpr int MIN_BLOCKS = 2;")],
}
MERGER_INT_MAPS = (32, 64, 128, 256)
_CASE_4 = "e = launch_small<4, CLUSTER_4>("
_CASE_8 = "e = launch_small<8, CLUSTER_8>("
_CL = {c: [("constexpr int CLUSTER_4 = 4;", f"constexpr int CLUSTER_4 = {c};"),
           ("constexpr int CLUSTER_8 = 4;", f"constexpr int CLUSTER_8 = {c};")]
       for c in (1, 2)}
TRIAL_VARIANTS = {
    "clusters of 4": [],
    "clusters of 2": _CL[2],
    "a block a slot": _CL[1],
    "two launches (slot x mode blocks, select kernel)": [
        (_CASE_4, "launch_modes<4>("), (_CASE_8, "launch_modes<8>(")],
}
_CASE_16 = "e = launch_large<16, WARPS_16, CLUSTER_16>("
_CASE_32 = "e = launch_large<32, WARPS_32, CLUSTER_32>("


def large_knobs():
    """The n = 16 / 32 kernel's shape constants as `csrc/unit_trial.cu`
    sets them: {name: value}."""
    with open(os.path.join(_cuda_build.CSRC, "unit_trial.cu")) as f:
        text = f.read()
    return {k: int(v) for k, v in re.findall(
        r"^constexpr int ((?:CLUSTER|WARPS|MAX_THREADS|MIN_BLOCKS)_(?:16|32))"
        r" = (\d+);$", text, flags=re.M)}


_KNOBS = large_knobs()


def _large(**knobs):
    """Replacements setting the n = 16 / 32 kernel's knobs."""
    return [(f"constexpr int {k} = {_KNOBS[k]};",
             f"constexpr int {k} = {v};") for k, v in knobs.items()
            if v != _KNOBS[k]]


# n = 16 and 32, the final design first: cluster size (CL), warps a mode
# (W: pixels a thread n^2 / 32 W), threads a block, blocks an SM.  How
# many clusters of a size fit at once decides whether 31 slots run in one
# wave (`trial-clusters`).
TRIAL_LARGE_VARIANTS = {
    "n = 16: W 2, CL 9, 2 blocks an SM; n = 32: W 8, CL 3, 768 threads":
        [],
    "CL 6 at n = 16": _large(CLUSTER_16=6),
    "CL 12 at n = 16, 1 block an SM": _large(CLUSTER_16=12, MIN_BLOCKS_16=1),
    "8 pixels a thread (W 1 / 4), CL 3": _large(
        WARPS_16=1, CLUSTER_16=3, MIN_BLOCKS_16=1, WARPS_32=4,
        MAX_THREADS_32=384),
    "8 pixels a thread, CL 4 (two waves: 30 clusters fit)": _large(
        WARPS_16=1, CLUSTER_16=4, MIN_BLOCKS_16=1, WARPS_32=4, CLUSTER_32=4,
        MAX_THREADS_32=384),
    "8 pixels a thread, CL 6, 256 threads and 2 blocks an SM at n = 32":
        _large(WARPS_16=1, CLUSTER_16=6, MIN_BLOCKS_16=1, WARPS_32=4,
               CLUSTER_32=6, MAX_THREADS_32=256, MIN_BLOCKS_32=2),
    "2 pixels a thread (W 4 / 16), 1024 threads at n = 32": _large(
        WARPS_16=4, CLUSTER_16=12, MIN_BLOCKS_16=1, WARPS_32=16,
        MAX_THREADS_32=1024),
    "1024 threads at n = 32": _large(MAX_THREADS_32=1024),
    "CL 12 at n = 32 (3 modes a block)": _large(CLUSTER_32=12),
    "a warp a mode at n = 32 (CL 6)": _large(WARPS_32=1, CLUSTER_32=6,
                                             MAX_THREADS_32=384),
    "two launches at n >= 16 (the first design)": [
        (_CASE_16, "launch_modes<16>("), (_CASE_32, "launch_modes<32>(")],
}
_WAIT = "    if (tid < 32) mbar_wait0(costs_in);"
_FENCED = [(_WAIT, _WAIT + 2 * (
    '\n    asm volatile("barrier.cluster.arrive.aligned;\\n"'
    '\n                 "barrier.cluster.wait.aligned;" ::: "memory");'))]
_NO_SELECT = [("    if (tid == 0) *s_best = id < M_PAD ? id : 0;",
               "    if (tid == 0) *s_best = 0;")]
# The select as first written, without the cluster barrier at the end.
# It races (a block may exit with its pushes in flight): it gave the right
# bits until it hung once (PERF.md), so it is a probe.
_UNSAFE = [("    cluster_arrive_relaxed();\n    cluster_wait();\n  }\n"
            "  const int bi = *s_best;", "  }\n  const int bi = *s_best;")]
# What the select costs: two release/acquire cluster barriers more (as a
# select over distributed shared memory needs), and no select at all
# (timing only: wrong results).  The select is one helper of both kernels,
# so a probe changes n = 16 / 32 too; it is timed at n = 4 and 8.
TRIAL_PROBES = {
    "clusters of 4, select as first written (unsafe)": _UNSAFE,
    "clusters of 4, two cluster barriers more": _FENCED,
    "clusters of 2, two cluster barriers more": _CL[2] + _FENCED,
    "clusters of 4, no select": _NO_SELECT,
    "a block a slot, no select": _CL[1] + _NO_SELECT,
}
EMPTY_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
__global__ void empty_smem_kernel(int* sink) {
  __shared__ int s[8448];                      // 33 KB
  s[threadIdx.x] = threadIdx.x;
  __syncthreads();
  if (sink != nullptr && threadIdx.x == 0) sink[0] = s[7];
}
extern "C" int empty_launch(int smem, int blocks, int threads,
                            void* sink, void* stream) {
  if (smem) empty_smem_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (int*)sink);
  else empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""
# The n = 16 / 32 trial kernel's blocks as built: registers, shared memory
# and how many clusters of `cluster` blocks fit on the card at once.
CLUSTER_SOURCE = r"""
#include "unit_trial.cu"
template <int N, int W, int CL>
int clusters(int cluster, int* out) {
  using K = Large<N, W, CL>;
  auto kern = trial_large_kernel<N, W, CL>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(31 * cluster);
  cfg.blockDim = dim3(K::THREADS);
  cfg.dynamicSmemBytes = K::SMEM;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  out[0] = K::THREADS;
  out[1] = fa.numRegs;
  out[2] = K::SMEM;
  return (int)cudaOccupancyMaxActiveClusters(&out[3], kern, &cfg);
}
extern "C" int trial_clusters(int n, int cluster, int* out) {
  return n == 16 ? clusters<16, WARPS_16, CLUSTER_16>(cluster, out)
                 : clusters<32, WARPS_32, CLUSTER_32>(cluster, out);
}
"""
MERGER_SHAPES = ((32, 1024, torch.float32), (64, 1024, torch.float32),
                 (128, 1024, torch.float32), (256, 1024, torch.float32),
                 (128, 256, torch.bfloat16), (128, 2048, torch.bfloat16))


def build_variants(source, variants, out_dir):
    """{name: (ctypes library, lines ptxas marks as serialized, the
    compiler's output)} of `source` with each variant's replacements,
    built in parallel."""
    with open(os.path.join(_cuda_build.CSRC, source)) as f:
        text = f.read()
    libs, errors = {}, []

    def one(idx, name, subs):
        try:
            src = text
            for a, b in subs:
                if a not in src:
                    raise ValueError(f"{name}: {a!r} not in {source}")
                src = src.replace(a, b)
            path = os.path.join(out_dir, f"v{idx}_{source}")
            with open(path, "w") as f:
                f.write(src)
            lib = path[:-3] + ".so"
            stem = source[:-3]
            proc = subprocess.run(
                [_cuda_build.nvcc(), *_cuda_build.NVCC_FLAGS,
                 *_cuda_build.SOURCE_FLAGS[stem], "-o", lib, path],
                capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(f"{name}: {proc.stderr[-2000:]}")
            serial = sum("serialized" in line for line in
                         (proc.stdout + proc.stderr).splitlines())
            libs[name] = (_cuda_build._bind(stem, lib), serial,
                          proc.stdout + proc.stderr)
        except Exception as e:  # re-raised below, after every build
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i, n, s))
               for i, (n, s) in enumerate(variants.items())]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return {n: libs[n] for n in variants}


def queued_in_turns(fns, reps=30):
    """Median us of each of `fns`, in turns (forward, then backward), each
    call issued while the card spins, so the events time its work."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    ev = []
    for i in range(reps):
        order = range(len(fns)) if i % 2 == 0 else reversed(range(len(fns)))
        for j in order:
            a, z = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            torch.cuda._sleep(SPIN_CYCLES)
            a.record()
            fns[j]()
            z.record()
            ev.append((j, a, z))
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for j, a, z in ev:
        times[j].append(a.elapsed_time(z) * 1e3)
    return [float(np.median(t)) for t in times]


def _fc_call(lib, x, hi, lo, b, out, part, bn, splits):
    n, k = x.shape
    d = out.shape[1]
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    args = (n, k, d, 0, bn, splits, x.data_ptr(), hi.data_ptr(),
            None if lo is None else lo.data_ptr(), b.data_ptr(),
            out.data_ptr(), part.data_ptr(), stream)

    def call():
        err = lib.fc_forward(*args)
        if err:
            raise RuntimeError(f"fc_forward variant failed: {err}")
    return call


def _fc_inputs(rng, n, k, d, dtype, dev):
    x = torch.from_numpy(rng.normal(0, 30, (n, k)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(0, 0.03, (k, d)).astype(np.float32)).to(
        dev, dtype)
    b = torch.from_numpy(rng.normal(0, 0.1, d).astype(np.float32)).to(dev)
    return x, w, b


def fc_sweep(dev, out_dir):
    lib = build_variants("fc_forward.cu", {"base": []}, out_dir)["base"][0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    for n, k, d in FC_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, b = _fc_inputs(rng, n, k, d, dtype, dev)
            hi, lo = fc_forward.prepare_weight(w)
            stages = -(-k // fc_forward.TILE_DEPTH)
            tiles = [(bn, sp) for bn in fc_forward.TILE_COLUMNS
                     for sp in (1, 2, 3, 4, 6, 8)
                     if (sp - 1) * -(-stages // sp) < stages]
            out = torch.empty((n, d), device=dev)
            part = torch.empty((8, n, d), device=dev)
            fns = [_fc_call(lib, x, hi, lo, b, out, part, bn, sp)
                   for bn, sp in tiles]
            us = queued_in_turns(fns, reps=10)
            best = sorted(zip(us, tiles))
            chosen = fc_forward.plan(n, k, d, sms, lo is not None)
            print(f"fc {n}x{k}x{d} {str(dtype)[6:]}: plan {chosen} "
                  f"{us[tiles.index(chosen)]:.1f} us; best "
                  + ", ".join(f"{bn}/{sp} {t:.1f}" for t, (bn, sp)
                              in best[:4]), flush=True)


def fc_probes(dev, out_dir):
    libs = build_variants("fc_forward.cu", FC_PROBES, out_dir)
    rng = np.random.default_rng(1)
    n, k, d = 1024, 1200, 1200
    for dtype in (torch.float32, torch.bfloat16):
        x, w, b = _fc_inputs(rng, n, k, d, dtype, dev)
        hi, lo = fc_forward.prepare_weight(w)
        out = torch.empty((n, d), device=dev)
        part = torch.empty((1, n, d), device=dev)
        names, fns = [], []
        for name, (lib, serial, _) in libs.items():
            for bn in ((96, 192) if "warpgroups" in name else (192,)):
                names.append(f"{name}, BN {bn}"
                             + (" (serialized by ptxas)" if serial else ""))
                fns.append(_fc_call(lib, x, hi, lo, b, out, part, bn, 1))
        for name, t in zip(names, queued_in_turns(fns)):
            print(f"fc probe {n}x{k}x{d} {str(dtype)[6:]}: {name}: "
                  f"{t:.1f} us", flush=True)


def merger_variants(dev, out_dir):
    libs = build_variants("merger.cu", MERGER_VARIANTS, out_dir)
    rng = np.random.default_rng(2)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    for m, n, dtype in MERGER_SHAPES:
        x = torch.from_numpy(rng.normal(0, 1, (n, 80, m)).astype(
            np.float32)).to(dev)
        w = torch.from_numpy(rng.normal(0, 0.1, (80, 16, m)).astype(
            np.float32)).to(dev, dtype)
        b = torch.from_numpy(rng.normal(0, 0.1, (16, m)).astype(
            np.float32)).to(dev)
        out = torch.empty((n, 16, m), device=dev)
        want = merger.merger_plain(x, w, b, True)
        fns = []
        for name, (lib, _, _) in libs.items():
            args = (n, 80, 16, m, int(dtype == torch.bfloat16), 1,
                    x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                    stream)
            if lib.merger(*args):
                raise RuntimeError(f"merger variant {name} failed")
            torch.cuda.synchronize()
            err = ((out - want).abs().max() / want.abs().max()).item()
            if not err <= 1e-5:
                raise AssertionError(f"merger variant {name}: {err}")
            fns.append(lambda lib=lib, args=args: lib.merger(*args))
        xm = x.permute(2, 0, 1).contiguous()
        wm = w.float().permute(2, 0, 1).contiguous()
        fns.append(lambda: torch.bmm(xm, wm))
        us = queued_in_turns(fns)
        print(f"merger M={m} N={n} {str(dtype)[6:]}: "
              + "; ".join(f"{name} {t:.1f}" for name, t in
                          zip(list(libs) + ["torch.bmm"], us)) + " us",
              flush=True)


def device_us(fn, keys, reps=20):
    """Device us per call of the kernels whose names contain one of `keys`,
    from the profiler's CUDA activity (None if it records no device
    time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
             for e in prof.key_averages() if any(k in e.key for k in keys))
    return us / reps if us > 0 else None


def merger_int_variants(dev, out_dir):
    libs = build_variants("merger_int.cu", MERGER_INT_VARIANTS, out_dir)
    rng = np.random.default_rng(4)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    for m in MERGER_INT_MAPS:
        n = 31
        x = torch.from_numpy(rng.integers(-2047, 2048, (n, 80, m)).astype(
            np.int16)).to(dev)
        w = torch.from_numpy(rng.integers(-511, 512, (80, 16, m)).astype(
            np.int16)).to(dev)
        b = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, (16, m)).astype(
            np.int32)).to(dev)
        wp = merger_int.prepare_weight(w, b)
        want = merger_int.merger_plain(x, w, b)
        out = torch.empty((m, n, 16), dtype=torch.int32, device=dev)
        fns = []
        for name, (lib, _, _) in libs.items():
            args = (n, 80, m, x.data_ptr(), wp.data_ptr(), b.data_ptr(),
                    out.data_ptr(), stream)
            out.zero_()
            if lib.merger_int(*args):
                raise RuntimeError(f"merger_int variant {name} failed")
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"merger_int variant {name} differs")
            fns.append(lambda lib=lib, args=args: lib.merger_int(*args))
        xm = x.permute(2, 0, 1).to(torch.float64).contiguous()
        wm = w.permute(2, 0, 1).to(torch.float64).contiguous()
        fns.append(lambda: torch.bmm(xm, wm))
        us = queued_in_turns(fns)
        print(f"merger_int M={m} N={n}: "
              + "; ".join(f"{name} {t:.2f}" for name, t in
                          zip(list(libs) + ["float64 torch.bmm"], us))
              + " us queued", flush=True)


def _trial_case(n, b, dev, qp=32):
    """Table set and seeded inputs of one n x n trial call at QP `qp`:
    random content near a base level, nonzero rate rows."""
    from ..codec import rdo
    from ..parallel import rate_model, wavefront2
    from . import transform

    c = wavefront2._unit_consts(n, qp)
    tc = unit_fused.consts_from_numpy(unit_fused.build_consts(
        n, 35, c, rate_model.scalar_bits(qp), rdo.lambda_for_qp(qp),
        transform.QUANT_SCALES[qp % 6], transform.INV_QUANT_SCALES[qp % 6],
        b, groups={4: 1, 8: 1, 16: 6, 32: 36}[n]), device=dev)
    rng = np.random.default_rng(n)
    base = rng.integers(0, 256, (b, 1))
    rt = np.clip(base + rng.integers(-60, 60, (b, 2 * n + 1)), 0, 255)
    rl = np.clip(base + rng.integers(-60, 60, (b, 2 * n + 1)), 0, 255)
    rl[:, 0] = rt[:, 0]
    og = np.clip(base[:, :, None] + rng.integers(-70, 70, (b, n, n)), 0, 255)
    mb = rng.uniform(1.0, 6.0, (b, 35))
    rr = rng.integers(-400, 400, (8, b))
    args = [torch.from_numpy(np.ascontiguousarray(a).astype(t)).to(dev)
            for a, t in ((rt, np.int32), (rl, np.int32), (og, np.int32),
                         (mb, np.float32), (rr, np.int32))]
    return tc, args


def trial_variants(dev, out_dir, probes=False):
    small = {**TRIAL_VARIANTS, **TRIAL_PROBES} if probes else TRIAL_VARIANTS
    libs = build_variants("unit_trial.cu", {**small, **TRIAL_LARGE_VARIANTS},
                          out_dir)
    for name in TRIAL_LARGE_VARIANTS:
        for line in libs[name][2].splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.split(':', 1)[-1].strip()}",
                      flush=True)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    for n in (4, 8, 16, 32):
        b = 31
        tc, args = _trial_case(n, b, dev)
        want = unit_fused.trial_apply(tc, *args, impl="plain")
        # The two-launch design also needs its per-mode scratch.
        nn = n * n
        out = torch.empty(b * (2 + 2 * nn + 8)
                          + b * unit_fused.M_PAD * (1 + 2 * nn + 8),
                          dtype=torch.int32, device=dev)
        names = list(small if n <= 8 else TRIAL_LARGE_VARIANTS)
        fns = []
        for name in names:
            lib = libs[name][0]
            cargs = (n, b, *(a.data_ptr() for a in args), None,
                     tc["k_struct_ptr"], out.data_ptr(), stream)
            if lib.unit_trial(*cargs):
                raise RuntimeError(f"unit_trial variant {name} failed")
            torch.cuda.synchronize()
            got = out[:b * (2 + 2 * nn + 8)].split((b, b, b * nn, b * nn,
                                                    b * 8))
            for x, y in zip(got, want):
                if "no select" not in name and not torch.equal(
                        x.reshape(-1), y.reshape(-1).view(torch.int32)):
                    raise AssertionError(f"unit_trial variant {name} "
                                         f"differs at n = {n}")
            fns.append(lambda lib=lib, cargs=cargs: lib.unit_trial(*cargs))
        us = queued_in_turns(fns)
        dev_us = [device_us(f, ("trial", "select")) for f in fns]
        print(f"unit_trial n={n} b={b}: " + "; ".join(
            f"{name} {t:.2f} us queued, {d} us on the card"
            for name, t, d in zip(names, us, dev_us)), flush=True)


def trial_stress(dev, out_dir, calls=200_000, check_every=5_000):
    unsafe = "clusters of 4, select as first written (unsafe)"
    libs = {"final": _cuda_build.library("unit_trial"),
            unsafe: build_variants("unit_trial.cu",
                                   {unsafe: TRIAL_PROBES[unsafe]},
                                   out_dir)[unsafe][0]}
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    cases = {n: _trial_case(n, 31, dev) for n in (4, 8, 16, 32)}
    for name, lib in libs.items():
        for n, (tc, args) in cases.items():
            if name == unsafe and n > 8:
                continue
            out = torch.empty(unit_fused.out_words(n, 31), dtype=torch.int32,
                              device=dev)
            cargs = (n, 31, *(a.data_ptr() for a in args), None,
                     tc["k_struct_ptr"], out.data_ptr(), stream)
            if lib.unit_trial(*cargs):
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            ref = out.clone()
            want = unit_fused.trial_apply(tc, *args, impl="plain")
            got = unit_fused.split_outputs(ref, n, 31)
            if not all(torch.equal(x.reshape(-1).view(torch.int32),
                                   y.reshape(-1).view(torch.int32))
                       for x, y in zip(got, want)):
                raise AssertionError(f"{name} n={n}: differs from plain")
            t0 = time.perf_counter()
            for i in range(1, calls + 1):
                if lib.unit_trial(*cargs):
                    raise RuntimeError(f"{name}: launch failed")
                if i % check_every == 0:
                    torch.cuda.synchronize()
                    if not torch.equal(out, ref):
                        raise AssertionError(f"{name} n={n}: call {i} "
                                             "differs from the first")
            print(f"trial stress {name}, n={n}: {calls} calls ok, the same "
                  f"bits, {time.perf_counter() - t0:.1f} s", flush=True)


def trial_host_turns(dev, rounds=4, reps=50):
    """Per round: the median us of a trial call at n = 4 and 8 with CUDA
    events around each call, calls back to back (host-inclusive), in turns
    4, 8, 8, 4; and the host's us per call of 500 calls."""
    cases = {n: _trial_case(n, 31, dev) for n in (4, 8)}

    def events_us(n):
        tc, args = cases[n]
        for _ in range(3):
            unit_fused.trial_apply(tc, *args)
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for a, z in ev:
            a.record()
            unit_fused.trial_apply(tc, *args)
            z.record()
        torch.cuda.synchronize()
        return float(np.median([a.elapsed_time(z) for a, z in ev])) * 1e3

    def host_us(n, calls=500):
        tc, args = cases[n]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            unit_fused.trial_apply(tc, *args)
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        return us

    for r in range(rounds):
        ms = [events_us(n) for n in (4, 8, 8, 4)]
        print(f"trial host-inclusive round {r}: n=4 {ms[0]:.1f} / {ms[3]:.1f}"
              f" us, n=8 {ms[1]:.1f} / {ms[2]:.1f} us; host n=4 "
              f"{host_us(4):.1f} us, n=8 {host_us(8):.1f} us", flush=True)


def trial_clusters(out_dir, sizes=(2, 3, 4, 6, 8, 9, 12)):
    """Print, for the n = 16 / 32 trial kernel as built, its threads,
    registers and shared memory a block and the clusters of each size the
    card holds at once."""
    import ctypes

    path = os.path.join(out_dir, "trial_clusters.cu")
    with open(path, "w") as f:
        f.write(CLUSTER_SOURCE)
    lib_path = path[:-3] + ".so"
    proc = subprocess.run(
        [_cuda_build.nvcc(), *_cuda_build.NVCC_FLAGS,
         *_cuda_build.SOURCE_FLAGS["unit_trial"], "-I", _cuda_build.CSRC,
         "-o", lib_path, path], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"trial_clusters: {proc.stderr[-2000:]}")
    lib = ctypes.CDLL(lib_path)
    lib.trial_clusters.argtypes = [ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]
    lib.trial_clusters.restype = ctypes.c_int
    for n in (16, 32):
        found = []
        for c in sizes:
            out = (ctypes.c_int * 4)()
            if lib.trial_clusters(n, c, out):
                raise RuntimeError(f"trial_clusters n={n} cluster {c} failed")
            found.append(f"{c}: {out[3]}")
        print(f"trial n={n}: {out[0]} threads, {out[1]} registers, {out[2]} "
              f"bytes of shared memory a block; clusters at once by size "
              + ", ".join(found) + " (31 slots)", flush=True)


def build_empty(out_dir):
    """The ctypes library of `EMPTY_SOURCE`, built with the port's flags."""
    path = os.path.join(out_dir, "empty_launch.cu")
    with open(path, "w") as f:
        f.write(EMPTY_SOURCE)
    lib_path = path[:-3] + ".so"
    proc = subprocess.run([_cuda_build.nvcc(), *_cuda_build.NVCC_FLAGS, "-o",
                           lib_path, path], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"empty_launch: {proc.stderr[-2000:]}")
    import ctypes

    lib = ctypes.CDLL(lib_path)
    lib.empty_launch.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    lib.empty_launch.restype = ctypes.c_int
    return lib


def empty_floor(dev, out_dir):
    """{case: (queued us, device us)} of an empty launch through ctypes:
    31 blocks of 256 threads, without and with 33 KB of static shared
    memory, each alone and the two alternating (queued in turns)."""
    lib = build_empty(out_dir)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)

    def call(smem):
        def f():
            if lib.empty_launch(smem, 31, 256, sink.data_ptr(), stream):
                raise RuntimeError("empty launch failed")
        return f

    plain, smem = call(0), call(1)
    out = {}
    for name, fns in (("empty", [plain, plain]),
                      ("33 KB shared", [smem, smem]),
                      ("alternating", [plain, smem])):
        us = queued_in_turns(fns)
        out[name] = (us, [device_us(f, ("empty",)) for f in fns])
    return out


def print_empty(dev, out_dir):
    for name, (us, dev_us) in empty_floor(dev, out_dir).items():
        print(f"empty launch, {name}: queued {us[0]:.2f} / {us[1]:.2f} us, "
              f"on the card {dev_us[0]} / {dev_us[1]} us", flush=True)


def host_cost(dev):
    """Host us per call of the wrappers and their pieces, beside the
    library call of the same shapes (calls issued back to back, the host's
    clock)."""
    def host_us(fn, reps=1000):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        us = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        return us

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (256, 80, 128)).astype(
        np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(0, 0.1, (80, 16, 128)).astype(
        np.float32)).to(dev, torch.bfloat16)
    b = torch.from_numpy(rng.normal(0, 0.1, (16, 128)).astype(
        np.float32)).to(dev)
    xm = x.permute(2, 0, 1).contiguous()
    wm = w.float().permute(2, 0, 1).contiguous()
    xf, wf, bf = _fc_inputs(rng, 1024, 1200, 1200, torch.float32, dev)
    pieces = {
        "check_tensor": lambda: _cuda_build.check_tensor(
            "x", x, (256, 80, 128), (torch.float32,), dev),
        "torch.empty": lambda: torch.empty((256, 16, 128), device=dev),
        "torch.cuda.current_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "merger wrapper (M 128, N 256, bf16)": lambda: merger.merger_forward(
            x, w, b, act=True),
        "torch.bmm of the same": lambda: torch.bmm(xm, wm),
        "fc layer wrapper (1024 x 1200 x 1200)": lambda: (
            fc_forward._kernel_layer(xf, wf, bf, True)),
    }
    xi = torch.from_numpy(rng.integers(-2047, 2048, (31, 80, 32)).astype(
        np.int16)).to(dev)
    wi = torch.from_numpy(rng.integers(-511, 512, (80, 16, 32)).astype(
        np.int16)).to(dev)
    bi = torch.from_numpy(rng.integers(-1000, 1000, (16, 32)).astype(
        np.int32)).to(dev)
    xim = xi.permute(2, 0, 1).to(torch.float64).contiguous()
    wim = wi.permute(2, 0, 1).to(torch.float64).contiguous()
    pieces["integer merger wrapper (M 32, N 31)"] = lambda: (
        merger_int.merger_int_forward(xi, wi, bi))
    pieces["float64 torch.bmm of the same"] = lambda: torch.bmm(xim, wim)
    for n in (4, 8, 16):
        tc, args = _trial_case(n, 31, dev)
        pieces[f"unit trial wrapper (n {n}, 31 slots)"] = (
            lambda tc=tc, args=args: unit_fused.trial_apply(tc, *args))
    tc, args = _trial_case(4, 31, dev)
    shapes = [tuple(a.shape) for a in args]
    pieces["trial input predicate (5 tensors)"] = lambda: all(
        unit_fused._ok(a, s, a.dtype, dev.index) for a, s in zip(args, shapes))
    pieces["trial outputs: torch.empty + split_outputs (n 4)"] = lambda: (
        unit_fused.split_outputs(torch.empty(
            unit_fused.out_words(4, 31), dtype=torch.int32, device=dev),
            4, 31))
    for rnd in (1, 2):
        for name, fn in pieces.items():
            reps = 200 if name.startswith(("fc", "unit")) else 1000
            print(f"host {name} (round {rnd}): {host_us(fn, reps):.2f} us "
                  f"per call", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("sections", nargs="*", default=[
        "fc-sweep", "fc-probes", "merger", "merger-int", "trial", "empty",
        "host"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _cuda_build.load()
    with tempfile.TemporaryDirectory() as out_dir:
        for section in args.sections:
            {"fc-sweep": lambda: fc_sweep(dev, out_dir),
             "fc-probes": lambda: fc_probes(dev, out_dir),
             "merger": lambda: merger_variants(dev, out_dir),
             "merger-int": lambda: merger_int_variants(dev, out_dir),
             "trial": lambda: trial_variants(dev, out_dir),
             "trial-probes": lambda: trial_variants(dev, out_dir, True),
             "trial-host": lambda: trial_host_turns(dev),
             "trial-clusters": lambda: trial_clusters(out_dir),
             "trial-stress": lambda: trial_stress(dev, out_dir),
             "empty": lambda: print_empty(dev, out_dir),
             "host": lambda: host_cost(dev)}[section]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
