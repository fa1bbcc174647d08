"""Variants of the float PNN kernels, timed on one NVIDIA card: the
measurements behind the FC kernel's tiling plan and the float merger's
shape (PERF.md).

    python -m context_adaptive_neural_network_based_prediction_tpu_torch.ops.kernel_variants

Each variant is `csrc/fc_forward.cu` or `csrc/merger.cu` with a few lines
replaced, built with the port's nvcc flags into a temporary directory and
called through ctypes; the time of a call is the median of calls queued
behind a spin of the card, in turns with the other variants and the
library call (the card's time, no host cost).  Sections:

  fc-sweep   every tile width and K split of the FC layer at the path's
             layer shapes, float32 and bfloat16 weights, against `plan`
  fc-probes  the 1024 x 1200 x 1200 layer with the loads, the split, the
             operand source, the wait depth, the warpgroups and the
             products per stage changed one at a time (timing only: the
             probes that skip work give wrong outputs)
  merger     the float merger with other warps, slots and block sizes,
             without the position split, against `torch.bmm`
  host       the wrappers' host cost per call and per piece

Nothing here runs at import; the card is required (no CPU fallback).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from . import _cuda_build, fc_forward, merger

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
MERGER_SHAPES = ((32, 1024, torch.float32), (64, 1024, torch.float32),
                 (128, 1024, torch.float32), (256, 1024, torch.float32),
                 (128, 256, torch.bfloat16), (128, 2048, torch.bfloat16))


def build_variants(source, variants, out_dir):
    """{name: ctypes library} of `source` with each variant's
    replacements, built in parallel."""
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
            libs[name] = (_cuda_build._bind(stem, lib), serial)
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
        for name, (lib, serial) in libs.items():
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
        for name, (lib, _) in libs.items():
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


def host_cost(dev):
    """Host us per call of the float wrappers and their pieces (calls
    issued back to back, the host's clock)."""
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
    for name, fn in pieces.items():
        reps = 200 if name.startswith("fc") else 1000
        print(f"host {name}: {host_us(fn, reps):.2f} us per call",
              flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("sections", nargs="*", default=[
        "fc-sweep", "fc-probes", "merger", "host"])
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
             "host": lambda: host_cost(dev)}[section]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
