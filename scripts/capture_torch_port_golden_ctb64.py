"""Capture the JAX package's digests for the port's CTB-64 encoder and its
Annex-B (HM syntax) output.

Two sets, both from the JAX package on the CPU, rate evolution off, so its
jitted program runs (the `live` keys of `w2_nn.json` were made the same
way):

* `--set ctb64` writes `tests/golden_torch/w2_ctb64.json`: the sha256 of
  the reconstruction, of the 14 grids of `_assemble_arrays` at CTB 64 and
  of the own-format stream, for `regular`, `switch` and `substitution`,
  one frame a call (b = 1) and a 2-frame batch (b = 2: the frame and its
  left-right mirror, `encode_frames_wavefront2_batch`'s program, each
  frame's digests).  Frames: a smooth seeded 64x128 frame (QP 37, the
  random quantized bundle of `w2_nn_random_bundle.npz`, conv PNNs at
  widths 8 and 16) and the 128x128 natural crop of
  `tests/golden_hm/128_full_q32_src.npy` (QP 32, the frozen singles zoo
  `artifacts/frozen/qpnn_w{4,8,16,32}_single.npz`).  Each entry also
  counts the 64x64 leaf CUs (`leaf64`) and the PNN-coded PUs.
* `--set hm` writes `tests/golden_torch/w2_hm.json`: the sha256 of the
  Annex-B stream of `encode_frame_wavefront2_hm` and of its (loop-
  filtered) reconstruction, at CTB 32 and 64, loop filters on and off,
  for the three policies on the natural crop (frozen singles, QP 32), and
  at CTB 64 with loop filters on for the three policies on the smooth
  frame (random bundle, QP 37), whose encodes choose 64x64 leaves.

Usage:  JAX_PLATFORMS=cpu python scripts/capture_torch_port_golden_ctb64.py \
            [--set ctb64|hm|all]
(about 5 minutes a set on 8 CPU cores, most of it XLA compiling the
programs; the two sets can run as two processes at once.)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from capture_torch_port_golden import (  # noqa: E402
    REPO, frozen_bundle, pnn_pus, random_bundle, sha)

CTB64_OUT = os.path.join(REPO, "tests", "golden_torch", "w2_ctb64.json")
HM_OUT = os.path.join(REPO, "tests", "golden_torch", "w2_hm.json")
GRID_NAMES = ("m8", "q8", "s8", "m4", "q4", "m16", "q16", "s16", "m32",
              "q32", "s32", "m64", "q64", "s64")
NN_WIDTHS = (4, 8, 16, 32)
# frame -> (bundle, qp)
FRAME_CONFIG = {"smooth64x128": ("random", 37),
                "natural128": ("frozen_singles", 32)}
POLICIES = ("regular", "switch", "substitution")


def test_frames() -> dict:
    """The smooth seeded 64x128 frame and the 128x128 natural crop."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:64, 0:128]
    smooth = np.clip(128 + 40 * np.sin(xx / 37.0) + 30 * np.cos(yy / 41.0)
                     + rng.normal(0, 3, (64, 128)), 0, 255).astype(np.uint8)
    natural = np.load(os.path.join(REPO, "tests", "golden_hm",
                                   "128_full_q32_src.npy"))
    return {"smooth64x128": smooth, "natural128": natural}


def bundles() -> dict:
    return {"random": random_bundle(), "frozen_singles": frozen_bundle()}


def grid_digests(recon, grids, stream) -> dict:
    out = {"recon": sha(np.asarray(recon, np.uint8)), "stream": sha(stream),
           "stream_len": len(stream)}
    for name, g in zip(GRID_NAMES, grids):
        out[name] = sha(np.asarray(g, np.int32))
    out["leaf64"] = int(np.sum(np.asarray(grids[13]) == 0))
    return out


def capture_ctb64(out_path):
    import jax
    import jax.numpy as jnp

    from context_adaptive_neural_network_based_prediction_tpu.parallel import (
        wavefront2)

    os.environ.pop("CANP_FUSED_UNIT", None)
    os.environ.pop("CANP_RATE_EVOLVE", None)
    frames = test_frames()
    bnd = bundles()
    result = {"config": {"ctb": 64, "enable_nxn": True,
                         "rate_evolve": False, "impl": "default",
                         "frames": {k: {"bundle": v[0], "qp": v[1]}
                                    for k, v in FRAME_CONFIG.items()},
                         "batch": "b2 = [frame, frame[:, ::-1]]"},
              "encodes": {}}
    for name, (bname, qp) in FRAME_CONFIG.items():
        frame = frames[name]
        bundle = bnd[bname]
        widths = [w for w in bundle.quantized if w in NN_WIDTHS]
        for policy in POLICIES:
            pnn = None if policy == "regular" else bundle
            for nf in (1, 2):
                t0 = time.time()
                batch = np.stack([frame, frame[:, ::-1]])[:nf]
                h, w = frame.shape
                run = wavefront2._jitted_wavefront2(
                    h, w, qp, policy=policy,
                    bundle=pnn, ctb=64,
                    enable_nxn=True, n_frames=nf, rate_evolve=False)
                recon, ys = run(jnp.asarray(batch if nf > 1 else frame))
                recon = np.asarray(recon)
                ys = jax.tree_util.tree_map(np.asarray, ys)
                if nf == 1:
                    recon = recon[None]
                for f in range(nf):
                    ys_f = _extract(ys, f, nf)
                    grids = wavefront2._assemble_arrays(ys_f, h, w, 64)
                    res = wavefront2._arrays_to_result(
                        batch[f], qp, (recon[f],) + grids, policy, True,
                        ctb=64)
                    d = grid_digests(recon[f], grids, res.bitstream)
                    d.update(frame=name, bundle=bname, policy=policy, qp=qp,
                             n_frames=nf, index=f,
                             pnn_pus=pnn_pus(res.ctu_trees, policy, widths)
                             if pnn is not None else 0)
                    key = f"{name}/{policy}/b{nf}/{f}"
                    result["encodes"][key] = d
                    print(f"{key}: {time.time() - t0:.1f} s, "
                          f"{d['stream_len']} bytes, leaf64 {d['leaf64']}, "
                          f"{d['pnn_pus']} PNN PUs", flush=True)
                wavefront2._W2_CACHE.clear()
    _write(result, out_path)


def _extract(ys, f, nf):
    """Frame f's per-step outputs of an nf-frame run (slot axis ordered
    (slot, frame): at -3 for the level arrays, -1 for the others)."""
    if nf == 1:
        return ys
    out = {}
    for k, v in ys.items():
        if isinstance(v, dict):
            out[k] = _extract(v, f, nf)
        else:
            axis = -3 if k.startswith("q") else -1
            out[k] = np.take(v, np.arange(v.shape[axis] // nf) * nf + f,
                             axis=axis)
    return out


def capture_hm(out_path):
    from context_adaptive_neural_network_based_prediction_tpu.parallel import (
        wavefront2)

    os.environ.pop("CANP_FUSED_UNIT", None)
    os.environ.pop("CANP_RATE_EVOLVE", None)
    frames = test_frames()
    bnd = bundles()
    result = {"config": {"enable_nxn": True, "rate_evolve": False,
                         "sign_hiding": True,
                         "frames": {k: {"bundle": v[0], "qp": v[1]}
                                    for k, v in FRAME_CONFIG.items()}},
              "encodes": {}}
    runs = [("natural128", policy, ctb, lf) for policy in POLICIES
            for ctb in (32, 64) for lf in (True, False)]
    runs += [("smooth64x128", policy, 64, True) for policy in POLICIES]
    for name, policy, ctb, lf in runs:
        bname, qp = FRAME_CONFIG[name]
        pnn = None if policy == "regular" else bnd[bname]
        t0 = time.time()
        stream, res = wavefront2.encode_frame_wavefront2_hm(
            frames[name], qp, loop_filters=lf, policy=policy, pnn=pnn,
            ctb=ctb)
        key = f"{name}/{policy}/ctb{ctb}/{'lf' if lf else 'nolf'}"
        result["encodes"][key] = dict(
            frame=name, bundle=bname, policy=policy, qp=qp, ctb=ctb,
            loop_filters=lf, stream=sha(stream), stream_len=len(stream),
            recon=sha(np.asarray(res.reconstruction, np.uint8)),
            mode_map=sha(np.asarray(res.mode_map, np.int32)))
        print(f"{key}: {time.time() - t0:.1f} s, {len(stream)} bytes",
              flush=True)
    _write(result, out_path)


def _write(result, out_path):
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1, sort_keys=True)
        f.write("\n")
    print("wrote", out_path, flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--set", choices=("ctb64", "hm", "all"), default="all")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.set in ("ctb64", "all"):
        capture_ctb64(CTB64_OUT)
    if args.set in ("hm", "all"):
        capture_hm(HM_OUT)


if __name__ == "__main__":
    main()
