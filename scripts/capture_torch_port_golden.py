"""Capture the JAX package's digests the PyTorch port is held against.

The JAX package's whole-frame encode with live rate evolution needs the
fused unit trial (`parallel/wavefront2.py`: `rate_evolve` raises without
it), and on the CPU that is the inline-XLA twin, `CANP_FUSED_UNIT=xla`.
Compiled as one program, that encode did not finish on a CPU: after 78
minutes and 25 GB of host memory XLA was still compiling the 64x96 frame.
So this script runs the same JAX program under `jax.disable_jit()`: every
operation is dispatched on its own, the scans become Python loops, and
nothing large is compiled (8 and 15 minutes for the two frames).  It
writes sha256 digests of the reconstruction, of every decided grid of
`_assemble_arrays` and of the stream to
`tests/golden_torch/w2_rate_evolve.json`, once.
`tests/test_torch_wavefront2.py` holds the port's encode against them.

Config: regular policy, QP 32, CTB 32, NxN on, `rate_evolve=True`, one
frame, on the two test frames (the synthetic 64x96 frame of
`scripts/w2_golden.py` and the 128x128 natural crop in `tests/golden_hm`).

`--set nn` writes `tests/golden_torch/w2_nn.json`, the NN policies' digests:
* the `switch` encode of the 64x96 frame with rate evolution on (op by op,
  as above), QP 37, with the random quantized bundle of
  `tests/test_wavefront_nn.py` (conv PNNs at widths 8 and 16, mean 117.9),
  whose parameters it also saves (`w2_nn_random_bundle.npz`) so that a
  machine without JAX can run the same encode;
* the encodes the tests also compare live (rate evolution off, the JAX
  package's default CPU path), for the card: `switch` and `substitution`
  of the 64x96 frame with that bundle (QP 37), and of the 128x128 crop
  with the frozen singles zoo (`artifacts/frozen/qpnn_w{4,8,16,32}_single.npz`,
  mean 86.8568 of `artifacts/training_set/luminance/means/mean_training.pkl`
  for every width), at the first QP of (32, 37) at which the `switch`
  encode codes a PU with the PNN mode.

Usage:  JAX_PLATFORMS=cpu python scripts/capture_torch_port_golden.py \
            [--set rate_evolve|nn|all] [--out PATH]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tests", "golden_torch", "w2_rate_evolve.json")
NN_OUT = os.path.join(REPO, "tests", "golden_torch", "w2_nn.json")
NN_BUNDLE = os.path.join(REPO, "tests", "golden_torch",
                         "w2_nn_random_bundle.npz")
FROZEN_MANIFEST = os.path.join(REPO, "artifacts", "frozen",
                               "manifest_quantized.txt")
FROZEN_MEAN = os.path.join(REPO, "artifacts", "training_set", "luminance",
                           "means", "mean_training.pkl")
NN_WIDTHS = (4, 8, 16, 32)
NN_QP_SYNTH = 37
NN_QPS_NATURAL = (32, 37)

GRID_NAMES = ("m8", "q8", "s8", "m4", "q4", "m16", "q16", "s16", "m32",
              "q32", "s32")
QP = 32
CTB = 32


def test_frames() -> dict:
    """The two frames of the port's whole-encode tests."""
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:64, 0:96]
    synth = np.clip(128 + 45 * np.sin(xx / 11.0) + 35 * np.cos(yy / 8.0)
                    + rng.normal(0, 7, (64, 96)), 0, 255).astype(np.uint8)
    natural = np.load(os.path.join(REPO, "tests", "golden_hm",
                                   "128_full_q32_src.npy"))
    return {"synth64x96": synth, "natural128": natural}


def sha(a) -> str:
    if isinstance(a, (bytes, bytearray)):
        return hashlib.sha256(bytes(a)).hexdigest()
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def digests(recon, grids, stream) -> dict:
    """sha256 of recon (uint8), each grid (int32) and the stream bytes."""
    out = {"recon": sha(np.asarray(recon, np.uint8)),
           "stream": sha(stream), "stream_len": len(stream)}
    for name, g in zip(GRID_NAMES, grids):
        out[name] = sha(np.asarray(g, np.int32))
    return out


def random_bundle():
    """The JAX package's random quantized bundle of
    `tests/test_wavefront_nn.py` (conv PNNs at widths 8 and 16)."""
    import jax

    from context_adaptive_neural_network_based_prediction_tpu.codec import (
        nn_intra)
    from context_adaptive_neural_network_based_prediction_tpu.models import (
        pnn)

    params = {8: pnn.init_params(jax.random.PRNGKey(1), 8, False),
              16: pnn.init_params(jax.random.PRNGKey(2), 16, False)}
    arch = {8: False, 16: False}
    return nn_intra.PnnBundle(params, arch, 117.9).quantize(n_samples=48)


def frozen_bundle():
    """The frozen singles zoo at the wavefront's widths as a JAX
    `PnnBundle` (quantized models only), one mean for every width."""
    import pickle

    from context_adaptive_neural_network_based_prediction_tpu.codec import (
        nn_intra)
    from context_adaptive_neural_network_based_prediction_tpu.models import (
        pnn_q)

    with open(FROZEN_MEAN, "rb") as f:
        mean = float(pickle.load(f))
    quantized = {}
    with open(FROZEN_MANIFEST) as f:
        for line in f:
            if not line.strip():
                continue
            width, is_pair, _, path = line.strip().split(",", 3)
            if int(is_pair) or int(width) not in NN_WIDTHS:
                continue
            quantized[int(width)] = pnn_q.load_quantized(os.path.join(
                os.path.dirname(FROZEN_MANIFEST), os.path.basename(path)))
    arch = {w: str(q["kind"]) == "fc" for w, q in quantized.items()}
    return nn_intra.PnnBundle({}, arch, mean, quantized=quantized)


def save_bundle(bundle, path):
    """The bundle's quantized models and mean as one npz: keys
    "<width>/<name>", plus "mean"."""
    flat = {"mean": np.float64(bundle.mean_training)}
    for w, q in bundle.quantized.items():
        for k, v in q.items():
            flat[f"{w}/{k}"] = np.asarray(v)
    np.savez_compressed(path, **flat)


def pnn_pus(trees, policy, nn_widths):
    """PUs coded with the PNN mode: mode 35 under switch, mode 18 at a
    width with a model under substitution."""
    count = 0
    stack = list(trees)
    while stack:
        node = stack.pop()
        stack.extend(node.children)
        for pu in node.pus:
            if policy == "switch" and pu.mode == 35:
                count += 1
            elif (policy == "substitution" and pu.mode == 18
                  and pu.n in nn_widths):
                count += 1
    return count


def nn_encode(frame, qp, policy, bundle, rate_evolve):
    """One JAX encode: live with the default CPU path (rate evolution off),
    or op by op through the fused twin (rate evolution on)."""
    import contextlib

    import jax
    import jax.numpy as jnp

    from context_adaptive_neural_network_based_prediction_tpu.parallel import (
        wavefront2)

    if rate_evolve:
        os.environ["CANP_FUSED_UNIT"] = "xla"
    else:
        os.environ.pop("CANP_FUSED_UNIT", None)
    wavefront2._W2_CACHE.clear()
    h, w = frame.shape
    run = wavefront2._jitted_wavefront2(h, w, qp, policy=policy,
                                        bundle=bundle, ctb=CTB,
                                        enable_nxn=True,
                                        rate_evolve=rate_evolve)
    with jax.disable_jit() if rate_evolve else contextlib.nullcontext():
        recon, ys = run(jnp.asarray(frame))
        recon = np.asarray(recon)
    wavefront2._W2_CACHE.clear()
    grids = wavefront2._assemble_arrays(ys, h, w, CTB)
    res = wavefront2._arrays_to_result(frame, qp, (recon,) + grids, policy,
                                       True, ctb=CTB)
    out = digests(recon, grids, res.bitstream)
    widths = [w_ for w_ in bundle.quantized if w_ in NN_WIDTHS]
    out["pnn_pus"] = pnn_pus(res.ctu_trees, policy, widths)
    return out


def capture_nn(out_path):
    frames = test_frames()
    bundles = {"random": random_bundle(), "frozen_singles": frozen_bundle()}
    save_bundle(bundles["random"], NN_BUNDLE)
    result = {"config": {"ctb": CTB, "enable_nxn": True},
              "bundles": {
                  "random": {"file": os.path.relpath(NN_BUNDLE, REPO),
                             "mean": 117.9, "widths": [8, 16]},
                  "frozen_singles": {
                      "manifest": os.path.relpath(FROZEN_MANIFEST, REPO),
                      "mean": bundles["frozen_singles"].mean_training,
                      "widths": list(NN_WIDTHS), "use_pair": False}},
              "encodes": {}}

    def add(name, bundle_name, policy, qp, rate_evolve):
        t0 = time.time()
        d = nn_encode(frames[name], qp, policy, bundles[bundle_name],
                      rate_evolve)
        d.update(frame=name, bundle=bundle_name, policy=policy, qp=qp,
                 rate_evolve=rate_evolve,
                 impl="xla" if rate_evolve else "default")
        key = f"{name}/{policy}/{'rate_evolve' if rate_evolve else 'live'}"
        result["encodes"][key] = d
        print(f"{key}: QP {qp}, {time.time() - t0:.1f} s, "
              f"{d['stream_len']} bytes, {d['pnn_pus']} PNN PUs", flush=True)
        return d

    for policy in ("switch", "substitution"):
        add("synth64x96", "random", policy, NN_QP_SYNTH, False)
    for qp in NN_QPS_NATURAL:
        d = add("natural128", "frozen_singles", "switch", qp, False)
        if d["pnn_pus"] > 0:
            break
    else:
        raise SystemExit("no QP of (32, 37) codes a PNN PU on natural128")
    add("natural128", "frozen_singles", "substitution", qp, False)
    add("synth64x96", "random", "switch", NN_QP_SYNTH, True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1, sort_keys=True)
        f.write("\n")
    print("wrote", out_path)


def capture_rate_evolve(out_path):
    import jax
    import jax.numpy as jnp

    from context_adaptive_neural_network_based_prediction_tpu.parallel import (
        wavefront2)

    os.environ["CANP_FUSED_UNIT"] = "xla"
    result = {"config": {"policy": "regular", "qp": QP, "ctb": CTB,
                         "enable_nxn": True, "rate_evolve": True,
                         "impl": "xla"},
              "frames": {}}
    for name, frame in test_frames().items():
        # The fused impl is read at build time but is not in the cache key.
        wavefront2._W2_CACHE.clear()
        t0 = time.time()
        h, w = frame.shape
        run = wavefront2._jitted_wavefront2(h, w, QP, ctb=CTB,
                                            enable_nxn=True, rate_evolve=True)
        with jax.disable_jit():
            recon, ys = run(jnp.asarray(frame))
            recon = np.asarray(recon)
        grids = wavefront2._assemble_arrays(ys, h, w, CTB)
        res = wavefront2._arrays_to_result(frame, QP, (recon,) + grids,
                                           "regular", True, ctb=CTB)
        result["frames"][name] = digests(recon, grids, res.bitstream)
        print(f"{name}: {time.time() - t0:.1f} s, "
              f"{len(res.bitstream)} bytes", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1, sort_keys=True)
        f.write("\n")
    print("wrote", out_path)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--set", choices=("rate_evolve", "nn", "all"),
                    default="all")
    ap.add_argument("--out", default=None,
                    help="output path (one set only)")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.set in ("rate_evolve", "all"):
        capture_rate_evolve(args.out or OUT)
    if args.set in ("nn", "all"):
        capture_nn(args.out or NN_OUT)


if __name__ == "__main__":
    main()
