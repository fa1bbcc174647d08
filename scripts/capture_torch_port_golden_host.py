"""Capture the JAX package's digests for the port's host RDO codec.

Writes `tests/golden_torch/host_codec.json` and `host_codec.npz` from the
JAX package on the CPU, for the cases of the port's
`evaluation/host_cases.py` (which `chip_smoke.py` phase 18 and the CPU
tests read):

* `encodes`: `codec/encoder.encode_frame` with the defaults (CTB 64, RDOQ,
  sign hiding, transform skip, deblocking, SAO) of the natural 128x128
  frame and the 96x160 frame of `tests/golden_hm/`, `regular`, `switch`
  and `substitution` at QP 27 (singles) and 37 (pairs) with the whole
  quantized zoo (`artifacts/frozen/qpnn_w{4..64}_{single,pair}.npz`, the
  mean of `artifacts/training_set/luminance/means/mean_training.pkl`):
  the sha256 of the stream, the reconstruction (uint8) and the mode map
  (int32), the stream length and the PUs coded with the PNN.
* `annexb`: `hm_encoder.encode_frame_hm` (regular and switch, QP 32) and
  `encode_frame_hm_420` (regular, QP 32) of the natural frame: the sha256
  of the stream, of each plane and of the mode map.  The 4:2:0 case's
  chroma planes (`host_cases.chroma_planes`, seed 5) go into the npz.
* `rd`: `evaluation/performance.compute_rate_psnr` (Annex-B rate, QP 22 /
  27 / 32 / 37) of the natural frame, regular and switch, each point's
  rate and PSNR, and `bd_rate_low_high_full` of switch against regular.
* `float`: a switch encode of the natural frame at QP 37 with the float
  models of `artifacts/frozen/manifest_trained.txt` only, at the widths
  of `host_cases.FLOAT_WIDTHS` (the fallback's forward), its digests; on
  the card the float kernels differ from the JAX forward in the last
  bits, so the smoke requires this entry only where no coded PNN unit
  had a pixel within the float tolerance of a rounding tie.

Usage:  JAX_PLATFORMS=cpu python scripts/capture_torch_port_golden_host.py
            [--set encodes|annexb|rd|float|all]
(about six minutes on 8 CPU cores for all; a single set rewrites its own
entries and keeps the others of the existing file.)
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
FROZEN = os.path.join(REPO, "artifacts", "frozen")
WIDTHS = (4, 8, 16, 32, 64)

from context_adaptive_neural_network_based_prediction_tpu_torch.evaluation \
    import host_cases as hc  # noqa: E402


def sha(a) -> str:
    if isinstance(a, (bytes, bytearray)):
        return hashlib.sha256(bytes(a)).hexdigest()
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def pnn_pus(trees, policy) -> int:
    """PUs coded with the PNN: mode 35 under switch, mode 18 under
    substitution (every width has a model), none under regular."""
    mode = {"switch": 35, "substitution": 18}.get(policy)
    count, stack = 0, list(trees)
    while stack:
        node = stack.pop()
        if node is None:
            continue
        stack.extend(node.children)
        count += sum(pu.mode == mode for pu in node.pus)
    return count


def jax_zoo(mean):
    from context_adaptive_neural_network_based_prediction_tpu.codec import (
        nn_intra)
    from context_adaptive_neural_network_based_prediction_tpu.models import (
        pnn_q)

    single = {w: pnn_q.load_quantized(os.path.join(
        FROZEN, f"qpnn_w{w}_single.npz")) for w in WIDTHS}
    pair = {w: pnn_q.load_quantized(os.path.join(
        FROZEN, f"qpnn_w{w}_pair.npz")) for w in WIDTHS}
    return nn_intra.PnnBundle(
        {}, {w: str(q["kind"]) == "fc" for w, q in single.items()}, mean,
        quantized=single, pair_quantized=pair)


def jax_float_bundle(mean):
    """The float models of `MANIFEST_TRAINED` at `FLOAT_WIDTHS`, read by
    file name (the manifest names absolute paths)."""
    from context_adaptive_neural_network_based_prediction_tpu.codec import (
        nn_intra)
    from context_adaptive_neural_network_based_prediction_tpu.models import (
        zoo)

    single, pair = {}, {}
    with open(hc.MANIFEST_TRAINED) as f:
        for line in f:
            if not line.strip():
                continue
            width, is_pair, _, path = line.strip().split(",", 3)
            if int(width) not in hc.FLOAT_WIDTHS:
                continue
            params, _ = zoo.load_frozen_params(
                os.path.join(FROZEN, os.path.basename(path)))
            (pair if int(is_pair) else single)[int(width)] = params
    return nn_intra.PnnBundle(
        single, {w: "fully_connected" in p for w, p in single.items()},
        mean, pair_params=pair)


def digests(res, stream=None) -> dict:
    stream = res.bitstream if stream is None else stream
    return {"stream": sha(stream), "stream_len": len(stream),
            "recon": sha(np.asarray(res.reconstruction, np.uint8)),
            "mode_map": sha(np.asarray(res.mode_map, np.int32))}


def capture_encodes(predictor, t0):
    from context_adaptive_neural_network_based_prediction_tpu.codec import (
        encoder)

    out = {}
    for frame_name, policy, qp in hc.ENCODES:
        res = encoder.encode_frame(hc.load_frame(frame_name), qp,
                                   policy=policy, pnn=predictor(policy))
        out[f"{frame_name}/{policy}/q{qp}"] = dict(
            digests(res), pnn_pus=pnn_pus(res.ctu_trees, policy))
        print(f"{frame_name} {policy} QP {qp}: {len(res.bitstream)} bytes "
              f"({time.time() - t0:.0f} s)", flush=True)
    return out


def capture_annexb(predictor, t0, arrays):
    from context_adaptive_neural_network_based_prediction_tpu.codec import (
        hm_encoder)

    out = {}
    for name, frame_name, policy, qp, chroma in hc.ANNEXB:
        y = hc.load_frame(frame_name)
        if chroma:
            cb, cr = hc.chroma_planes(*y.shape, seed=5)
            arrays[f"{name}/cb_src"], arrays[f"{name}/cr_src"] = cb, cr
            stream, res, rec_cb, rec_cr = hm_encoder.encode_frame_hm_420(
                (y, cb, cr), qp, policy=policy, pnn=predictor(policy))
            out[name] = dict(digests(res, stream), recon_cb=sha(rec_cb),
                             recon_cr=sha(rec_cr))
        else:
            stream, res = hm_encoder.encode_frame_hm(
                y, qp, policy=policy, pnn=predictor(policy))
            out[name] = digests(res, stream)
        print(f"{name}: {len(stream)} bytes ({time.time() - t0:.0f} s)",
              flush=True)
    return out


def capture_rd(predictor, t0):
    from context_adaptive_neural_network_based_prediction_tpu.evaluation \
        import performance

    frame = hc.load_frame(hc.RD_FRAME)
    out, points = {}, {}
    for policy in hc.RD_POLICIES:
        points[policy] = [performance.compute_rate_psnr(
            frame, qp, policy=policy, pnn=predictor(policy),
            use_hm_container=True) for qp in hc.RD_QPS]
        out[policy] = [[p.qp, p.rate_bpp, p.psnr_db] for p in points[policy]]
    out["bd_switch_vs_regular"] = performance.bd_rate_low_high_full(
        points["regular"], points["switch"])
    print(f"RD sweep: {out['bd_switch_vs_regular']} "
          f"({time.time() - t0:.0f} s)", flush=True)
    return out


def capture_float(mean, t0):
    from context_adaptive_neural_network_based_prediction_tpu.codec import (
        encoder, nn_intra)

    frame_name, qp = hc.FLOAT_ENCODE
    res = encoder.encode_frame(
        hc.load_frame(frame_name), qp, policy="switch",
        pnn=nn_intra.PnnPredictor(jax_float_bundle(mean)))
    print(f"float switch: {len(res.bitstream)} bytes "
          f"({time.time() - t0:.0f} s)", flush=True)
    return {f"{frame_name}/switch/q{qp}": dict(
        digests(res), pnn_pus=pnn_pus(res.ctu_trees, "switch"))}


def main():
    import argparse

    from context_adaptive_neural_network_based_prediction_tpu.codec import (
        nn_intra)

    ap = argparse.ArgumentParser()
    ap.add_argument("--set", default="all",
                    choices=("encodes", "annexb", "rd", "float", "all"))
    which = ap.parse_args().set
    mean = hc.mean_training()
    bundle = jax_zoo(mean)

    def predictor(policy):
        return None if policy == "regular" else nn_intra.PnnPredictor(bundle)

    t0 = time.time()
    out = {"encodes": {}, "annexb": {}, "rd": {}, "float": {}}
    arrays = {}
    if which != "all":
        with open(hc.GOLDEN) as f:
            out = json.load(f)
        with np.load(hc.GOLDEN_NPZ) as z:
            arrays = {k: z[k] for k in z.files}
    out["config"] = {
        "zoo": "artifacts/frozen/qpnn_w{4,8,16,32,64}_{single,pair}.npz",
        "mean": mean, "frames": hc.FRAMES, "float_widths":
        list(hc.FLOAT_WIDTHS)}
    if which in ("encodes", "all"):
        out["encodes"] = capture_encodes(predictor, t0)
    if which in ("annexb", "all"):
        out["annexb"] = capture_annexb(predictor, t0, arrays)
    if which in ("rd", "all"):
        out["rd"] = capture_rd(predictor, t0)
    if which in ("float", "all"):
        out["float"] = capture_float(mean, t0)
    with open(hc.GOLDEN, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    np.savez_compressed(hc.GOLDEN_NPZ, **arrays)
    print(f"wrote {hc.GOLDEN} and {hc.GOLDEN_NPZ} "
          f"({time.time() - t0:.0f} s)")


if __name__ == "__main__":
    main()
