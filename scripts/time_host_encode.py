"""Seconds of one host RDO encode on the CPU, with the encoder's choices
of implementation and with their alternatives.

`codec/encoder.encode_frame` (regular policy, defaults, QP 27) of the
natural 128x128 frame of `tests/golden_hm/`, timed (best of `--reps`) in
three variants, each at torch's default thread count and at one thread:

* `shipped`: the numpy 35-mode sweep (`ops/intra.predict_all_modes_np`)
  and the native coefficient count (`rdo.BitCounter.count_coefficients`);
* `torch_sweep`: `ops/intra.predict_all_modes` on CPU tensors in place of
  the numpy sweep;
* `python_count`: the coefficient bins counted in Python
  (`syntax.encode_coefficients` through `BitCounter`).

Every variant must give the same stream.  One JSON line per variant and
thread count.

Usage:  python scripts/time_host_encode.py [--reps 2] [--qp 27]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from context_adaptive_neural_network_based_prediction_tpu_torch.codec import (  # noqa: E402
    encoder, rdo, syntax)
from context_adaptive_neural_network_based_prediction_tpu_torch.evaluation \
    import host_cases  # noqa: E402
from context_adaptive_neural_network_based_prediction_tpu_torch.ops import (  # noqa: E402
    intra)


def torch_sweep(ref_top, ref_left):
    return intra.predict_all_modes(torch.from_numpy(ref_top),
                                   torch.from_numpy(ref_left)).numpy()


def python_count(self, ctx, coeffs, mode, sign_hiding=False,
                 channel=syntax.LUMA):
    syntax.encode_coefficients(self, ctx, coeffs, mode, sign_hiding,
                               channel=channel)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--qp", type=int, default=27)
    args = ap.parse_args()
    frame = host_cases.load_frame("natural128")
    shipped = (intra.predict_all_modes_np, rdo.BitCounter.count_coefficients)
    variants = {"shipped": shipped,
                "torch_sweep": (torch_sweep, shipped[1]),
                "python_count": (shipped[0], python_count)}
    default_threads = torch.get_num_threads()
    encoder.encode_frame(frame, args.qp, device="cpu")     # warm the caches
    streams = set()
    for threads in (default_threads, 1):
        torch.set_num_threads(threads)
        for name, (sweep, count) in variants.items():
            intra.predict_all_modes_np = sweep
            rdo.BitCounter.count_coefficients = count
            try:
                best = float("inf")
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    res = encoder.encode_frame(frame, args.qp, device="cpu")
                    best = min(best, time.perf_counter() - t0)
            finally:
                intra.predict_all_modes_np = shipped[0]
                rdo.BitCounter.count_coefficients = shipped[1]
            streams.add(res.bitstream)
            print(json.dumps({"variant": name, "torch_threads": threads,
                              "qp": args.qp, "seconds": round(best, 3),
                              "bytes": len(res.bitstream)}), flush=True)
    if len(streams) != 1:
        raise AssertionError("the variants' streams differ")
    torch.set_num_threads(default_threads)
    return 0


if __name__ == "__main__":
    sys.exit(main())
