"""Colored intra-mode maps across policies and QPs (the reference's
`comparing_maps_modes.py`).

    python -m context_adaptive_neural_network_based_prediction_tpu_torch.cli.compare_maps_modes \\
        image.png --qps 22 37 --output-dir results/map_modes

The port of the JAX package's `cli/compare_maps_modes.py` (`main` :17):
one luma image (`evaluation/hm_driver.load_luminance`) encoded by the host
RDO encoder at each QP under each policy, each mode map written as a
colored PPM (`evaluation/maps.py`); with `--hm-bitstream` the input is an
Annex-B HEVC stream, decoded by the port's HM-syntax decoder, whose modes
are mapped.  `--device` picks the torch device (default cuda).
"""

from __future__ import annotations

import argparse
import os

from ..codec import encoder
from ..evaluation import maps
from ..evaluation.hm_driver import load_luminance


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("input", help="image or .yuv")
    p.add_argument("--height", type=int)
    p.add_argument("--width", type=int)
    p.add_argument("--qps", type=int, nargs="+", default=[22, 27, 32, 37, 42])
    p.add_argument("--policies", nargs="+", default=["regular"],
                   choices=["regular", "substitution", "switch"])
    p.add_argument("--output-dir", default="results/map_modes")
    p.add_argument("--hm-bitstream", action="store_true",
                   help="input is a real HEVC Annex-B bitstream: decode it "
                        "with the HM-conformant decoder and map ITS modes")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    if args.hm_bitstream:
        from ..codec import hm_decoder

        with open(args.input, "rb") as f:
            res = hm_decoder.decode_hm_stream(f.read(), device=args.device)
        name = os.path.splitext(os.path.basename(args.input))[0]
        out = os.path.join(args.output_dir, f"map_modes_{name}_hm.ppm")
        os.makedirs(args.output_dir, exist_ok=True)
        maps.write_ppm(out, maps.mode_map_to_rgb(res.mode_map))
        print(f"HM stream (QP {res.qp}, hash_ok={res.hash_ok}) -> {out}")
        return

    luma = load_luminance(args.input, args.height, args.width)
    name = os.path.splitext(os.path.basename(args.input))[0]
    for policy in args.policies:
        for qp in args.qps:
            res = encoder.encode_frame(luma, qp, policy=policy,
                                       device=args.device)
            out = os.path.join(args.output_dir,
                               f"map_modes_qp_{qp}_{name}_{policy}.ppm")
            maps.write_mode_map(res, out)
            print(f"{policy} QP{qp} -> {out}")


if __name__ == "__main__":
    main()
