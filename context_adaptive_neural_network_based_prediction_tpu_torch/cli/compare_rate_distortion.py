"""Rate-distortion comparison of the three codec policies (Tables IX-X;
the reference's `comparing_rate_distortion.py`).

    python -m context_adaptive_neural_network_based_prediction_tpu_torch.cli.compare_rate_distortion \\
        image.png --policies regular switch \\
        --pnn-manifest artifacts/frozen/manifest_trained.txt --mean 86.8568

The port of the JAX package's `cli/compare_rate_distortion.py` (`main`
:18): the first luma frame of an image or sequence encoded and decoded
at each QP of the reference protocol under each policy
(`evaluation/performance.compute_or_load_rates_psnrs`, cached), the
BD-rates of each NN policy against regular over the low / high / full
ranges, and the curves' plot.  The NN policies take the float single
models of `--pnn-manifest` (the `PnnPredictor`'s float forward).
`--device` picks the torch device (default cuda).
"""

from __future__ import annotations

import argparse
import os

from ..evaluation import performance
from ..evaluation.hm_driver import load_luminance


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("input", help=".yuv (known sequence or pass "
                                 "--height/--width) or image file")
    p.add_argument("--height", type=int)
    p.add_argument("--width", type=int)
    p.add_argument("--qps", type=int, nargs="+",
                   default=list(performance.QPS_RD))
    p.add_argument("--policies", nargs="+", default=["regular"],
                   choices=["regular", "substitution", "switch"])
    p.add_argument("--pnn-manifest", help="manifest of frozen .npz models")
    p.add_argument("--mean", type=float, default=117.8952234192841)
    p.add_argument("--cache-dir", default="results/rd_cache")
    p.add_argument("--output-dir", default="results/rate_distortion")
    p.add_argument("--wavefront", action="store_true",
                   help="use the wavefront encoder (regular only)")
    p.add_argument("--hm-container", action="store_true",
                   help="measure rates on standard Annex-B HEVC output "
                        "(NAL-exact comparison against HM binaries)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    luma = load_luminance(args.input, args.height, args.width)
    name = os.path.splitext(os.path.basename(args.input))[0]

    pnn = None
    if any(p_ != "regular" for p_ in args.policies):
        from ..codec.nn_intra import PnnBundle, PnnPredictor
        from ..models import importer
        from .export_pnn import parse_manifest

        table = parse_manifest(args.pnn_manifest)
        params = {w: importer.load_npz_params(path)
                  for (w, is_pair), path in table.items() if not is_pair}
        pnn = PnnPredictor(PnnBundle(None, args.mean, params=params),
                           device=args.device)

    all_points = {}
    for policy in args.policies:
        cache = os.path.join(args.cache_dir, f"{name}_{policy}.pkl")
        points = performance.compute_or_load_rates_psnrs(
            luma, args.qps, path_to_cache=cache, policy=policy, pnn=pnn,
            use_wavefront=args.wavefront and policy == "regular",
            use_hm_container=args.hm_container, device=args.device)
        all_points[policy] = points
        for pt in points:
            print(f"{policy} QP{pt.qp}: {pt.rate_bpp:.4f} bpp "
                  f"{pt.psnr_db:.2f} dB ({pt.encode_time_s:.1f}s)")

    if "regular" in all_points:
        for policy in args.policies:
            if policy == "regular":
                continue
            bd = performance.bd_rate_low_high_full(all_points["regular"],
                                                   all_points[policy])
            print(f"BD-rate {policy} vs regular: low {bd['low']:.2f}% "
                  f"high {bd['high']:.2f}% full {bd['full']:.2f}%")
    png = os.path.join(args.output_dir, f"{name}_rd.png")
    performance.plot_rate_distortion_curves(all_points, png, title=name)
    print(f"curves -> {png}")


if __name__ == "__main__":
    main()
