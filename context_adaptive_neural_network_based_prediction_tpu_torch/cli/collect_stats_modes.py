"""Mode-frequency statistics over test images (the reference's
`collecting_stats_hevc_modes.py`).

    python -m context_adaptive_neural_network_based_prediction_tpu_torch.cli.collect_stats_modes \\
        --images 'images/*.png' --output-dir results/stats_modes

The port of the JAX package's `cli/collect_stats_modes.py` (`main` :20):
the luma of each RGB image, cropped, is encoded at each QP by the host
RDO encoder (`codec/encoder.encode_frame`), and the per-width counts of
the RD-winning modes (`evaluation/stats.py`) are saved as
`mode_counts_qp<QP>.npy` beside a bar plot.  As in the JAX package, every
image is encoded with the regular policy whatever `--policy` says (the
policy only titles the plot).  `--device` picks the torch device (default
cuda).
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from ..codec import encoder
from ..evaluation import stats
from ..utils import color, images


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--images", required=True, help="glob of RGB images")
    p.add_argument("--qps", type=int, nargs="+",
                   default=list(stats.QPS_STATS))
    p.add_argument("--policy", default="regular",
                   choices=["regular", "substitution", "switch"])
    p.add_argument("--crop", type=int, default=256)
    p.add_argument("--output-dir", default="results/stats_modes")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    paths = sorted(glob.glob(args.images))
    if not paths:
        raise SystemExit(f"no images match {args.images}")
    for qp in args.qps:
        results = []
        for path in paths:
            rgb = images.read_image_mode(path, "RGB")
            luma = color.rgb_to_ycbcr(rgb)[:args.crop, :args.crop, 0]
            luma = luma[: (luma.shape[0] // 8) * 8,
                        : (luma.shape[1] // 8) * 8]
            results.append(encoder.encode_frame(luma, qp,
                                                device=args.device))
        counts = stats.accumulate_over_images(results)
        png = os.path.join(args.output_dir, f"mode_freq_qp{qp}.png")
        stats.plot_mode_frequencies(counts, png,
                                    title=f"QP {qp} ({args.policy})")
        np.save(os.path.join(args.output_dir, f"mode_counts_qp{qp}.npy"),
                counts)
        print(f"QP {qp}: total PUs {counts.sum()}, plots -> {png}")


if __name__ == "__main__":
    main()
