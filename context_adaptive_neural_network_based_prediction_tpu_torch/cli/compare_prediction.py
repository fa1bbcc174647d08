"""PNN vs best-HEVC-mode prediction benchmark (Tables I-V), on the card.

The port of the JAX package's `cli/compare_prediction.py` (`main` :20) for
`.npz` checkpoints: draws random block positions on test images, predicts
with the PNN under each mask configuration against the max-PSNR sweep over
the 35 HEVC modes, and writes a CSV.

    python -m context_adaptive_neural_network_based_prediction_tpu_torch.cli.compare_prediction \\
        8 --images 'kodak/*.png' --checkpoint artifacts/frozen/pnn_w8_fc_single.npz

`--device cpu` runs the plain PyTorch versions instead of the kernels;
`--ipfcn-caffemodel` adds the IPFCN-S baseline's PSNR (its caffemodel read
without pycaffe).
"""

from __future__ import annotations

import argparse
import glob

import numpy as np

from ..evaluation import prediction_comparison as pc
from ..models import importer
from ..utils import color, images, parsing


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("width_target", type=parsing.int_strictly_positive)
    p.add_argument("--images", required=True,
                   help="glob of test RGB images (e.g. 'kodak/*.png')")
    p.add_argument("--checkpoint", required=True,
                   help="frozen .npz of the PNN")
    p.add_argument("--mean", type=float, default=117.8952234192841)
    p.add_argument("--positions-per-image", type=int, default=40)
    p.add_argument("--crop", type=int, default=512)
    p.add_argument("--output",
                   default="results/checking_predictions/table.csv")
    p.add_argument("--ipfcn-caffemodel",
                   help="optional IPFCN-S .caffemodel (read without pycaffe)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions)")
    args = p.parse_args(argv)

    paths = sorted(glob.glob(args.images))
    if not paths:
        raise SystemExit(f"no images match {args.images}")
    chans = []
    for path in paths:
        rgb = images.read_image_mode(path, "RGB")
        luma = color.rgb_to_ycbcr(rgb)[:, :, 0:1]
        c = args.crop
        if luma.shape[0] >= c and luma.shape[1] >= c:
            chans.append(luma[:c, :c])
    if not chans:
        raise SystemExit(f"no image of {args.images} is at least "
                         f"{args.crop} x {args.crop}")
    channels = np.stack(chans)

    if args.checkpoint.endswith(".npz"):
        params = importer.load_npz_params(args.checkpoint)
    else:
        params = importer.import_tf_checkpoint(args.checkpoint)
    is_fc = "fully_connected" in params

    ipfcn_params = None
    if args.ipfcn_caffemodel:
        from ..models import ipfcn

        ipfcn_params = ipfcn.import_caffemodel(args.ipfcn_caffemodel)

    rows = pc.compare_on_channels(
        channels, args.width_target, params, is_fc, args.mean,
        nb_positions_per_image=args.positions_per_image,
        ipfcn_params=ipfcn_params, device=args.device)
    pc.write_csv(rows, args.output)
    for r in rows:
        print(f"masks ({r.width_mask_above},{r.height_mask_left}): "
              f"PNN {r.mean_psnr_pnn:.2f} dB  best-HEVC "
              f"{r.mean_psnr_hevc_best:.2f} dB  "
              f"win {100 * r.pnn_win_frequency:.1f}%")
    print(f"csv -> {args.output}")


if __name__ == "__main__":
    main()
