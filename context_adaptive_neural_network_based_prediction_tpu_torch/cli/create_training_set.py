"""Builds a training set and its channel mean with the port.

    python -m context_adaptive_neural_network_based_prediction_tpu_torch.cli.create_training_set \\
        --images 'images/*.png' --output-dir artifacts/training_set/luminance

The port of the JAX package's `cli/create_training_set.py` (`main` :20)
over the port's `data/datasets.py`: sharded crops or triplets of the
images' luminance (`--pair`: contexts compressed by the port's v1 encoder
on `--device`, default cuda) and the mean under `means/luminance/`.
"""

from __future__ import annotations

import argparse
import glob
import os

from ..data import datasets
from ..utils import parsing


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--images", required=True,
                   help="glob of RGB training images")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--width-target", type=int, default=None,
                   help="4 or 8 for offline triplets; omit for 320x320 crops")
    p.add_argument("--pair", action="store_true",
                   help="compress the contexts with the port's v1 encoder")
    p.add_argument("--shards", type=parsing.int_strictly_positive, default=4)
    p.add_argument("--triplets-per-image", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device of the pair mode's encoder")
    args = p.parse_args(argv)

    paths = sorted(glob.glob(args.images))
    if not paths:
        raise SystemExit(f"no images match {args.images}")
    n = datasets.create_training_shards(
        paths, args.output_dir, width_target=args.width_target,
        nb_shards=args.shards, triplets_per_image=args.triplets_per_image,
        is_pair=args.pair, device=args.device)
    mean = datasets.compute_luminance_mean(paths)
    mean_path = datasets.save_mean_training(
        mean, os.path.join(args.output_dir, "means", "luminance"))
    print(f"wrote {n} examples under {args.output_dir}; mean {mean:.4f} -> "
          f"{mean_path}")


if __name__ == "__main__":
    main()
