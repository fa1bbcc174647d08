"""Trains one PNN with the port (the reference's `training_pnn.py`).

    python -m context_adaptive_neural_network_based_prediction_tpu_torch.cli.train_pnn \\
        8 --arch fully_connected --shards artifacts/training_set/luminance \\
        --mean 86.8568 --iters 800000

The port of the JAX package's `cli/train_pnn.py` (`main` :20): the
shards feed `data/pipeline.TrainingPipeline` (on-the-fly extraction from
crops for widths >= 16), `--chunk` steps run in one `training.train_chunk`
call, a snapshot `model_<step>.ckpt.pkl` is written every
`--snapshot-every` steps and at the end, under the `zoo.model_directory`
of the run, and a run restarts from the newest snapshot there (params,
Adam state, step and the mask generator's state).  `--device` picks the
torch device (default cuda; cpu runs the same steps on the host).

The init and the random masks come from `torch.Generator`s seeded 0 and
1; the JAX package's `PRNGKey(0)` / `PRNGKey(1)` give other draws, so the
two packages start from different nets.  `--dp` / `--tp` above 1 (the JAX
package's data x tensor-parallel mesh) are refused: sharded training is
not ported (ROADMAP A8).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..data.pipeline import TrainingPipeline
from ..models import training, zoo
from ..utils import parsing

INIT_SEED, MASK_SEED = 0, 1


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("width_target", type=parsing.int_strictly_positive)
    p.add_argument("--arch", choices=("fully_connected", "convolutional"),
                   default="fully_connected")
    p.add_argument("--shards", required=True,
                   help="directory of training shards (thread_i/data_j.npz)")
    p.add_argument("--mean", type=float, required=True,
                   help="training mean intensity")
    p.add_argument("--results-root", default="pnn/results")
    p.add_argument("--channel", default="luminance")
    p.add_argument("--pair", action="store_true")
    p.add_argument("--coeff-l2", type=parsing.float_positive, default=1.0)
    p.add_argument("--coeff-grad", type=parsing.float_positive, default=0.0)
    p.add_argument("--masks", type=parsing.tuple_two_positive_integers,
                   default=None, help='"wa,hl" fixed masks; omit for random')
    p.add_argument("--batch-size", type=parsing.int_strictly_positive,
                   default=100)
    p.add_argument("--iters", type=parsing.int_strictly_positive,
                   default=training.NB_ITERS_TRAINING)
    p.add_argument("--snapshot-every", type=parsing.int_strictly_positive,
                   default=10_000)
    p.add_argument("--chunk", type=parsing.int_strictly_positive, default=100,
                   help="training steps per train_chunk call")
    p.add_argument("--dp", type=parsing.int_strictly_positive, default=1,
                   help="data-parallel width (only 1: not ported)")
    p.add_argument("--tp", type=parsing.int_strictly_positive, default=1,
                   help="tensor-parallel width (only 1: not ported)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    if args.dp * args.tp > 1:
        raise NotImplementedError(
            f"--dp {args.dp} --tp {args.tp}: sharded training over several "
            f"devices is not ported to the PyTorch port yet (ROADMAP A8); "
            f"run with --dp 1 --tp 1")
    is_fc = args.arch == "fully_connected"
    w = args.width_target
    out_dir = zoo.model_directory(args.results_root, w, is_fc, args.pair,
                                  args.channel, args.coeff_l2,
                                  args.coeff_grad, args.masks)
    os.makedirs(out_dir, exist_ok=True)

    mask_gen = torch.Generator().manual_seed(MASK_SEED)
    ckpt, start = training.find_latest_checkpoint(out_dir)
    if ckpt:
        state = training.restore_checkpoint(ckpt, w, device=args.device,
                                            generator=mask_gen)
        print(f"resumed from {ckpt} (step {start})", flush=True)
    else:
        state = training.init_state(
            torch.Generator().manual_seed(INIT_SEED), w, is_fc,
            total_iters=args.iters, device=args.device)

    pipe = TrainingPipeline(args.shards, args.batch_size, w,
                            is_extraction_on_the_fly=(w >= 16))
    batches = pipe.batches()
    masks = args.masks if args.masks else (0, 0)
    t0 = time.time()
    it = int(state.step)
    while it < args.iters:
        k = min(args.chunk, args.iters - it)
        stacked = [next(batches) for _ in range(k)]
        above, left, target = (np.stack([b[i] for b in stacked])
                               for i in range(3))
        state, losses = training.train_chunk(
            state, mask_gen, above, left, target, args.mean, masks,
            width_target=w, is_fully_connected=is_fc,
            coeff_l2=args.coeff_l2, coeff_grad=args.coeff_grad,
            random_masks=args.masks is None, total_iters=args.iters)
        it += k
        print(f"step {it}: loss {float(losses[-1]):.3f} "
              f"({(it - int(start)) / (time.time() - t0):.1f} it/s)",
              flush=True)
        if it % args.snapshot_every == 0 or it == args.iters:
            path = training.save_checkpoint(state, out_dir, mask_gen)
            print(f"snapshot {path}", flush=True)


if __name__ == "__main__":
    main()
