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
two packages start from different nets.

`--dp` / `--tp` above 1 train over a data x model mesh of ranks
(`parallel/sharded_training.train_sharded`, the JAX package's :44-66):
one process per rank, as `torchrun` starts them,

    torchrun --nproc-per-node 4 -m context_adaptive_neural_network_based_prediction_tpu_torch.cli.train_pnn \
        8 --shards ... --mean 86.8568 --dp 2 --tp 2

(or `parallel/mesh.spawn_ranks(train_pnn.main, 4, args=(argv,))`), where
dp x tp must equal the group's size.  Under `torchrun` the command
joins the group itself (`mesh.rank_placement`: NCCL where every local rank
has its own card, else Gloo, CUDA tensors copied to the host for each
collective).  As in
the JAX package, the sharded run draws random masks whatever `--masks`
says; rank 0 writes the snapshots.
"""

from __future__ import annotations

import argparse
import datetime
import os

import torch
import torch.distributed as dist

from ..models import training, zoo
from ..utils import parsing

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
                   help="data-parallel mesh width (ranks along 'data')")
    p.add_argument("--tp", type=parsing.int_strictly_positive, default=1,
                   help="tensor-parallel mesh width (ranks along 'model')")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    joined = _join_group(args) if args.dp * args.tp > 1 else False
    is_fc = args.arch == "fully_connected"
    w = args.width_target
    out_dir = zoo.model_directory(args.results_root, w, is_fc, args.pair,
                                  args.channel, args.coeff_l2,
                                  args.coeff_grad, args.masks)
    os.makedirs(out_dir, exist_ok=True)
    if args.dp * args.tp > 1:
        from ..parallel import mesh as mesh_mod, sharded_training

        dev = torch.device(args.device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        try:
            sharded_training.train_sharded(
                mesh_mod.make_mesh({"data": args.dp, "model": args.tp}),
                args.shards, w, is_fc, args.mean, out_dir, iters=args.iters,
                batch_size=args.batch_size, chunk=args.chunk,
                snapshot_every=args.snapshot_every, coeff_l2=args.coeff_l2,
                coeff_grad=args.coeff_grad,
                log=lambda m: print(m, flush=True), device=dev)
        finally:
            if joined:
                dist.destroy_process_group()
        return

    masks = args.masks if args.masks else (0, 0)

    def chunk_fn(state, mask_gen, above, left, target):
        return training.train_chunk(
            state, mask_gen, above, left, target, args.mean, masks,
            width_target=w, is_fully_connected=is_fc,
            coeff_l2=args.coeff_l2, coeff_grad=args.coeff_grad,
            random_masks=args.masks is None, total_iters=args.iters)

    training.run_training(
        out_dir, args.shards, w, iters=args.iters, batch_size=args.batch_size,
        chunk=args.chunk, snapshot_every=args.snapshot_every,
        init_state=lambda gen: training.init_state(
            gen, w, is_fc, total_iters=args.iters, device=args.device),
        state_from_blob=lambda blob: training.state_from_numpy(
            blob, args.device),
        chunk_fn=chunk_fn,
        save=lambda state, gen: training.save_checkpoint(state, out_dir,
                                                         gen),
        log=lambda msg: print(msg, flush=True))


def _join_group(args) -> bool:
    """Checks that the process group has dp x tp ranks, joining it first
    under `torchrun` (WORLD_SIZE in the environment); returns whether this
    call joined it.  Raises ValueError, before anything is written, where
    the sizes differ."""
    want = args.dp * args.tp
    if dist.is_initialized():
        world = dist.get_world_size()
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != want:
        raise ValueError(f"--dp {args.dp} x --tp {args.tp} needs {want} "
                         f"ranks; the process group has {world} (run under "
                         f"torchrun --nproc-per-node {want})")
    if dist.is_initialized():
        return False
    from ..parallel import mesh as mesh_mod

    backend, dev = mesh_mod.rank_placement(
        args.device, int(os.environ.get("LOCAL_RANK", "0")),
        int(os.environ.get("LOCAL_WORLD_SIZE", str(world))))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, timeout=datetime.timedelta(hours=1))
    return True


if __name__ == "__main__":
    main()
