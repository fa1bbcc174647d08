"""The multi-rank dry run: the sharded paths on n ranks at tiny shapes.

The twin of the JAX package's `__graft_entry__.dryrun_multichip`
(:34-133).  `dryrun_multichip(n_ranks, device)` starts n ranks on
`device` (`mesh.spawn_ranks`) and runs, in order:

1. the DP x TP training chunk (`sharded_training.run_sharded_demo_step`)
   of the w8 FC and the w4 conv PNN on a {"data": n / tp, "model": tp}
   mesh (tp = 2 where n is even), each with a finite loss;
2. the independent-stripe v1 encode (`tiled.encode_frame_tiled`) of an
   (16 n) x 32 frame over every rank;
3. the v1 halo encode (`tiled.encode_frame_tiled_halo`) of that frame,
   equal to the single-device `wavefront.encode_frame_wavefront`;
4. the quadtree halo encode (`tiled.encode_frame_tiled_halo_v2`) under
   `switch` with a random quantized w8 conv bundle on a (32 n) x 64
   frame, equal to the single-device `encode_frame_wavefront2`, stream
   included.

The JAX package runs step 4 on two of its devices; here every rank takes
a stripe.  Nothing is re-homed: n ranks on the given device type are the
point of the run.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codec import nn_intra
from ..models import pnn
from . import mesh as mesh_mod
from . import sharded_training, tiled, wavefront, wavefront2


def _dryrun_rank(n_ranks: int, device):
    """One rank's dry run; raises on the first failed check.  Returns
    (FC loss, conv loss), read by the caller from rank 0."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    model_par = 2 if n_ranks % 2 == 0 else 1
    data_par = n_ranks // model_par
    mesh = mesh_mod.make_mesh({"data": data_par, "model": model_par})
    loss_fc = sharded_training.run_sharded_demo_step(
        mesh, width_target=8, is_fully_connected=True,
        batch_size=2 * data_par, device=dev)
    loss_conv = sharded_training.run_sharded_demo_step(
        mesh, width_target=4, is_fully_connected=False,
        batch_size=2 * data_par, device=dev)
    if not (np.isfinite(loss_fc) and np.isfinite(loss_conv)):
        raise AssertionError(f"non-finite sharded loss: FC {loss_fc}, "
                             f"conv {loss_conv}")

    enc_mesh = mesh_mod.make_mesh({"data": n_ranks})
    n = 16
    frame = np.random.default_rng(0).integers(0, 256, (n_ranks * n, 2 * n),
                                              dtype=np.uint8)
    recon, modes, _ = tiled.encode_frame_tiled(frame, 32, enc_mesh,
                                               block_size=n, device=dev)
    if recon.shape != frame.shape or modes.shape != (n_ranks, 2):
        raise AssertionError(f"tiled encode shapes {recon.shape}, "
                             f"{modes.shape}")
    h_recon, _, _ = tiled.encode_frame_tiled_halo(frame, 32, enc_mesh,
                                                  block_size=n, device=dev)
    single = wavefront.encode_frame_wavefront(frame, 32, serialize=False,
                                              device=dev)
    if not np.array_equal(h_recon, single.reconstruction):
        raise AssertionError("halo-exchange reconstruction diverged from "
                             "the single-device wavefront")

    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:n_ranks * 32, 0:64]
    f2 = np.clip(128 + 40 * np.sin(xx / 11.0) + 30 * np.cos(yy / 7.0)
                 + rng.normal(0, 6, (n_ranks * 32, 64)), 0, 255).astype(
                     np.uint8)
    params = {8: pnn.init_params(torch.Generator().manual_seed(1), 8, False)}
    bundle = nn_intra.PnnBundle(None, 117.9, params=params).quantize(
        n_samples=16, device=dev)
    sh2 = tiled.encode_frame_tiled_halo_v2(f2, 32, enc_mesh, policy="switch",
                                           pnn=bundle, serialize=True,
                                           device=dev)
    s2 = wavefront2.encode_frame_wavefront2(f2, 32, policy="switch",
                                            pnn=bundle, device=dev)
    if not np.array_equal(sh2.reconstruction, s2.reconstruction):
        raise AssertionError("wavefront2 halo reconstruction diverged from "
                             "the single-device encode")
    if sh2.bitstream != s2.bitstream:
        raise AssertionError("wavefront2 halo stream diverged from the "
                             "single-device encode")
    return loss_fc, loss_conv


def dryrun_multichip(n_ranks: int, device="cuda",
                     timeout: float = 600.0) -> None:
    """Runs the sharded paths on `n_ranks` spawned ranks of `device`
    (`mesh.rank_placement`: "cuda" puts rank r on card r under NCCL where
    there is a card for each, "cuda:k" puts every rank on card k under
    Gloo, "cpu" runs on the host) and prints one line; any failed check
    raises."""
    results = mesh_mod.spawn_ranks(_dryrun_rank, n_ranks, device=device,
                                   timeout=timeout,
                                   args=(n_ranks, str(device)))
    loss_fc, loss_conv = results[0]
    print(f"dryrun_multichip({n_ranks}, {device}): ok (fc loss "
          f"{loss_fc:.1f}, conv loss {loss_conv:.1f}, tiled encode "
          f"({16 * n_ranks}, 32), halo v1 bit-exact, halo v2+NN-switch "
          f"bit-exact incl. stream)", flush=True)
