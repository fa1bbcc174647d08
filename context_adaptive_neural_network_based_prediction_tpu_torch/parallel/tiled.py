"""Spatially sharded frame encoding: stripes of a frame over the ranks of
a mesh dim.

The port of the JAX package's `parallel/tiled.py` (`encode_frame_tiled`
:27, `encode_frame_tiled_halo` :69, `encode_frame_tiled_halo_v2` :114).
The JAX package runs each stripe on a device of one SPMD program
(`shard_map`); here every rank of the mesh dim `axis` (`parallel/mesh.py`)
calls the same function with the same frame, encodes its stripe (rank d,
stripe d) on its device, and gets the whole result back: the stripes are
gathered and assembled on every rank, as JAX returns global arrays, so
every rank returns equal arrays, trees and bytes.

* `encode_frame_tiled`: independent stripes (HM tile semantics), each the
  v1 uniform-grid encode of its stripe alone (`parallel/wavefront.py`).
* `encode_frame_tiled_halo`: the v1 encode on the global wavefront
  schedule with the halo row exchanged after every step; equal to the
  single-device `wavefront.encode_frame_wavefront` of the frame.
* `encode_frame_tiled_halo_v2`: the quadtree encoder
  (`parallel/wavefront2.py`, CTB 32, regular, substitution and switch)
  with the bottom CTB row of reconstruction exchanged after every step;
  recon, every grid and the stream equal the single-device
  `encode_frame_wavefront2`.  On the card every rank launches the unit
  trial kernel, and under the NN policies the integer merger.
"""

from __future__ import annotations

import numpy as np
import torch

from . import mesh as mesh_mod
from . import wavefront, wavefront2


def _stripe(frame_uint8, mesh, axis, unit, what):
    """(this rank's stripe, its index, the stripe count, the dim's
    group); raises unless the frame splits into stripes of whole
    `unit`-sized blocks."""
    frame = np.asarray(frame_uint8)
    h, w = frame.shape
    n_tiles = mesh_mod.axis_size(mesh, axis)
    if h % (n_tiles * unit) or w % unit:
        raise ValueError(what)
    d = mesh.get_local_rank(axis)
    tile_h = h // n_tiles
    return (frame[d * tile_h:(d + 1) * tile_h], d, n_tiles,
            mesh.get_group(axis))


def _gather_grids(arrays, group):
    """Every rank's (recon, modes, qcoeffs) stacked in stripe order."""
    parts = mesh_mod.all_gather_arrays(arrays, group)
    return tuple(np.concatenate([p[i] for p in parts], axis=0)
                 for i in range(len(arrays)))


def encode_frame_tiled(frame_uint8: np.ndarray, qp: int, mesh, *,
                       block_size: int = 16, axis: str = "data",
                       device="cuda"):
    """Encodes the stripes of `mesh` dim `axis` independently, each like
    a picture of its own (HM tile semantics).  Returns (reconstruction
    (H, W) uint8, modes (nby, nbx) int32, qcoeffs (nby, nbx, n, n) int32)
    on every rank."""
    stripe, _, _, group = _stripe(
        frame_uint8, mesh, axis, block_size,
        "frame height must split into tile stripes of whole blocks")
    recons, modes, qcoeffs = wavefront.encode_frames_wavefront_batch(
        stripe[None], qp, block_size=block_size, device=device)
    recon, modes, qcoeffs = _gather_grids(
        [recons[0], modes[0], qcoeffs[0]], group)
    return recon.astype(np.uint8), modes, qcoeffs


def encode_frame_tiled_halo(frame_uint8: np.ndarray, qp: int, mesh, *,
                            block_size: int = 16, axis: str = "data",
                            device="cuda"):
    """The v1 encode of the stripes of `mesh` dim `axis` on the global
    schedule, the bottom pixel row of each stripe sent to the next after
    every step.  Returns (reconstruction, modes, qcoeffs) equal to
    `wavefront.encode_frame_wavefront`'s for the whole frame, on every
    rank."""
    stripe, _, _, group = _stripe(
        frame_uint8, mesh, axis, block_size,
        "frame height must split into tile stripes of whole blocks")
    recon, modes, qcoeffs = wavefront.encode_stripe_halo(
        stripe, qp, group, block_size=block_size, device=device)
    recon, modes, qcoeffs = _gather_grids([recon, modes, qcoeffs], group)
    return recon.astype(np.uint8), modes, qcoeffs


def encode_frame_tiled_halo_v2(frame_uint8: np.ndarray, qp: int, mesh, *,
                               axis: str = "data", policy: str = "regular",
                               pnn=None, serialize: bool = False,
                               device="cuda"):
    """The quadtree encode (CTB 32) of the stripes of CTB rows of `mesh`
    dim `axis` on the global schedule, each stripe's bottom CTB row of
    reconstruction sent to the next after every step (a whole CTB row:
    PNN contexts reach n rows above a unit).  Returns the `EncodeResult`
    of the single-device `encode_frame_wavefront2` (bitstream empty
    unless `serialize`), on every rank."""
    ctb = wavefront2.CTB
    stripe, _, n_tiles, group = _stripe(
        frame_uint8, mesh, axis, ctb,
        "frame must split into whole-CTB-row stripes per device")
    frame = np.asarray(frame_uint8)
    tile_h, w = stripe.shape
    recon, ys = wavefront2.encode_stripe_halo(
        stripe, qp, group, policy=policy, pnn=pnn, device=device)
    keys = sorted(ys)
    parts = mesh_mod.all_gather_arrays([recon] + [ys[k] for k in keys],
                                       group)
    # Stripe d ran the global schedule from step 2 * d * sby_local on.
    sby_local = tile_h // ctb
    grids_d = [wavefront2._assemble_arrays(
        dict(zip(keys, part[1:])), tile_h, w, ctb,
        t_offset=2 * sby_local * d) for d, part in enumerate(parts)]
    grids = tuple(np.concatenate([g[i] for g in grids_d], axis=0)
                  for i in range(len(grids_d[0])))
    arrays = (np.concatenate([p[0] for p in parts], axis=0),) + grids
    return wavefront2._arrays_to_result(frame, qp, arrays, policy, serialize)


def encode_cases(cases):
    """Runs tiled encodes on a mesh of every rank of the group, one dim
    "data": `cases` is a list of (function name of this module, frame,
    qp, keyword arguments).  Returns (the results in order, this rank's
    kernel launches per kernel over the cases).  The rank function of
    `mesh.spawn_ranks` for the tests, the dry run and the smoke."""
    from ..ops import merger_int, unit_fused

    for mod in (unit_fused, merger_int):
        mod.reset_launch_counts()
    mesh = mesh_mod.make_mesh({"data": torch.distributed.get_world_size()})
    out = [globals()[name](frame, qp, mesh, **kwargs)
           for name, frame, qp, kwargs in cases]
    launches = {"unit_trial": dict(unit_fused.launches),
                "merger_int": dict(merger_int.launches)}
    return out, launches
