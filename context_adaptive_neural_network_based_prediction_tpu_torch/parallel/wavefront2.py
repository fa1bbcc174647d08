"""Wavefront v2 quadtree encoder (CTB 32 or 64; regular, substitution and
switch policies; one frame or a batch of frames per call, and a streaming
encoder), with the framework container stream or a standard Annex-B HEVC
stream as output.

The port of the JAX package's `parallel/wavefront2.py` for the
configurations its benchmark and its rate-distortion measurements run.
CTBs run along anti-diagonals t = bx + 2*by; at each z-order sub-stage
every n x n unit of every CTB on the diagonal (one "slot" per CTB) is
tried at once by the fused unit trial (`ops/unit_fused.py`, on the card
the CUDA kernel of `ops/csrc/unit_trial.cu`).  The quadtree 32 -> 16 -> 8
(-> four 4x4 NxN PUs) is decided in the same pass, and with `rate_evolve`
(CTB 32 only, as in the JAX package) each CTB row carries live CABAC bin
counts that steer later trials (WPP-style).  At CTB 64 (HM's
intra_main_rext geometry) the CTB-32 body runs in each quadrant in
z-order, then a 64x64 2Nx2N candidate (one mode, four forced TU32s, each
mode with its own evolving patch) in plain PyTorch on the same device
(`_candidate64`).

NN policies (the JAX package's :974-1030): with `policy="substitution"`
mode 18's prediction is the PNN's, with `policy="switch"` the PNN is a
signalled 36th mode (PNNS, mode 35).  Each trial of a width with a model
first extracts every slot's masked context from the evolving
reconstruction (two box reads and static per-position strip masks) and
runs the quantized integer forward (`models/pnn_q.py`, its merger on the
card the CUDA kernel of `ops/csrc/merger_int.cu`) over all slots at once;
integer sums make that batched forward equal to the sequential decoder's.
Under switch a width without a model predicts zeros for PNNS.  The 64x64
candidate bars the PNN modes, as the JAX package does.

Skewed storage, as in the JAX package: the frame, the reconstruction, the
8x8 mode map, the 8x8 cell costs and the rate state are kept as per-CTB-
row planes with row `by` shifted right by 2*ctb*by, so a diagonal maps to
one column window across all planes and every commit is one box write over
the slot axis.  A batch of NF frames is interleaved into the plane axis
(plane `(ROW0 + by) * NF + f`, the JAX package's :271-280; not a loop
over frames): the slot axis holds b_eff = b_max * NF (slot, frame) pairs,
so every launch of a sub-stage carries the units of all NF frames.  Slots
that lie outside the frame write into margins that no valid read
touches.  The port updates these planes IN PLACE: the JAX
package slices a per-step working window out of the reconstruction and
writes its committed CTB column back at the end of the step; here the
window is a view of the plane, which saves that copy and gives the same
values, since every commit of a step lands inside that column.

`jax.lax.dynamic_slice` clamps a start index that would leave the buffer;
torch slicing does not.  The geometry margins (OFF, W_sk, WIN, PH) exist
so that no clamp happens, and `_box` asserts that no slice leaves its
buffer rather than quietly differing.

The decided mode / level / split grids are per-step outputs ("ys"),
assembled into grids on the host (`_assemble_arrays`), turned into CU
trees and packed by the native CABAC packer.  `encode_stream_wavefront2`
runs that host half of a batch after its device half.
`encode_frame_wavefront2_hm` writes the Annex-B stream instead, after
deblocking and SAO on the host (`codec/deblock.py`, `codec/sao.py`,
`codec/hm_encoder.py`).

Halo mode (the JAX package's `halo_axis` / `n_tiles`, :236-243, :261-271,
:379-388, :442-449, :850-855, :1449-1471; the tiled encoder
`parallel/tiled.encode_frame_tiled_halo_v2`): rank d of a process group
encodes stripe d of the frame's CTB rows on the global schedule, its step
t_loc = t - 2 * sby * d of the global step t, and stores its decisions at
the global step, so that `_assemble_arrays(..., t_offset=2 * sby * d)`
places them.  After every global step each rank sends its bottom
reconstruction plane down to rank d + 1 (`mesh.shift_down`), which puts
it into its plane 0 (the halo plane), rolled by -2 * ctb * sby along x
into its own skew frame.  The reference tables of stripes d > 0 are the
interior variants: those of a frame one CTB row taller, from its second
CTB row on, where the stripe's first row sees a coded row above.  A rank
skips the steps where its stripe has no CTB but takes part in every
exchange.  CTB 64, frame batches and rate evolution are refused under
halo, as in the JAX package; its `CANP_HALO_NOOP` timing probe (the
exchange left out, outputs wrong on purpose) is not ported.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import multiprocessing

import numpy as np
import torch

from ..codec import deblock, hm_encoder, native, rdo
from ..codec import encoder as enc_mod
from ..codec import sao as sao_mod
from ..models import pnn_q
from ..ops import intra, transform, unit_fused
from ..ops import reference_samples as rs
from ..utils.profiling import setup_span, span, traced
from . import mesh, rate_model

CTB = 32
NN_SIZES = (4, 8, 16, 32)   # unit sizes a PNN can serve at CTB 32
PADW = 32           # right margin of the skewed planes (NN context slices)
PNNS_MODE = enc_mod.PNNS_MODE   # the switch policy's PNN mode (mode 35)
ROW0 = 1            # plane 0 is the (zero) halo plane above the first row
RS_TMIN = 32        # rate-state bins needed before the live estimate counts


def _z_offsets(ctb: int, cell: int):
    """(dy, dx) of every `cell`-sized unit inside a `ctb` CTB, in z-order."""
    if ctb == cell:
        return [(0, 0)]
    out = []
    half = ctb // 2
    for q in range(4):
        qy, qx = (q >> 1) * half, (q & 1) * half
        out.extend((qy + dy, qx + dx) for dy, dx in _z_offsets(half, cell))
    return out


@functools.lru_cache(maxsize=None)
def _coding_order4(height: int, width: int, ctb: int = CTB):
    """Coding-order index of every 4x4 cell (CTB raster + z-order inside,
    down to 4x4 NxN-PU granularity)."""
    h4, w4 = height // 4, width // 4
    order = np.zeros((h4, w4), np.int64)
    idx = 0
    offs = _z_offsets(ctb, 4)
    for cy in range(0, height, ctb):
        for cx in range(0, width, ctb):
            for dy, dx in offs:
                order[(cy + dy) // 4, (cx + dx) // 4] = idx
                idx += 1
    return order


def _availability(height: int, width: int, n: int, ctb: int):
    """(nby, nbx, 4n/4 + 1) bool: HM's availability flags of every n x n
    block position in line order [left units bottom -> top, corner, above
    units left -> right].  A 4x4 unit is available iff it lies inside the
    picture and precedes the block in coding order."""
    nby, nbx = height // n, width // n
    yy = (np.arange(nby) * n)[:, None] + np.zeros((1, nbx), np.int64)
    xx = (np.arange(nbx) * n)[None, :] + np.zeros((nby, 1), np.int64)
    return rs.neighbor_unit_flags(_coding_order4(height, width, ctb), yy, xx,
                                  n, height, width)


@functools.lru_cache(maxsize=None)
def _fill_tables(height: int, width: int, n: int, ctb: int = CTB):
    """Per-position reference-sample gather tables for n x n blocks.

    Returns int32 arrays (nby, nbx, 2, 2n+1): [0] = dy, [1] = dx relative to
    the block origin, with dy == -(10**4) marking the DC-128 fill.  The
    fill's sources depend only on the availability flags, so the host fill
    runs once per distinct flag pattern, on an id-coded canvas, and the
    result is spread over every position with that pattern (the JAX
    package runs it at every position; the tables are equal)."""
    flags = _availability(height, width, n, ctb)
    nby, nbx, nf = flags.shape
    patterns, inv = np.unique(flags.reshape(-1, nf), axis=0,
                              return_inverse=True)
    side = 2 * n + 1               # canvas with the block at (1, 1)
    base = 10 ** 6
    ids = np.arange(side * side, dtype=np.int64).reshape(side, side) + base
    sentinel = -(10 ** 4)
    rel = np.zeros((len(patterns), 2, 2, side), np.int32)
    for k, pat in enumerate(patterns):
        for s, ref in enumerate(rs.fill_reference_samples(ids, 1, 1, n,
                                                          pat)):
            v = np.asarray(ref, np.int64)
            dc = v < base
            sy, sx = np.divmod(v - base, side)
            rel[k, s, 0] = np.where(dc, sentinel, sy - 1)
            rel[k, s, 1] = np.where(dc, 0, sx - 1)
    tabs = rel[inv.reshape(-1)].reshape(nby, nbx, 2, 2, side)
    return (np.ascontiguousarray(tabs[:, :, 0]),
            np.ascontiguousarray(tabs[:, :, 1]))


@functools.lru_cache(maxsize=None)
def _nn_ctx_tables(height: int, width: int, n: int, ctb: int = CTB):
    """Static PNN-context availability tables for n x n units (JAX package
    :137-170): ctx_ok (nby, nbx) bool (the anchor pixel (x-n, y-n) lies in
    the picture, `TComPattern.cpp:109-175`), above_mask (nby, nbx, 3n) and
    left_mask (nby, nbx, 2n) float32, the per-4-sample-strip copy gating of
    `extraction_context.cpp` from the availability flags."""
    flags = _availability(height, width, n, ctb)
    nby, nbx = height // n, width // n
    n_units = (2 * n) // rs.UNIT
    y = (np.arange(nby) * n)[:, None]
    x = (np.arange(nbx) * n)[None, :]
    ctx_ok = (x - n >= 0) & (y - n >= 0)
    on = ctx_ok[..., None]
    amask = np.zeros((nby, nbx, 3 * n), np.float32)
    lmask = np.zeros((nby, nbx, 2 * n), np.float32)
    amask[:, :, :n] = on                 # above-left corner: always copied
    for i in range(n_units):
        amask[:, :, n + 4 * i:n + 4 * i + 4] = \
            on & flags[:, :, n_units + 1 + i:n_units + 2 + i]
        lmask[:, :, 4 * i:4 * i + 4] = \
            on & flags[:, :, n_units - 1 - i:n_units - i]
    return ctx_ok, amask, lmask


def _skew_triplets(tt, tl, n, ctb, off):
    """(nbyn, nbxn, 3, 2(2n+1)) per-sample (plane delta | -9 DC, source
    row, x' offset relative to t*ctb) from (dy, dx) tables."""
    nbyn, nbxn = tt.shape[0], tt.shape[1]
    dy = np.concatenate([tt[:, :, 0, :], tl[:, :, 0, :]], -1)
    dx = np.concatenate([tt[:, :, 1, :], tl[:, :, 1, :]], -1)
    y = (np.arange(nbyn) * n)[:, None, None]
    x = (np.arange(nbxn) * n)[None, :, None]
    pb = y // ctb
    tpos = x // ctb + 2 * pb
    sy, sx = y + dy, x + dx
    ps = np.floor_divide(sy, ctb)
    d = (ps - pb).astype(np.int32)
    lys = (sy - ps * ctb).astype(np.int32)
    rxs = (sx + 2 * ctb * ps + off - tpos * ctb).astype(np.int32)
    sent = dy <= -(10 ** 4) // 2
    d[sent], lys[sent], rxs[sent] = -9, 0, 0
    return np.stack([d, lys, rxs], axis=2)


def _sel_tables(tt, tl, n):
    """Per-position selection over the raw L strips
    raw = [row(y-1, x-1 .. x+2n-1) | col(y .. y+2n-1, x-1) | 128]:
    (nbyn, nbxn, 2(2n+1)) int32 indices into that (4n+2)-long vector."""
    dy = np.concatenate([tt[:, :, 0, :], tl[:, :, 0, :]], -1)
    dx = np.concatenate([tt[:, :, 1, :], tl[:, :, 1, :]], -1)
    sent = dy <= -(10 ** 4) // 2
    on_row = dy == -1
    on_col = dx == -1
    if not bool(np.all(sent | on_row | on_col)):
        raise AssertionError("fill source off the 1-px L pattern")
    sel = np.where(on_row, dx + 1, 2 * n + 1 + dy)
    sel = np.where(sent, 4 * n + 1, sel).astype(np.int32)
    if sel.min() < 0 or sel.max() > 4 * n + 1:
        raise AssertionError("selection index out of range")
    return sel


def _dedupe(stacked):
    """(V, nby, nbx, ...) -> (class table (C, ...), cmap (V, nby, nbx))."""
    v, a, b = stacked.shape[:3]
    flat = stacked.reshape(v * a * b, -1)
    uniq, inv = np.unique(flat, axis=0, return_inverse=True)
    ctab = uniq.reshape((-1,) + stacked.shape[3:])
    return ctab, inv.reshape(v, a, b).astype(np.int32)


def _unit_consts(n: int, qp: int, n_modes: int = 35):
    """The geometry-free part of the per-size constants: angular tables,
    filter choice, transforms, quantiser shifts and static rate tables
    (n_modes rows: under switch, PNNS residuals use mode 0's coefficient
    scan).  4x4 luma intra TUs use the DST-VII, all others the DCT-II."""
    per, rem = qp // 6, qp % 6
    g0, g1, frac, _ = intra._angular_tables(n)
    use_filt = np.array(
        [False if m == 1 else
         min(abs(m - 10), abs(m - 26)) > rs.FILTER_THRESHOLD[n]
         for m in range(35)])
    log2n = n.bit_length() - 1
    tshift = 15 - 8 - log2n
    sig0, sig1 = rate_model.sig_bits_tables(qp, n)
    lastx, lasty = rate_model.last_bits_tables(qp, n)
    sgather, mode_scan = rate_model.scan_tables(n)
    if n_modes == 36:
        mode_scan = np.concatenate([mode_scan, mode_scan[:1]])
    inv_gather = np.empty_like(sgather)
    for st in range(3):
        inv_gather[st, sgather[st]] = np.arange(n * n, dtype=np.int32)
    c = dict(
        g0=g0, g1=g1, frac=frac, use_filt=use_filt,
        t_fwd=np.asarray(transform.DST4_FWD if n == 4
                         else transform.dct_matrix(n, True), np.int32),
        t_inv=np.asarray(transform.DST4 if n == 4
                         else transform.dct_matrix(n), np.int32),
        shift1=log2n + 8 + transform.FWD_MATRIX_SHIFT - 15,
        shift2=log2n + transform.FWD_MATRIX_SHIFT,
        qbits=14 + per + tshift,
        iq_shift=6 - (tshift + per),
        err_scale=float(2.0 ** (-2.0 * tshift)
                        / float(transform.QUANT_SCALES[rem]) ** 2),
        # Scan-domain rate tables, pre-gathered per mode: (n_modes, n*n).
        sig0=sig0[mode_scan], sig1=sig1[mode_scan],
        lastx=lastx, lasty=lasty,
        sg=sgather[mode_scan], inv_sg=inv_gather[mode_scan],
    )
    # Scan permutations as one-hot matrices (the JAX package's gather-free
    # form; kept so the tables match it, not read by the port).
    sgm = sgather[mode_scan]
    if n > 8:
        p1 = np.zeros((n * n, n * n), np.int8)
        p1[np.arange(n * n), sgm[0]] = 1
        c["scan_p"] = p1
    else:
        pm = np.zeros((len(sgm), n * n, n * n), np.int8)
        for m in range(len(sgm)):
            pm[m, np.arange(n * n), sgm[m]] = 1
        c["scan_p"] = pm
    return c


_GROUPS = {4: 1, 8: 1, 16: 6, 32: 36}


def _build_wavefront2(height: int, width: int, qp: int,
                      lam_scale: float = 1.0, policy: str = "regular",
                      bundle=None, ctb: int = CTB, enable_nxn: bool = True,
                      n_frames: int = 1, rate_evolve: bool = False,
                      halo: bool = False, n_tiles: int = 1,
                      stripe: int = 0) -> dict:
    """The encoder's plan: geometry, per-size constants and LUTs (numpy).

    Mirrors the table-building half of the JAX package's
    `_build_wavefront2` (`parallel/wavefront2.py:208-535`); every table is
    equal to the JAX package's.  `n_frames` > 1 interleaves that many
    frames into the plane axis.  NN policies take a `PnnBundle` with
    quantized models.  With `halo`, the plan is stripe `stripe` of
    `n_tiles` (`height` is the stripe's): the global step count, the
    stripe's step offset and the interior table variants (chosen for
    stripes below the first)."""
    if policy not in ("regular", "substitution", "switch"):
        raise ValueError(f"unknown policy {policy!r}")
    if policy != "regular" and bundle is None:
        raise ValueError("NN policies need a quantized PnnBundle")
    qmodels = bundle.quantized_for_qp(qp) \
        if bundle is not None and policy != "regular" else {}
    if policy != "regular" and not qmodels:
        raise ValueError("the bundle has no quantized models")
    nn_widths = tuple(sorted(w for w in qmodels if w in NN_SIZES))
    if ctb not in (32, 64):
        raise ValueError("ctb must be 32 or 64")
    if n_frames < 1:
        raise ValueError("n_frames must be at least 1")
    if height % ctb or width % ctb:
        raise ValueError(f"wavefront2 needs frame dims that are multiples "
                         f"of {ctb} (crop/pad first)")
    if halo and ctb == 64:
        raise NotImplementedError("halo sharding currently ships for CTB 32")
    if halo and n_frames > 1:
        raise NotImplementedError("frame batching is a single-device mode")
    if rate_evolve and (halo or ctb != 32):
        # The JAX package has no rate evolution at CTB 64 or under halo
        # (:508-511).
        raise NotImplementedError(
            "rate_evolve ships for single-device CTB-32 first")
    n_modes = 36 if policy == "switch" else 35
    sbx, sby = width // ctb, height // ctb
    n_steps = (sbx - 1) + 2 * (sby - 1) + 1
    # Halo: the global schedule over every stripe (JAX :269); a stripe's
    # own steps are n_steps, from t_offset on.
    n_steps_run = (sbx - 1) + 2 * (sby * n_tiles - 1) + 1 if halo \
        else n_steps
    b_max = min(sby, (sbx + 1) // 2 + 1)
    NF = n_frames
    b_eff = b_max * NF        # the (slot, frame) axis, slot-major
    # Skew geometry (JAX package :281-305).  OFF: left margin so reads two
    # planes up (x' -= 2*ctb) and 2n left stay in bounds at t=0; PH: plane
    # height with 32 pad rows; WIN: a step's working window.
    OFF = 2 * ctb + 64
    W_sk = n_steps * ctb + OFF + PADW
    WIN = OFF + ctb + PADW
    PH = ctb + 32
    n_planes = ROW0 + sby + b_max - 1       # per-frame by-planes
    cu8 = ctb // 8
    OFF8 = OFF // 8
    W8 = n_steps * cu8 + OFF8 + cu8
    lam = rdo.lambda_for_qp(qp) * lam_scale
    rem = qp % 6
    qscale = transform.QUANT_SCALES[rem]
    iq_scale = transform.INV_QUANT_SCALES[rem]
    SB = rate_model.scalar_bits(qp)
    MODE_BITS = rate_model.mode_bits_table(qp)

    size_consts = {}
    for n in (4, 8, 16, 32):
        c = _unit_consts(n, qp, n_modes)
        # Variant 0: the frame's top (single device, first stripe);
        # variant 1 (halo): an interior stripe, the tables of a frame one
        # CTB row taller from its second CTB row on (JAX :372-388).
        tt, tl = _fill_tables(height, width, n, ctb)
        trips = [_skew_triplets(tt, tl, n, ctb, OFF)]
        sels = [_sel_tables(tt, tl, n)]
        if halo:
            k = CTB // n
            ti_t, ti_l = _fill_tables(height + CTB, width, n, ctb)
            trips.append(_skew_triplets(ti_t[k:], ti_l[k:], n, ctb, OFF))
            sels.append(_sel_tables(ti_t[k:], ti_l[k:], n))
        ctab, cmap = _dedupe(np.stack(trips))
        stab, smap = _dedupe(np.stack(sels))
        c.update(
            ctab=ctab, cmap=cmap, smap=smap, sel=stab,
            # One-hot selection matrices (C, S, 4n+2) int8 (the JAX
            # package's form); the port gathers with `sel` instead.
            onehot=(stab[:, :, None]
                    == np.arange(4 * n + 2)[None, None, :]).astype(np.int8))
        if policy == "substitution" and n in nn_widths:
            nnpol = "sub18"
        elif n_modes == 36:
            nnpol = "append"
        else:
            nnpol = None
        c["fused"] = unit_fused.build_consts(
            n, n_modes, c, SB, lam, qscale, iq_scale, b_eff,
            nn_policy=nnpol, groups=_GROUPS[n])
        if n in nn_widths:
            # Context availability classes (JAX package :438-460).
            ctx_ok, am, lm = _nn_ctx_tables(height, width, n, ctb)
            variants = [np.concatenate(
                [ctx_ok[..., None].astype(np.float32), am, lm], -1)]
            if halo:
                k = CTB // n
                io, ia, il = _nn_ctx_tables(height + CTB, width, n, ctb)
                variants.append(np.concatenate(
                    [io[k:][..., None].astype(np.float32), ia[k:], il[k:]],
                    -1))
            nn_tab, nn_cmap = _dedupe(np.stack(variants))
            q = qmodels[n]
            c.update(nn_ok_c=nn_tab[:, 0] > 0.5,
                     nn_am_c=nn_tab[:, 1:1 + 3 * n],
                     nn_lm_c=nn_tab[:, 1 + 3 * n:], nn_cmap=nn_cmap, nn_q=q,
                     nn_fc=str(np.asarray(q["kind"])) == "fc",
                     nn_mean=bundle.mean_for(n))
        size_consts[n] = c

    plan = dict(height=height, width=width, qp=qp, lam=lam, ctb=ctb,
                enable_nxn=enable_nxn, rate_evolve=rate_evolve,
                policy=policy, nn_widths=nn_widths, n_modes=n_modes,
                n_frames=NF, sbx=sbx, sby=sby, n_steps=n_steps,
                n_steps_run=n_steps_run, halo=halo, n_tiles=n_tiles,
                t_offset=2 * sby * stripe if halo else 0,
                variant=1 if halo and stripe > 0 else 0,
                b_max=b_max, b_eff=b_eff, OFF=OFF, W_sk=W_sk, WIN=WIN,
                PH=PH, n_planes=n_planes, cu8=cu8, OFF8=OFF8, W8=W8,
                SB=SB, MODE_BITS=MODE_BITS, size_consts=size_consts)
    if rate_evolve:
        # Live (WPP-style) rate-state evolution LUTs (JAX package
        # :508-535): integer -log2 tables and the static per-class
        # micro-bit costs the live estimate replaces.
        _i = np.arange(64)
        plan["RS_LUT0"] = np.round(-np.log2(1.0 - (_i + 0.5) / 64.0)
                                   * 256.0).astype(np.int32)
        plan["RS_LUT1"] = np.round(-np.log2((_i + 0.5) / 64.0)
                                   * 256.0).astype(np.int32)
        _mb = lambda v: int(round(float(v) * 256.0))
        # Class order: sig4, sig8, sig16, sig32, g1, g2, cbf, (pad).
        plan["RS_STAT0"] = np.array(
            [_mb(np.mean(size_consts[n]["sig0"])) for n in (4, 8, 16, 32)]
            + [_mb(SB["g1_0"]), _mb(SB["g2_0"]), _mb(SB["cbf0"]), 0],
            np.int32)
        plan["RS_STAT1"] = np.array(
            [_mb(np.mean(size_consts[n]["sig1"])) for n in (4, 8, 16, 32)]
            + [_mb(SB["g1_1"]), _mb(SB["g2_1"]), _mb(SB["cbf1"]), 0],
            np.int32)
    return plan


def _schedule(sby, sbx, b_max, n_steps, t_offset=0):
    """Static wavefront schedule: (by, bx, valid), each (n_steps, b_max)."""
    ts = np.arange(n_steps) - t_offset
    by0 = np.maximum(0, -((sbx - 1 - ts) // 2))
    by = by0[:, None] + np.arange(b_max)[None, :]
    bx = ts[:, None] - 2 * by
    ok = (by < sby) & (bx >= 0) & (bx < sbx)
    return by, bx, ok


def _slot_schedule(plan):
    """(by, bx) per (step, slot) on the (slot, frame) axis: each slot's
    entry repeated n_frames times (the JAX package's `by_ids`, :864)."""
    by, bx, _ = _schedule(plan["sby"], plan["sbx"], plan["b_max"],
                          plan["n_steps"])
    nf = plan["n_frames"]
    return np.repeat(by, nf, axis=1), np.repeat(bx, nf, axis=1)


def _substage_classes(plan, n, cmap):
    """(n_steps, n_sub, b_eff) int: the class (of a (1, nby, nbx) class
    map) of the n x n unit of every step, sub-stage (in the order
    `_z_offsets(ctb, n)` gives) and (slot, frame); slots off the frame take
    the clipped position, as the JAX package's gathers clip."""
    ctb = plan["ctb"]
    by, bx = _slot_schedule(plan)
    un = ctb // n
    out = []
    for ly, lx in _z_offsets(ctb, n):
        by_n = np.clip(by * un + ly // n, 0, plan["height"] // n - 1)
        bx_n = np.clip(bx * un + lx // n, 0, plan["width"] // n - 1)
        out.append(cmap[plan["variant"], by_n, bx_n])      # (T, b)
    return np.stack(out, axis=1)


def _device_plan(plan, device):
    """The plan's tensors on `device`: per-size trial constants, reference
    selection indices per (step, sub-stage, slot), mode-bit and rate-state
    LUTs, for each NN width the model's tensors and the context masks
    per (step, sub-stage, slot), and at CTB 64 the 64 candidate's
    reference tables."""
    dp = {"trial": {}, "sel": {}, "nn": {}}
    for n in (4, 8, 16, 32):
        c = plan["size_consts"][n]
        dp["trial"][n] = unit_fused.consts_from_numpy(c["fused"],
                                                      device=device)
        sel = c["sel"][_substage_classes(plan, n, c["smap"])]
        dp["sel"][n] = torch.from_numpy(sel.astype(np.int64)).to(device)
        if n in plan["nn_widths"]:
            cls = _substage_classes(plan, n, c["nn_cmap"])
            dp["nn"][n] = dict(
                q=pnn_q.params_from_numpy(c["nn_q"], device),
                fc=c["nn_fc"], mean=c["nn_mean"],
                ok=torch.from_numpy(c["nn_ok_c"][cls]).to(device),
                am=torch.from_numpy(c["nn_am_c"][cls]).to(device),
                lm=torch.from_numpy(c["nn_lm_c"][cls]).to(device))
    if plan["ctb"] == 64:
        dp["c64"] = _cand64_tables(plan, device)
    _, bx = _slot_schedule(plan)
    dp["bx"] = torch.from_numpy(bx.astype(np.int32)).to(device)
    dp["mode_bits"] = torch.from_numpy(plan["MODE_BITS"]).to(device)
    if plan["rate_evolve"]:
        for k in ("RS_LUT0", "RS_LUT1", "RS_STAT0", "RS_STAT1"):
            dp[k] = torch.from_numpy(plan[k]).to(device)
    return dp


_PLAN_CACHE: dict = {}
_PLAN_CACHE_MAX = 4


def _get_plan(height, width, qp, lam_scale, ctb, enable_nxn, rate_evolve,
              device, policy="regular", bundle=None, n_frames=1,
              halo=False, n_tiles=1, stripe=0):
    """The cached (plan, device plan).  The key holds every argument the
    plan reads, the bundle by identity; an entry keeps its bundle alive,
    so the identity stays valid.  A miss is span `w2.plan_build`."""
    key = (height, width, qp, lam_scale, ctb, enable_nxn, rate_evolve,
           str(device), policy, id(bundle), n_frames, halo, n_tiles, stripe)
    hit = _PLAN_CACHE.get(key)
    if hit is None:
        with setup_span("w2.plan_build"):
            plan = _build_wavefront2(
                height, width, qp, lam_scale, policy=policy, bundle=bundle,
                ctb=ctb, enable_nxn=enable_nxn, n_frames=n_frames,
                rate_evolve=rate_evolve, halo=halo, n_tiles=n_tiles,
                stripe=stripe)
            hit = (plan, _device_plan(plan, device), bundle)
        _PLAN_CACHE[key] = hit
        while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
            _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
    return hit[0], hit[1]


def _box(buf, p0, np_, r0, nr, c0, nc):
    """buf[p0:p0+np_, r0:r0+nr, c0:c0+nc] as a view; raises where the JAX
    package's dynamic_slice would have clamped."""
    P, R, C = buf.shape
    if not (0 <= p0 and p0 + np_ <= P and 0 <= r0 and r0 + nr <= R
            and 0 <= c0 and c0 + nc <= C):
        raise IndexError(f"box [{p0}+{np_}, {r0}+{nr}, {c0}+{nc}] leaves "
                         f"a buffer of shape {tuple(buf.shape)}")
    return buf[p0:p0 + np_, r0:r0 + nr, c0:c0 + nc]


def _commit(buf, upd, p0, r0, c0, cond=None):
    """One box commit for all slots, in place; `cond` (b,) keeps the
    current value where it is false."""
    view = _box(buf, p0, upd.shape[0], r0, upd.shape[1], c0, upd.shape[2])
    if cond is not None:
        upd = torch.where(cond[:, None, None], upd, view)
    view.copy_(upd)


_KEYS32 = ("m8", "q8", "s8", "m16", "q16", "s16", "m32", "q32", "s32",
           "m4", "q4")


def _new_ys(plan, device):
    """Per-step decision outputs, preallocated: shapes of the JAX
    package's stacked scan outputs (leading axis the run's steps, the
    global schedule's under halo; slot axis b_eff).  At CTB 64 the
    32-rooted outputs carry the quadrant of the 64 CTB as a second axis
    (the JAX package's `sub`), beside the 64 level's m64 / q64 / s64."""
    T, b = plan["n_steps_run"], plan["b_eff"]
    i8, i16 = torch.int8, torch.int16
    lead = (T,) if plan["ctb"] == 32 else (T, 4)
    z = lambda shape, dt: torch.zeros(lead + shape, dtype=dt, device=device)
    ys = dict(
        m8=z((4, 4, b), i8), q8=z((4, 4, b, 8, 8), i16),
        s8=z((4, 4, b), i8),
        m16=z((4, b), i8), q16=z((4, b, 16, 16), i16),
        s16=z((4, b), i8),
        m32=z((b,), i8), q32=z((b, 32, 32), i16), s32=z((b,), i8))
    if plan["enable_nxn"]:
        ys.update(m4=z((4, 4, 4, b), i8), q4=z((4, 4, 4, b, 4, 4), i16))
    if plan["ctb"] == 64:
        zz = lambda shape, dt: torch.zeros((T,) + shape, dtype=dt,
                                           device=device)
        ys.update(m64=zz((b,), i8), q64=zz((b, 64, 64), i16),
                  s64=zz((b,), i8))
    return ys


def _step(plan, dp, st, ys, t, impl, ty=None):
    """One wavefront step: the quadtree of every (slot, frame) CTB on
    diagonal t (JAX package `step`, :844-1475), its decisions stored at
    step `ty` of `ys` (t by default; the global step under halo).  At CTB
    32 one CTB-32 body at offset (0, 0); at CTB 64 the same body at the
    four quadrant offsets in z-order, then the 64x64 2Nx2N candidate
    (`_candidate64`).
    Plane offsets are the JAX package's: a CTB row's planes start at
    (row) * NF, so one box of b_eff planes covers every slot of every
    frame."""
    ctb, b, OFF, WIN = plan["ctb"], plan["b_eff"], plan["OFF"], plan["WIN"]
    NF = plan["n_frames"]
    cu8, OFF8 = plan["cu8"], plan["OFF8"]
    lam, SB = plan["lam"], plan["SB"]
    f32c = unit_fused._f32
    dev = st["recon"].device
    i32, f32 = torch.int32, torch.float32
    rate_evolve = plan["rate_evolve"]
    ty = t if ty is None else ty
    ws = t * ctb
    # The step's working window, as a view: commits land in the planes.
    work = _box(st["recon"], 0, st["recon"].shape[0], 0, plan["PH"], ws,
                WIN)
    by0 = max(0, -((plan["sbx"] - 1 - t) // 2))
    p_cur = (by0 + ROW0) * NF          # this diagonal's recon / rate planes
    p_cell = by0 * NF                  # its frame, mode8 and c8 planes
    bx_ids = dp["bx"][t]                                  # (b,)
    sub = {4: 0, 8: 0, 16: 0, 32: 0}                       # sub-stage ids

    rate_rows_by_n = {4: None, 8: None, 16: None, 32: None}
    if rate_evolve:
        # WPP inherit: a slot entering its row (bx == 0) adopts the row
        # above's state, which at step t has coded its 2nd CTB.
        rs_sk = st["rs"]
        above = _box(rs_sk, p_cur - NF, b, 0, 8, 0, 16)
        cur = _box(rs_sk, p_cur, b, 0, 8, 0, 16)
        inh = torch.where((bx_ids == 0)[:, None, None], above, cur)
        cur.copy_(inh)
        rs_row = inh[:, 0, :]                              # (b, 16)
        n0s, n1s = rs_row[:, 0::2], rs_row[:, 1::2]        # (b, 8)
        tot = n0s + n1s
        ridx = torch.div(n1s * 64, torch.clamp(tot, min=1),
                         rounding_mode="floor").clamp(0, 63).long()
        act = tot >= RS_TMIN
        rd0 = torch.where(act, dp["RS_LUT0"][ridx] - dp["RS_STAT0"][None],
                          0)
        rd1 = torch.where(act, dp["RS_LUT1"][ridx] - dp["RS_STAT1"][None],
                          0)
        for i, nsz in enumerate((4, 8, 16, 32)):
            rate_rows_by_n[nsz] = torch.stack(
                [rd0[:, i], rd1[:, i], rd0[:, 4], rd1[:, 4],
                 rd0[:, 5], rd1[:, 5], rd0[:, 6], rd1[:, 6]]).to(
                     i32).contiguous()

    def refs_for_b(n, ly, lx):
        """HM reference arrays of every slot: the 1-px L strips (row
        above incl. corner and above-right, column left), then the
        per-position availability/substitution selection."""
        up = 1 if ly == 0 else 0
        row_above = _box(work, p_cur - up * NF, b,
                         ctb - 1 if ly == 0 else ly - 1, 1,
                         lx - 1 - 2 * ctb * up + OFF, 2 * n + 1)[:, 0, :]
        col_left = _box(work, p_cur, b, ly, 2 * n,
                        lx - 1 + OFF, 1)[:, :, 0]
        raw = torch.cat([row_above, col_left,
                         torch.full((b, 1), 128, dtype=i32, device=dev)],
                        dim=1)
        refs = torch.gather(raw, 1, dp["sel"][n][t, sub[n]])
        s = 2 * n + 1
        return refs[:, :s].contiguous(), refs[:, s:].contiguous()

    def mode_bits_b(ly, lx):
        """MPM-aware per-slot mode-bit estimates (b, n_modes) from the
        8-granularity mode map."""
        m8 = st["mode8"]
        ly8 = ly // 8
        x8i = t * cu8 + lx // 8 + OFF8
        lm_read = _box(m8, p_cell, b, ly8, 1, x8i - 1, 1)[:, 0, 0]
        lm = torch.where(bx_ids * ctb + lx >= 8, lm_read, 1)
        # 4x4 sub-blocks whose top edge is not 8-aligned, and the CTB's
        # top row, take DC as the above mode.
        if ly >= 8 and ly % 8 == 0:
            am = _box(m8, p_cell, b, ly8 - 1, 1, x8i, 1)[:, 0, 0]
        else:
            am = torch.ones_like(lm)
        same = lm == am
        mpm_same = torch.where(
            lm > 1,
            torch.stack([lm, ((lm + 29) % 32) + 2, ((lm - 1) % 32) + 2]),
            torch.stack([torch.zeros_like(lm), torch.ones_like(lm),
                         torch.full_like(lm, 26)]))
        m2 = torch.where((lm != 0) & (am != 0), 0,
                         torch.where(lm + am < 2, 26, 1))
        mpms = torch.where(same, mpm_same, torch.stack([lm, am, m2]))
        ids = torch.arange(35, device=dev)[:, None]
        is0 = ids == mpms[0][None]
        ismpm = is0 | (ids == mpms[1][None]) | (ids == mpms[2][None])
        which = torch.where(is0, 0, torch.where(ismpm, 1, 3))
        base = dp["mode_bits"][which].T                     # (b, 35) f32
        if plan["n_modes"] == 36:
            # Every normal mode pays pnns_flag = 0, PNNS only the flag
            # (TEncSbac::codeIntraDirLumaAng switch bin order).
            return torch.cat([base + f32c(SB["pnns0"]), pnns1_col], dim=1)
        return base.contiguous()

    def nn_predict_b(n, ly, lx):
        """Every slot's PNN prediction (b, n, n): the above (n, 3n) and
        left (2n, n) context portions read from the evolving
        reconstruction, masked per 4-sample strip, one quantized forward
        over all slots; zeros where the context is unavailable
        (TComPrediction.cpp:645-663)."""
        nd = dp["nn"][n]
        up = 1 if ly == 0 else 0                 # planes up for the above
        above_pix = _box(work, p_cur - up * NF, b,
                         ctb - n if ly == 0 else ly - n, n,
                         lx - n - 2 * ctb * up + OFF, 3 * n)
        left_pix = _box(work, p_cur, b, ly, 2 * n, lx - n + OFF, n)
        mean = f32c(nd["mean"])
        am = nd["am"][t, sub[n]]
        lm = nd["lm"][t, sub[n]]
        above_f = (above_pix.to(f32) - mean) * am[:, None, :]
        left_f = (left_pix.to(f32) - mean) * lm[:, :, None]
        if nd["fc"]:
            inp = torch.cat([above_f.reshape(b, -1), left_f.reshape(b, -1)],
                            dim=1)
        else:
            inp = (above_f[..., None], left_f[..., None])
        pred = pnn_q.predict_pixels_q(nd["q"], inp, n, nd["fc"], mean,
                                      impl=impl)
        return torch.where(nd["ok"][t, sub[n]][:, None, None], pred,
                           0).contiguous()

    def encode_unit_b(n, ly, lx):
        ref_top, ref_left = refs_for_b(n, ly, lx)
        orig = _box(st["frame"], p_cell, b, ly, n, t * ctb + lx + OFF,
                    n).contiguous()
        mbits = mode_bits_b(ly, lx)
        # Under switch, a width without a model predicts zeros for PNNS
        # (nn_pred None).
        nn_pred = nn_predict_b(n, ly, lx) if n in plan["nn_widths"] else None
        out = unit_fused.trial_apply(dp["trial"][n], ref_top, ref_left,
                                     orig, mbits, rate_rows_by_n[n],
                                     impl=impl, nn_pred=nn_pred)
        sub[n] += 1
        return out

    def commit_rec(rec, ly, lx, cond=None):
        _commit(work, rec, p_cur, ly, lx + OFF, cond)

    def commit_cell8(buf, vals, ly, lx):
        _commit(buf, vals[:, None, None], p_cell, ly // 8,
                t * cu8 + lx // 8 + OFF8)

    def commit_mode_fill(modes, ly, lx, k, cond):
        fill = modes[:, None, None].expand(b, k, k)
        _commit(st["mode8"], fill, p_cell, ly // 8,
                t * cu8 + lx // 8 + OFF8, cond)

    def zeros8():
        return torch.zeros((b, 8), dtype=i32, device=dev)

    if plan["n_modes"] == 36:
        pnns1_col = torch.full((b, 1), f32c(SB["pnns1"]), dtype=f32,
                               device=dev)

    # lambda * structure-flag bits, rounded to float32 as JAX rounds its
    # weak-typed Python constants.
    lam_p2n = f32c(lam * SB["part_2nx2n"])
    lam_pnxn = f32c(lam * SB["part_nxn"])
    lam_s0, lam_s1 = f32c(lam * SB["split0"]), f32c(lam * SB["split1"])

    def ctb32(oy, ox, y32):
        """The complete 32-rooted quadtree at pixel offset (oy, ox) of the
        CTB (JAX package `encode_ctb32`, :1114-1278): (0, 0) at CTB 32, a
        quadrant corner of the 64 CTB at CTB 64.  Writes its decisions
        into the views `y32`; returns the 32 root's best cost (b,) and,
        with `rate_evolve`, the bin counts of the decided tree."""
        qsum = torch.zeros((b,), dtype=f32, device=dev)
        qa4, qa8, qa16 = zeros8(), zeros8(), zeros8()
        for quad in range(4):
            qdx, qdy = quad & 1, quad >> 1
            zb4, zb8 = zeros8(), zeros8()
            for z in range(4):
                ly8 = oy + (qdy * 2 + (z >> 1)) * 8
                lx8 = ox + (qdx * 2 + (z & 1)) * 8
                if plan["enable_nxn"]:
                    # NxN: the four 4x4 PUs predict from the evolving
                    # reconstruction; if 2Nx2N wins, its rec overwrites
                    # them.
                    cost_nxn = torch.zeros((b,), dtype=f32, device=dev)
                    cnt_nxn = zeros8()
                    for s4 in range(4):
                        ly4 = ly8 + (s4 >> 1) * 4
                        lx4 = lx8 + (s4 & 1) * 4
                        c4, m4b, rec4, q4b, cn4 = encode_unit_b(4, ly4, lx4)
                        commit_rec(rec4, ly4, lx4)
                        cost_nxn = cost_nxn + c4
                        cnt_nxn = cnt_nxn + cn4
                        y32["m4"][quad, z, s4] = m4b.to(torch.int8)
                        y32["q4"][quad, z, s4] = q4b.to(torch.int16)
                    last_m4 = m4b
                    # The 8x8 2Nx2N trial reads only outside the cell, so
                    # running it after the 4x4 chain is exact.
                    cost8, mode8b, rec8, q8b, cn8 = encode_unit_b(8, ly8,
                                                                  lx8)
                    use2n = cost8 + lam_p2n < cost_nxn + lam_pnxn
                    cell_cost = torch.where(use2n, cost8 + lam_p2n,
                                            cost_nxn + lam_pnxn)
                else:
                    cost8, mode8b, rec8, q8b, cn8 = encode_unit_b(8, ly8,
                                                                  lx8)
                    last_m4 = mode8b
                    cnt_nxn = zeros8()
                    use2n = torch.ones_like(cost8, dtype=torch.bool)
                    cell_cost = cost8 + lam_p2n
                commit_rec(rec8, ly8, lx8, use2n)
                # MPM context at 8-granularity: the 2Nx2N mode, or the
                # bottom-right 4x4's mode when NxN wins.
                commit_cell8(st["mode8"], torch.where(use2n, mode8b, last_m4),
                             ly8, lx8)
                commit_cell8(st["c8"], cell_cost, ly8, lx8)
                y32["m8"][quad, z] = mode8b.to(torch.int8)
                y32["q8"][quad, z] = q8b.to(torch.int16)
                y32["s8"][quad, z] = (~use2n).to(torch.int8)
                if rate_evolve:
                    u2 = use2n[:, None]
                    zb4 = zb4 + torch.where(u2, 0, cnt_nxn)
                    zb8 = zb8 + torch.where(u2, cn8, 0)

            ly16, lx16 = oy + qdy * 16, ox + qdx * 16
            cost16, mode16, rec16, qq16, cn16 = encode_unit_b(16, ly16, lx16)
            # Fixed-order adds over the 2x2 cell costs.
            csub = _box(st["c8"], p_cell, b, ly16 // 8, 2,
                        t * cu8 + lx16 // 8 + OFF8, 2)
            cost8s = (((csub[:, 0, 0] + csub[:, 0, 1]) + csub[:, 1, 0])
                      + csub[:, 1, 1]) + lam_s1
            cost16f = cost16 + lam_s0
            use16 = cost16f < cost8s
            qcost_q = torch.where(use16, cost16f, cost8s)
            commit_rec(rec16, ly16, lx16, use16)
            commit_mode_fill(mode16, ly16, lx16, 2, use16)
            y32["m16"][quad] = mode16.to(torch.int8)
            y32["q16"][quad] = qq16.to(torch.int16)
            y32["s16"][quad] = (~use16).to(torch.int8)
            if rate_evolve:
                u16 = use16[:, None]
                qa4 = qa4 + torch.where(u16, 0, zb4)
                qa8 = qa8 + torch.where(u16, 0, zb8)
                qa16 = qa16 + torch.where(u16, cn16, 0)
            qsum = qsum + qcost_q

        # --- 32x32 candidate ---
        cost32, mode32, rec32, qq32, cn32 = encode_unit_b(32, oy, ox)
        cost_quads = qsum + lam_s1
        cost32f = cost32 + lam_s0
        use32 = cost32f < cost_quads
        commit_rec(rec32, oy, ox, use32)
        commit_mode_fill(mode32, oy, ox, 4, use32)
        y32["m32"][...] = mode32.to(torch.int8)
        y32["q32"][...] = qq32.to(torch.int16)
        y32["s32"][...] = (~use32).to(torch.int8)
        cnt = None
        if rate_evolve:
            u32 = use32[:, None]
            cnt = (torch.where(u32, 0, qa4), torch.where(u32, 0, qa8),
                   torch.where(u32, 0, qa16), torch.where(u32, cn32, 0))
        return torch.where(use32, cost32f, cost_quads), cnt

    if ctb == 32:
        _, cnt = ctb32(0, 0, {k: ys[k][ty] for k in _KEYS32 if k in ys})
    else:
        csum64 = torch.zeros((b,), dtype=f32, device=dev)
        for q64 in range(4):
            c32, _ = ctb32((q64 >> 1) * 32, (q64 & 1) * 32,
                           {k: ys[k][ty, q64] for k in _KEYS32 if k in ys})
            csum64 = csum64 + c32
        mode64, rec64, qq64, use64 = _candidate64(
            plan, dp, st, t, p_cell, mode_bits_b(0, 0), csum64 + lam_s1,
            lam_s0)
        commit_rec(rec64, 0, 0, use64)
        commit_mode_fill(mode64, 0, 0, 8, use64)
        ys["m64"][ty] = mode64.to(torch.int8)
        ys["q64"][ty] = qq64.to(torch.int16)
        ys["s64"][ty] = (~use64).to(torch.int8)

    if rate_evolve:
        fb4, fb8, fb16, fb32 = cnt
        allb = fb4 + fb8 + fb16 + fb32
        upd = torch.cat(
            [fb4[:, 0:2], fb8[:, 0:2], fb16[:, 0:2], fb32[:, 0:2],
             allb[:, 2:6], allb[:, 7:8] - allb[:, 6:7], allb[:, 6:7],
             torch.zeros((b, 2), dtype=i32, device=dev)], dim=1)
        newrow = rs_row + upd
        n0n, n1n = newrow[:, 0::2], newrow[:, 1::2]
        # Exponential aging keeps the estimator adaptive.
        big_t = (n0n + n1n) > 1024
        n0n = torch.where(big_t, (n0n + 1) >> 1, n0n)
        n1n = torch.where(big_t, (n1n + 1) >> 1, n1n)
        newrow = torch.stack([n0n, n1n], dim=2).reshape(b, 16)
        blk = torch.cat([newrow[:, None, :],
                         torch.zeros((b, 7, 16), dtype=i32, device=dev)],
                        dim=1)
        _commit(rs_sk, blk, p_cur, 0, 0)


def _candidate64(plan, dp, st, t, p_cell, mbits, split_cost, lam_s0):
    """The 64x64 2Nx2N candidate of every (slot, frame) CTB on diagonal t
    (JAX package :1312-1437), in plain PyTorch on the plan's device: one
    signalled mode and four forced TU32s in z-order, each mode with its
    own evolving 64x64 patch, as HM reconstructs an intra CU64 TU by TU.
    A TU's references are mixed from the mode's patch inside the CU and
    the committed reconstruction outside (`_cand64_tables`), filtered per
    mode (`unit_fused.ref_columns`), predicted per mode, transformed,
    quantised (`unit_fused.rdoq_lite`, the JAX package's `quantize_rd`)
    and reconstructed (`unit_fused.reconstruct`); cost64 adds SSE and
    lambda * TU bits TU by TU, then lambda * mode bits.  The PNN modes are
    barred at 64 (substitution's mode 18 when 32 has a model, PNNS).
    `split_cost` (b,) is the four quadrants' cost plus lambda * split1.
    Returns (mode64 (b,) int64, rec64, q64 (b, 64, 64) i32, use64 (b,)
    bool); the caller commits."""
    c, tc = dp["c64"], dp["trial"][32]
    b, M = plan["b_eff"], plan["n_modes"]
    nn, ctb = 1024, plan["ctb"]
    f32 = torch.float32
    dev = st["recon"].device
    floordiv = unit_fused._floordiv2
    LAM = unit_fused._f32(plan["lam"])
    S = c["out_idx"].shape[-1]
    RRp = tc["RRp"]
    recon_flat = st["recon"].view(-1)
    patch = torch.zeros((b, M, 64, 64), dtype=torch.int32, device=dev)
    qall = torch.zeros((b, M, 64, 64), dtype=torch.int32, device=dev)
    cost = torch.zeros((1, M * b), dtype=f32, device=dev)
    rr = torch.zeros((8, M * b), dtype=torch.int32, device=dev)
    p2 = tc["P2"].view(-1, nn, RRp)[:M]
    for tz in range(4):
        tdy, tdx = (tz >> 1) * 32, (tz & 1) * 32
        out_val = torch.where(c["okd"][t, tz],
                              recon_flat[c["out_idx"][t, tz]], 128)
        in_val = torch.gather(patch.view(b, M, 4096), 2,
                              c["in_idx"][t, tz][:, None, :].expand(b, M, S))
        refs = torch.where(c["inside"][t, tz][:, None, :], in_val,
                           out_val[:, None, :])                   # (b, M, S)
        comb = torch.nn.functional.pad(
            refs.permute(2, 1, 0).reshape(S, M * b).to(f32),
            (0, 0, 0, tc["Rp"] - S))                  # lane m * b + j
        comb2 = unit_fused.ref_columns(tc, comb)
        blocks = floordiv(torch.bmm(p2, comb2.view(RRp, M, b).permute(
            1, 0, 2)), 6)                                         # (M, nn, b)
        dc = floordiv(tc["dcw"][0:1] @ comb2, tc["dc_shift"]).view(M, b)
        blocks[1] = dc[1][None, :]
        preds = blocks.permute(1, 0, 2).reshape(nn, M * b)
        orig = _box(st["frame"], p_cell, b, tdy, 32, t * ctb + tdx
                    + plan["OFF"], 32).reshape(b, nn)[:, tc["pp"]].T
        orig_rep = orig.repeat(1, M)
        coeff = unit_fused._forward_plain(tc, orig_rep.to(f32) - preds)
        q, tu_bits, _, _ = unit_fused.rdoq_lite(tc, coeff, rr, M)
        rec = unit_fused.reconstruct(tc, preds, q)
        d = rec - orig_rep
        sse = unit_fused._i32_sum(d * d, 0).to(f32)
        cost = cost + sse + LAM * tu_bits
        ipp = tc["ipp"]
        patch[:, :, tdy:tdy + 32, tdx:tdx + 32] = \
            rec[ipp].view(32, 32, M, b).permute(3, 2, 0, 1)
        qall[:, :, tdy:tdy + 32, tdx:tdx + 32] = \
            q[ipp].view(32, 32, M, b).permute(3, 2, 0, 1)
    cost64 = cost.view(M, b).T + LAM * mbits                       # (b, M)
    big = torch.tensor(3e38, dtype=f32, device=dev)
    ids = torch.arange(M, device=dev)[None]
    if plan["policy"] == "substitution" and 32 in plan["nn_widths"]:
        cost64 = torch.where(ids == 18, big, cost64)
    if M == 36:
        cost64 = torch.where(ids == PNNS_MODE, big, cost64)
    best = torch.argmin(cost64, dim=1)          # the first minimum
    rows = torch.arange(b, device=dev)
    use64 = cost64[rows, best] + lam_s0 < split_cost
    return best, patch[rows, best], qall[rows, best], use64


def _cand64_tables(plan, device):
    """Static reference tables of the 64 candidate's four TU32s (JAX
    package :1358-1377; the n = 32 triplet classes), per (step, TU, slot,
    sample): `out_idx`, the flat index into the reconstruction planes
    (n_planes * NF, PH, W_sk) of the sample outside the CU; `okd`, false
    where it is the DC-128 fill; `inside`, true where the sample lies
    inside the CU; `in_idx`, its index in the 64x64 patch.  Slots off the
    frame take clipped positions, as the JAX package's gathers clip."""
    ctb, NF, OFF, WIN = plan["ctb"], plan["n_frames"], plan["OFF"], \
        plan["WIN"]
    PH, W_sk = plan["PH"], plan["W_sk"]
    cmap, ctab = plan["size_consts"][32]["cmap"], \
        plan["size_consts"][32]["ctab"]
    by, bx = _slot_schedule(plan)                          # (T, b)
    f_ids = np.tile(np.arange(NF), plan["b_max"])[None, :, None]
    T = plan["n_steps"]
    tabs = {k: [] for k in ("out_idx", "okd", "inside", "in_idx")}
    for tz in range(4):
        by32 = np.clip(by * 2 + (tz >> 1), 0, plan["height"] // 32 - 1)
        bx32 = np.clip(bx * 2 + (tz & 1), 0, plan["width"] // 32 - 1)
        trip = ctab[cmap[0, by32, bx32]].astype(np.int64)  # (T, b, 3, S)
        dpl, lys, rxs = trip[:, :, 0], trip[:, :, 1], trip[:, :, 2]
        okd = dpl > -5
        plane = np.clip(by[:, :, None] + ROW0 + dpl, 0,
                        plan["n_planes"] - 1) * NF + f_ids
        col = np.arange(T)[:, None, None] * ctb + np.clip(rxs, 0, WIN - 1)
        iy = dpl * 64 + lys
        ix = rxs - OFF - 2 * ctb * dpl
        inside = okd & (iy >= 0) & (iy < 64) & (ix >= 0) & (ix < 64)
        tabs["out_idx"].append((plane * PH + lys) * W_sk + col)
        tabs["okd"].append(okd)
        tabs["inside"].append(inside)
        tabs["in_idx"].append(np.clip(iy, 0, 63) * 64 + np.clip(ix, 0, 63))
    return {k: torch.from_numpy(np.ascontiguousarray(np.stack(v, 1))).to(
        device) for k, v in tabs.items()}

def run(plan, dp, frames_u8, impl="kernel", group=None):
    """The device half of the encode: returns (recon (n_frames, H, W)
    uint8 numpy, ys dict of numpy per-step decisions, slot axis b_eff
    ordered (slot, frame)) of `frames_u8` (n_frames, H, W) (JAX package
    :1477-1522).  A halo plan runs this rank's stripe of the global
    schedule with the exchange over the process `group` (JAX
    :1449-1471).  Spans `w2.steps` (the host issuing the step loop) and
    `w2.readback` (the copies to the host, with the wait for the card)."""
    dev = dp["mode_bits"].device
    ctb, OFF, W_sk = plan["ctb"], plan["OFF"], plan["W_sk"]
    sby, b_max, NF = plan["sby"], plan["b_max"], plan["n_frames"]
    height, width = plan["height"], plan["width"]
    i32 = torch.int32
    frames = torch.as_tensor(np.ascontiguousarray(frames_u8)).to(
        device=dev, dtype=i32)
    if tuple(frames.shape) != (NF, height, width):
        raise ValueError(f"frames {tuple(frames.shape)} != plan "
                         f"{(NF, height, width)}")
    frame_sk = torch.zeros(((sby + b_max - 1) * NF, ctb, W_sk), dtype=i32,
                           device=dev)
    for by in range(sby):
        x0 = OFF + 2 * ctb * by
        frame_sk[by * NF:(by + 1) * NF, :, x0:x0 + width] = \
            frames[:, by * ctb:(by + 1) * ctb]
    st = dict(
        frame=frame_sk,
        recon=torch.zeros((plan["n_planes"] * NF, plan["PH"], W_sk),
                          dtype=i32, device=dev),
        mode8=torch.ones(((sby + b_max - 1) * NF, plan["cu8"], plan["W8"]),
                         dtype=i32, device=dev),
        c8=torch.zeros(((sby + b_max - 1) * NF, plan["cu8"], plan["W8"]),
                       dtype=torch.float32, device=dev))
    if plan["rate_evolve"]:
        st["rs"] = torch.zeros((plan["n_planes"] * NF, 8, 16), dtype=i32,
                               device=dev)
    ys = _new_ys(plan, dev)
    # One loop over the global schedule: without halo it is this plan's
    # own (n_steps_run == n_steps, t_offset 0) and nothing is exchanged.
    with span("w2.steps"), _exact_f32():
        for t in range(plan["n_steps_run"]):
            t_loc = t - plan["t_offset"]
            if 0 <= t_loc < plan["n_steps"]:
                _step(plan, dp, st, ys, t_loc, impl, t)
            if plan["halo"]:
                # The bottom plane, stored at x' = x + 2*ctb*(sby-1) + OFF,
                # is read below at x' = x - 2*ctb + OFF.
                recv = mesh.shift_down(st["recon"][ROW0 + sby - 1, :ctb],
                                       group)
                if recv is not None:
                    st["recon"][0, :ctb] = torch.roll(recv, -2 * ctb * sby,
                                                      dims=1)
    recon = torch.stack([torch.cat([
        st["recon"][(ROW0 + by) * NF + f, :ctb,
                    OFF + 2 * ctb * by:OFF + 2 * ctb * by + width]
        for by in range(sby)], 0) for f in range(NF)]).to(torch.uint8)
    with span("w2.readback"):
        return recon.cpu().numpy(), {k: v.cpu().numpy()
                                     for k, v in ys.items()}


def _frame_ys(ys, n_frames, f):
    """Frame f's per-step decisions of a batched run: the (slot, frame)
    axis is slot-major, at -3 for the level arrays (`q*`, trailing (n, n)
    blocks) and -1 for the others (JAX package :1813-1824)."""
    if n_frames == 1:
        return ys
    out = {}
    for k, v in ys.items():
        axis = -3 if k.startswith("q") else -1
        out[k] = np.take(v, np.arange(v.shape[axis] // n_frames) * n_frames
                         + f, axis=axis)
    return out


def _assemble_arrays(ys, height, width, ctb=CTB, t_offset=0):
    """Stacked per-step outputs -> the decided grids (m8, q8, s8, m4, q4,
    m16, q16, s16, m32, q32, s32), and at CTB 64 also (m64, q64, s64)
    (JAX package :1531-1613)."""
    ys = {k: np.asarray(v) for k, v in ys.items()}
    h4, w4 = height // 4, width // 4
    h8, w8 = height // 8, width // 8
    h16, w16 = height // 16, width // 16
    nby, nbx = height // 32, width // 32
    sby, sbx = height // ctb, width // ctb
    n_steps, b_max = ys["m64" if ctb == 64 else "m32"].shape
    by, bx, ok = _schedule(sby, sbx, b_max, n_steps, t_offset)

    m8 = np.zeros((h8, w8), np.int32)
    q8 = np.zeros((h8, w8, 8, 8), np.int32)
    s8 = np.zeros((h8, w8), np.int32)
    m4 = np.zeros((h4, w4), np.int32)
    q4 = np.zeros((h4, w4, 4, 4), np.int32)
    m16 = np.zeros((h16, w16), np.int32)
    q16 = np.zeros((h16, w16, 16, 16), np.int32)
    s16 = np.zeros((h16, w16), np.int32)
    m32 = np.zeros((nby, nbx), np.int32)
    q32 = np.zeros((nby, nbx, 32, 32), np.int32)
    s32 = np.zeros((nby, nbx), np.int32)
    has_nxn = "m4" in ys

    def fill32(sub, cby, cbx):
        """One 32-root bundle of outputs at 32-grid coords (n_steps,
        b_max)."""
        for quad in range(4):
            qdx, qdy = quad & 1, quad >> 1
            for z in range(4):
                zdx2 = qdx * 2 + (z & 1)
                zdy2 = qdy * 2 + (z >> 1)
                b8y = (cby * 4 + zdy2)[ok]
                b8x = (cbx * 4 + zdx2)[ok]
                m8[b8y, b8x] = sub["m8"][:, quad, z][ok]
                q8[b8y, b8x] = sub["q8"][:, quad, z][ok]
                s8[b8y, b8x] = sub["s8"][:, quad, z][ok]
                if has_nxn:
                    for s4 in range(4):
                        sdx, sdy = s4 & 1, s4 >> 1
                        b4y = (cby * 4 + zdy2) * 2 + sdy
                        b4x = (cbx * 4 + zdx2) * 2 + sdx
                        m4[b4y[ok], b4x[ok]] = sub["m4"][:, quad, z, s4][ok]
                        q4[b4y[ok], b4x[ok]] = sub["q4"][:, quad, z, s4][ok]
            b16y = (cby * 2 + qdy)[ok]
            b16x = (cbx * 2 + qdx)[ok]
            m16[b16y, b16x] = sub["m16"][:, quad][ok]
            q16[b16y, b16x] = sub["q16"][:, quad][ok]
            s16[b16y, b16x] = sub["s16"][:, quad][ok]
        m32[cby[ok], cbx[ok]] = sub["m32"][ok]
        q32[cby[ok], cbx[ok]] = sub["q32"][ok]
        s32[cby[ok], cbx[ok]] = sub["s32"][ok]

    grids = (m8, q8, s8, m4, q4, m16, q16, s16, m32, q32, s32)
    if ctb == 32:
        fill32(ys, by, bx)
        return grids
    for q64i in range(4):
        fill32({k: v[:, q64i] for k, v in ys.items() if k in _KEYS32},
               by * 2 + (q64i >> 1), bx * 2 + (q64i & 1))
    m64 = np.zeros((sby, sbx), np.int32)
    q64 = np.zeros((sby, sbx, 64, 64), np.int32)
    s64 = np.zeros((sby, sbx), np.int32)
    m64[by[ok], bx[ok]] = ys["m64"][ok]
    q64[by[ok], bx[ok]] = ys["q64"][ok]
    s64[by[ok], bx[ok]] = ys["s64"][ok]
    return grids + (m64, q64, s64)


def _serialize_grids(grids, *, width, height, qp, policy, ctb):
    """Framework-container stream of decided grids: header + the native
    packer's payload (byte-identical to the JAX package's)."""
    header = enc_mod.stream_header(
        width=width, height=height, qp=qp, policy=policy, ctu_size=ctb,
        sign_hiding=True)
    return header + native.pack_tree_payload(
        grids, width=width, height=height, qp=qp, ctu_size=ctb,
        policy=policy)


def _arrays_to_result(frame_uint8, qp, arrays, policy, serialize,
                      ctb: int = CTB):
    """Decided grids -> CuNode trees (+ CABAC serialization) (JAX package
    :1663-1773).  At CTB 64 the 32 level sits at depth 1 under either an
    unsplit 64 CU (one PU, four forced TU32s) or a split root."""
    (recon, m8, q8, s8, m4, q4, m16, q16, s16, m32, q32, s32) = arrays[:12]
    h, w = frame_uint8.shape
    trees = []
    mode_map = np.full((h // 4, w // 4), -1, np.int32)
    d0 = 1 if ctb == 64 else 0      # depth of the 32 level

    def leaf(x, y, n, mode, q, depth=0):
        cbf = 1 if q.any() else 0
        mode_map[y // 4:(y + n) // 4, x // 4:(x + n) // 4] = mode
        pu = enc_mod.PuRecord(x, y, n, int(mode),
                              [enc_mod.TuRecord(x, y, n, cbf,
                                                q if cbf else None)])
        return enc_mod.CuNode(x, y, n, depth, split=False, pus=[pu])

    def leaf8(x, y):
        """8x8 CU: 2Nx2N leaf, or NxN with four 4x4 PUs (DST TUs)."""
        if not s8[y // 8, x // 8]:
            return leaf(x, y, 8, m8[y // 8, x // 8], q8[y // 8, x // 8])
        node = enc_mod.CuNode(x, y, 8, 0, split=False, part_nxn=True)
        for s in range(4):
            sx, sy = x + (s & 1) * 4, y + (s >> 1) * 4
            mode = int(m4[sy // 4, sx // 4])
            q = q4[sy // 4, sx // 4]
            cbf = 1 if q.any() else 0
            mode_map[sy // 4, sx // 4] = mode
            node.pus.append(enc_mod.PuRecord(
                sx, sy, 4, mode,
                [enc_mod.TuRecord(sx, sy, 4, cbf, q if cbf else None)]))
        return node

    def tree32(x, y):
        by, bx = y // 32, x // 32
        if not s32[by, bx]:
            return leaf(x, y, 32, m32[by, bx], q32[by, bx], d0)
        root = enc_mod.CuNode(x, y, 32, d0, split=True)
        for quad in range(4):
            qx = x + (quad & 1) * 16
            qy = y + (quad >> 1) * 16
            b16y, b16x = qy // 16, qx // 16
            if not s16[b16y, b16x]:
                child = leaf(qx, qy, 16, m16[b16y, b16x], q16[b16y, b16x],
                             d0 + 1)
            else:
                child = enc_mod.CuNode(qx, qy, 16, d0 + 1, split=True)
                for z in range(4):
                    g = leaf8(qx + (z & 1) * 8, qy + (z >> 1) * 8)
                    g.depth = d0 + 2
                    child.children.append(g)
            root.children.append(child)
        return root

    def tree64(x, y):
        m64, q64, s64 = arrays[12:]
        by, bx = y // 64, x // 64
        if s64[by, bx]:
            root = enc_mod.CuNode(x, y, 64, 0, split=True)
            root.children = [tree32(x + (quad & 1) * 32,
                                    y + (quad >> 1) * 32)
                             for quad in range(4)]
            return root
        # 64x64 2Nx2N PU over the forced TU32 split (the largest TU is
        # 32: the serializer and the decoder infer the split).
        mode = int(m64[by, bx])
        mode_map[y // 4:(y + 64) // 4, x // 4:(x + 64) // 4] = mode
        tus = []
        for tz in range(4):
            ty, tx = (tz >> 1) * 32, (tz & 1) * 32
            tq = q64[by, bx, ty:ty + 32, tx:tx + 32]
            cbf = 1 if tq.any() else 0
            tus.append(enc_mod.TuRecord(x + tx, y + ty, 32, cbf,
                                        tq if cbf else None))
        return enc_mod.CuNode(x, y, 64, 0, split=False,
                              pus=[enc_mod.PuRecord(x, y, 64, mode, tus)])

    tree = tree64 if ctb == 64 else tree32
    for by in range(h // ctb):
        for bx in range(w // ctb):
            trees.append(tree(bx * ctb, by * ctb))

    bitstream = b""
    if serialize:
        bitstream = _serialize_grids(arrays[1:], width=w, height=h, qp=qp,
                                     policy=policy, ctb=ctb)
    return enc_mod.EncodeResult(
        bitstream=bitstream,
        reconstruction=recon.astype(np.uint8),
        num_bits=len(bitstream) * 8,
        ctu_trees=trees,
        mode_map=mode_map,
        qp=qp,
        policy=policy,
    )


@contextlib.contextmanager
def _exact_f32():
    """cuBLAS and cuDNN in float32, not TF32, for the duration of the
    block: on the card the plain versions' float32 products of small
    integers must stay exact.  The caller's flags are back afterwards,
    also when the block raises."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def encode_arrays_wavefront2(frame_uint8: np.ndarray, qp: int, *,
                             lam_scale: float = 1.0, policy: str = "regular",
                             pnn=None, ctb: int = CTB,
                             enable_nxn: bool = True,
                             rate_evolve: bool = False, device="cuda",
                             impl: str = "kernel"):
    """The device half of `encode_frame_wavefront2`: returns (recon
    (H, W) uint8, grids), grids being `_assemble_arrays`' tuple.
    `impl="plain"` runs the plain versions of the kernels on the card (for
    comparing)."""
    return encode_arrays_wavefront2_batch(
        np.asarray(frame_uint8)[None], qp, lam_scale=lam_scale,
        policy=policy, pnn=pnn, ctb=ctb, enable_nxn=enable_nxn,
        rate_evolve=rate_evolve, device=device, impl=impl)[0]


@traced("w2.encode_batch", batch=True)
def encode_arrays_wavefront2_batch(frames_uint8: np.ndarray, qp: int, *,
                                   lam_scale: float = 1.0,
                                   policy: str = "regular", pnn=None,
                                   ctb: int = CTB, enable_nxn: bool = True,
                                   rate_evolve: bool = False, device="cuda",
                                   impl: str = "kernel"):
    """The device half of `encode_frames_wavefront2_batch`: the (B, H, W)
    frames through one B-frame plan; returns one (recon (H, W) uint8,
    grids) per frame.  Span `w2.encode_batch`."""
    device = torch.device(device)
    bundle = getattr(pnn, "bundle", pnn)
    frames = np.asarray(frames_uint8)
    nf, h, w = frames.shape
    plan, dp = _get_plan(h, w, qp, lam_scale, ctb, enable_nxn, rate_evolve,
                         device, policy=policy, bundle=bundle, n_frames=nf)
    recon, ys = run(plan, dp, frames, impl=impl)
    return [(recon[f], _assemble_arrays(_frame_ys(ys, nf, f), h, w, ctb))
            for f in range(nf)]


def encode_stripe_halo(stripe_uint8: np.ndarray, qp: int, group, *,
                       policy: str = "regular", pnn=None, device="cuda"):
    """This rank's stripe (H_s, W) of a frame split into the process
    group's stripes of CTB rows, encoded on the global schedule with the
    halo exchange (the JAX package's `_jitted_wavefront2(..., halo_axis,
    n_tiles)`, CTB 32, NxN on, rate evolution off): (recon (H_s, W)
    uint8, ys at the global steps), numpy.  Every rank of `group` calls it
    at the same time."""
    stripe = np.asarray(stripe_uint8)
    h, w = stripe.shape
    d, ranks = mesh.group_position(group)
    plan, dp = _get_plan(h, w, qp, 1.0, CTB, True, False,
                         torch.device(device), policy=policy,
                         bundle=getattr(pnn, "bundle", pnn), halo=True,
                         n_tiles=len(ranks), stripe=d)
    recon, ys = run(plan, dp, stripe[None], group=group)
    return recon[0], ys


def encode_frame_wavefront2(frame_uint8: np.ndarray, qp: int, *,
                            serialize: bool = True, lam_scale: float = 1.0,
                            policy: str = "regular", pnn=None,
                            ctb: int = CTB, enable_nxn: bool = True,
                            rate_evolve: bool = False, device="cuda"):
    """Quadtree wavefront encode -> EncodeResult (own bitstream).

    `policy` in {regular, substitution, switch}; the NN policies take `pnn`,
    a `codec.nn_intra.PnnBundle` with quantized models (or an object with
    such a `.bundle`).  The port covers CTB 32.
    `rate_evolve` turns on the live rate-state evolution (the JAX
    package reads its default from `CANP_RATE_EVOLVE`; the port takes it
    as an argument only).  Runs on `device` ("cuda" by default; "cpu"
    runs the plain PyTorch versions of the kernels)."""
    recon, grids = encode_arrays_wavefront2(
        frame_uint8, qp, lam_scale=lam_scale, policy=policy, pnn=pnn,
        ctb=ctb, enable_nxn=enable_nxn, rate_evolve=rate_evolve,
        device=device)
    return _arrays_to_result(frame_uint8, qp, (recon,) + grids, policy,
                             serialize, ctb=ctb)


def encode_frame_wavefront2_hm(frame_uint8: np.ndarray, qp: int, *,
                               loop_filters: bool = True,
                               lam_scale: float = 1.0,
                               policy: str = "regular", pnn=None,
                               ctb: int = CTB, enable_nxn: bool = True,
                               rate_evolve: bool = False, device="cuda"):
    """Wavefront device encode -> standard Annex-B HEVC stream (JAX package
    :1951-1999), CTB 32 or 64.

    With `loop_filters`, deblocking (`codec/deblock.deblock_luma`, native
    on the host) and SAO (`codec/sao`, estimated against the source with
    HM's lambda) run on the decided reconstruction, as normative post-passes
    for All-Intra; a decoded-picture-hash SEI of the final picture is
    embedded.  Returns (annexb_stream, EncodeResult) with the final
    reconstruction, the stream and its bits.  NN-policy streams use the
    reference's extended syntax (substitution: PNN semantics on mode 18;
    switch: a leading PNNS bin)."""
    res = encode_frame_wavefront2(
        frame_uint8, qp, serialize=False, lam_scale=lam_scale,
        policy=policy, pnn=pnn, ctb=ctb, enable_nxn=enable_nxn,
        rate_evolve=rate_evolve, device=device)
    h, w = frame_uint8.shape
    sao_grid = None
    if loop_filters:
        # Unit-granular TU ids from the decided trees (the deblocking edge
        # rule).
        tu_ids = np.zeros((h // 4, w // 4), np.int32)
        tid = 0
        for node in res.ctu_trees:
            stack = [node]
            while stack:
                nd = stack.pop()
                if nd.split:
                    stack.extend(nd.children)
                    continue
                for pu in nd.pus:
                    for tu in pu.tus:
                        tu_ids[tu.y // 4:(tu.y + tu.n) // 4,
                               tu.x // 4:(tu.x + tu.n) // 4] = tid
                        tid += 1
        final = deblock.deblock_luma(res.reconstruction, tu_ids, qp)
        sao_grid = sao_mod.estimate_frame(frame_uint8, final, ctb,
                                          rdo.lambda_for_qp(qp))
        res.reconstruction = sao_mod.apply_sao(final, sao_grid, ctb)
    stream = hm_encoder.assemble_hm_stream(
        res, sao_enabled=loop_filters, deblocking=loop_filters,
        sign_hiding=True, transform_skip=False, max_tu_depth=0,
        sao_grid=sao_grid, ctu_size=ctb)
    res.bitstream = stream
    res.num_bits = len(stream) * 8
    return stream, res


def encode_frames_wavefront2_batch(frames_uint8: np.ndarray, qp: int, *,
                                   lam_scale: float = 1.0,
                                   policy: str = "regular", pnn=None,
                                   serialize: bool = False, ctb: int = CTB,
                                   enable_nxn: bool = True,
                                   rate_evolve: bool = False, device="cuda"):
    """Encodes a batch of frames (B, H, W) through one B-frame wavefront
    plan (JAX package :1786-1832): the frames are interleaved into the
    plane axis, so every launch of a sub-stage carries B frames' units at
    the same sequential depth.  Each frame's result equals its own
    `encode_frame_wavefront2`.  Returns a list of `EncodeResult`
    (bitstreams empty unless `serialize`)."""
    frames = np.asarray(frames_uint8)
    out = encode_arrays_wavefront2_batch(
        frames, qp, lam_scale=lam_scale, policy=policy, pnn=pnn, ctb=ctb,
        enable_nxn=enable_nxn, rate_evolve=rate_evolve, device=device)
    return [_arrays_to_result(frames[f], qp, (recon,) + grids, policy,
                              serialize, ctb=ctb)
            for f, (recon, grids) in enumerate(out)]


def _host_pack_one(args):
    """Process-pool worker: one frame's grid assembly and native CABAC pack
    (module level, so it pickles).  Returns the stream's bytes."""
    ys_f, h, w, qp, policy, ctb = args
    grids = _assemble_arrays(ys_f, h, w, ctb)
    return _serialize_grids(grids, width=w, height=h, qp=qp, policy=policy,
                            ctb=ctb)


def encode_stream_wavefront2(frames_iter, qp: int, *, batch: int = 16,
                             lam_scale: float = 1.0, policy: str = "regular",
                             pnn=None, ctb: int = CTB,
                             enable_nxn: bool = True,
                             rate_evolve: bool = False,
                             build_trees: bool = False, workers: int = 0,
                             device="cuda"):
    """Sustained encoder over a stream of (H, W) frames, `batch` frames a
    device run (JAX package :1835-1949).  Yields `EncodeResult`s in input
    order, bitstreams always filled (`ctu_trees` and `mode_map` only with
    `build_trees`; the packer reads the grids directly).  A last partial
    batch is padded with copies of its last frame; only its own frames'
    results come out.

    The host half of a batch (per-frame assembly and the native pack)
    runs inline after its device half: the step loop is issued from
    Python, and on the card a worker thread for it was not faster.
    `workers` > 0 fans the per-frame assembly and pack over a `spawn`
    process pool, which is shut down when the generator ends or is
    closed.

    Spans: `w2.encode_batch` over a batch, and in it `w2.pack` over the
    host half (each frame's assembly and pack, inline or over the pool;
    the pool's workers record no spans)."""
    device = torch.device(device)
    bundle = getattr(pnn, "bundle", pnn)
    pool = None
    if workers > 0 and not build_trees:
        pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn"))

    @traced("w2.encode_batch", batch=True)
    def encode_batch(frames, n_valid):
        h, w = frames.shape[1:]
        plan, dp = _get_plan(h, w, qp, lam_scale, ctb, enable_nxn,
                             rate_evolve, device, policy=policy,
                             bundle=bundle, n_frames=batch)
        recon, ys = run(plan, dp, frames)
        per_frame = [_frame_ys(ys, batch, f) for f in range(n_valid)]
        if build_trees:
            return [_arrays_to_result(
                frames[f], qp, (recon[f],) + _assemble_arrays(
                    per_frame[f], h, w, ctb), policy, True, ctb=ctb)
                for f in range(n_valid)]
        args = [(ys_f, h, w, qp, policy, ctb) for ys_f in per_frame]
        with span("w2.pack"):
            streams = list(pool.map(_host_pack_one, args) if pool is not None
                           else map(_host_pack_one, args))
        return [enc_mod.EncodeResult(
            bitstream=stream, reconstruction=recon[f],
            num_bits=len(stream) * 8, ctu_trees=None, mode_map=None,
            qp=qp, policy=policy) for f, stream in enumerate(streams)]

    buf = []
    try:
        for frame in frames_iter:
            frame = np.asarray(frame)
            if buf and frame.shape != buf[0].shape:
                raise ValueError(f"frame {frame.shape} != {buf[0].shape}")
            buf.append(frame)
            if len(buf) == batch:
                yield from encode_batch(np.stack(buf), batch)
                buf = []
        if buf:
            n_valid = len(buf)
            yield from encode_batch(
                np.stack(buf + [buf[-1]] * (batch - n_valid)), n_valid)
    finally:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
