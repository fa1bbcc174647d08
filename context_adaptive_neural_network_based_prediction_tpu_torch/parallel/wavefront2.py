"""Wavefront v2 quadtree encoder (CTB 32, one frame; regular, substitution
and switch policies).

The port of the JAX package's `parallel/wavefront2.py` for the
configuration its benchmark times, one frame at a time.  CTBs run along
anti-diagonals t = bx + 2*by; at each z-order sub-stage every n x n unit of
every CTB on the diagonal (one "slot" per CTB) is tried at once by the
fused unit trial (`ops/unit_fused.py`, on the card the CUDA kernel of
`ops/csrc/unit_trial.cu`).  The quadtree 32 -> 16 -> 8 (-> four 4x4 NxN
PUs) is decided in the same pass, and with `rate_evolve` each CTB row
carries live CABAC bin counts that steer later trials (WPP-style).

NN policies (the JAX package's :974-1030): with `policy="substitution"`
mode 18's prediction is the PNN's, with `policy="switch"` the PNN is a
signalled 36th mode (PNNS, mode 35).  Each trial of a width with a model
first extracts every slot's masked context from the evolving
reconstruction (two box reads and static per-position strip masks) and
runs the quantized integer forward (`models/pnn_q.py`, its merger on the
card the CUDA kernel of `ops/csrc/merger_int.cu`) over all slots at once;
integer sums make that batched forward equal to the sequential decoder's.
Under switch a width without a model predicts zeros for PNNS.

Skewed storage, as in the JAX package: the frame, the reconstruction, the
8x8 mode map, the 8x8 cell costs and the rate state are kept as per-CTB-
row planes with row `by` shifted right by 2*ctb*by, so a diagonal maps to
one column window across all planes and every commit is one box write over
the slot axis.  Slots that lie outside the frame write into margins that
no valid read touches.  The port updates these planes IN PLACE: the JAX
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
trees and packed by the native CABAC packer.  Not ported yet: CTB 64,
frame batching, halo sharding, streaming, Annex-B.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..codec import encoder as enc_mod
from ..codec import native, rdo
from ..models import pnn_q
from ..ops import intra, transform, unit_fused
from ..ops import reference_samples as rs
from . import rate_model

CTB = 32
NN_SIZES = (4, 8, 16, 32)   # unit sizes a PNN can serve at CTB 32
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
                      n_frames: int = 1, rate_evolve: bool = False) -> dict:
    """The encoder's plan: geometry, per-size constants and LUTs (numpy).

    Mirrors the table-building half of the JAX package's
    `_build_wavefront2` (`parallel/wavefront2.py:208-535`) for CTB 32, one
    frame and no halo; every table is equal to the JAX package's.  NN
    policies take a `PnnBundle` with quantized models."""
    if policy not in ("regular", "substitution", "switch"):
        raise ValueError(f"unknown policy {policy!r}")
    if policy != "regular" and bundle is None:
        raise ValueError("NN policies need a quantized PnnBundle")
    qmodels = bundle.quantized_for_qp(qp) \
        if bundle is not None and policy != "regular" else {}
    if policy != "regular" and not qmodels:
        raise ValueError("the bundle has no quantized models")
    nn_widths = tuple(sorted(w for w in qmodels if w in NN_SIZES))
    if ctb != 32:
        raise NotImplementedError("the port covers CTB 32")
    if n_frames != 1:
        raise NotImplementedError("the port encodes one frame per call")
    if height % ctb or width % ctb:
        raise ValueError(f"wavefront2 needs frame dims that are multiples "
                         f"of {ctb} (crop/pad first)")
    n_modes = 36 if policy == "switch" else 35
    sbx, sby = width // ctb, height // ctb
    n_steps = (sbx - 1) + 2 * (sby - 1) + 1
    b_max = min(sby, (sbx + 1) // 2 + 1)
    b_eff = b_max
    # Skew geometry (JAX package :281-305).  OFF: left margin so reads two
    # planes up (x' -= 2*ctb) and 2n left stay in bounds at t=0; PH: plane
    # height with 32 pad rows; WIN: a step's working window.
    OFF = 2 * ctb + 64
    W_sk = n_steps * ctb + OFF + 32
    WIN = OFF + ctb + 32
    PH = ctb + 32
    n_planes = ROW0 + sby + b_max - 1
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
        tt, tl = _fill_tables(height, width, n, ctb)
        ctab, cmap = _dedupe(np.stack([_skew_triplets(tt, tl, n, ctb,
                                                      OFF)]))
        stab, smap = _dedupe(np.stack([_sel_tables(tt, tl, n)]))
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
            nn_tab, nn_cmap = _dedupe(np.stack([np.concatenate(
                [ctx_ok[..., None].astype(np.float32), am, lm], -1)]))
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
                sbx=sbx, sby=sby, n_steps=n_steps,
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


def _substage_classes(plan, n, cmap):
    """(n_steps, n_sub, b) int: the class (of a (1, nby, nbx) class map) of
    the n x n unit of every step, sub-stage (in the order
    `_z_offsets(ctb, n)` gives) and slot; slots off the frame take the
    clipped position, as the JAX package's gathers clip."""
    ctb, b = plan["ctb"], plan["b_eff"]
    by, bx, _ = _schedule(plan["sby"], plan["sbx"], b, plan["n_steps"])
    un = ctb // n
    out = []
    for ly, lx in _z_offsets(ctb, n):
        by_n = np.clip(by * un + ly // n, 0, plan["height"] // n - 1)
        bx_n = np.clip(bx * un + lx // n, 0, plan["width"] // n - 1)
        out.append(cmap[0, by_n, bx_n])                    # (T, b)
    return np.stack(out, axis=1)


def _device_plan(plan, device):
    """The plan's tensors on `device`: per-size trial constants, reference
    selection indices per (step, sub-stage, slot), mode-bit and rate-state
    LUTs, and for each NN width the model's tensors and the context masks
    per (step, sub-stage, slot)."""
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
    _, bx, _ = _schedule(plan["sby"], plan["sbx"], plan["b_eff"],
                         plan["n_steps"])
    dp["bx"] = torch.from_numpy(bx.astype(np.int32)).to(device)
    dp["mode_bits"] = torch.from_numpy(plan["MODE_BITS"]).to(device)
    if plan["rate_evolve"]:
        for k in ("RS_LUT0", "RS_LUT1", "RS_STAT0", "RS_STAT1"):
            dp[k] = torch.from_numpy(plan[k]).to(device)
    return dp


_PLAN_CACHE: dict = {}
_PLAN_CACHE_MAX = 4


def _get_plan(height, width, qp, lam_scale, ctb, enable_nxn, rate_evolve,
              device, policy="regular", bundle=None):
    """The cached (plan, device plan).  The key holds every argument the
    plan reads, the bundle by identity; an entry keeps its bundle alive,
    so the identity stays valid."""
    key = (height, width, qp, lam_scale, ctb, enable_nxn, rate_evolve,
           str(device), policy, id(bundle))
    hit = _PLAN_CACHE.get(key)
    if hit is None:
        plan = _build_wavefront2(height, width, qp, lam_scale, policy=policy,
                                 bundle=bundle, ctb=ctb,
                                 enable_nxn=enable_nxn,
                                 rate_evolve=rate_evolve)
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


def _new_ys(plan, device):
    """Per-step decision outputs, preallocated: shapes of the JAX
    package's stacked scan outputs (leading axis n_steps, slot axis b)."""
    T, b = plan["n_steps"], plan["b_eff"]
    i8, i16 = torch.int8, torch.int16
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    ys = dict(
        m8=z((T, 4, 4, b), i8), q8=z((T, 4, 4, b, 8, 8), i16),
        s8=z((T, 4, 4, b), i8),
        m16=z((T, 4, b), i8), q16=z((T, 4, b, 16, 16), i16),
        s16=z((T, 4, b), i8),
        m32=z((T, b), i8), q32=z((T, b, 32, 32), i16), s32=z((T, b), i8))
    if plan["enable_nxn"]:
        ys.update(m4=z((T, 4, 4, 4, b), i8), q4=z((T, 4, 4, 4, b, 4, 4), i16))
    return ys


def _step(plan, dp, st, ys, t, impl):
    """One wavefront step: the CTB-32 quadtree of every slot on diagonal t
    (JAX package `step`, :844-1475, the `ctb == 32` branch)."""
    ctb, b, OFF, WIN = plan["ctb"], plan["b_eff"], plan["OFF"], plan["WIN"]
    cu8, OFF8 = plan["cu8"], plan["OFF8"]
    lam, SB = plan["lam"], plan["SB"]
    f32c = unit_fused._f32
    dev = st["recon"].device
    i32, f32 = torch.int32, torch.float32
    rate_evolve = plan["rate_evolve"]
    ws = t * ctb
    # The step's working window, as a view: commits land in the planes.
    work = _box(st["recon"], 0, st["recon"].shape[0], 0, plan["PH"], ws,
                WIN)
    by0 = max(0, -((plan["sbx"] - 1 - t) // 2))
    bx_ids = dp["bx"][t]                                  # (b,)
    sub = {4: 0, 8: 0, 16: 0, 32: 0}                       # sub-stage ids

    rate_rows_by_n = {4: None, 8: None, 16: None, 32: None}
    if rate_evolve:
        # WPP inherit: a slot entering its row (bx == 0) adopts the row
        # above's state, which at step t has coded its 2nd CTB.
        rs_sk = st["rs"]
        above = _box(rs_sk, by0 + ROW0 - 1, b, 0, 8, 0, 16)
        cur = _box(rs_sk, by0 + ROW0, b, 0, 8, 0, 16)
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
        row_above = _box(work, by0 + ROW0 - up, b,
                         ctb - 1 if ly == 0 else ly - 1, 1,
                         lx - 1 - 2 * ctb * up + OFF, 2 * n + 1)[:, 0, :]
        col_left = _box(work, by0 + ROW0, b, ly, 2 * n,
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
        lm_read = _box(m8, by0, b, ly8, 1, x8i - 1, 1)[:, 0, 0]
        lm = torch.where(bx_ids * ctb + lx >= 8, lm_read, 1)
        # 4x4 sub-blocks whose top edge is not 8-aligned, and the CTB's
        # top row, take DC as the above mode.
        if ly >= 8 and ly % 8 == 0:
            am = _box(m8, by0, b, ly8 - 1, 1, x8i, 1)[:, 0, 0]
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
        above_pix = _box(work, by0 + ROW0 - up, b,
                         ctb - n if ly == 0 else ly - n, n,
                         lx - n - 2 * ctb * up + OFF, 3 * n)
        left_pix = _box(work, by0 + ROW0, b, ly, 2 * n, lx - n + OFF, n)
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
        orig = _box(st["frame"], by0, b, ly, n, t * ctb + lx + OFF,
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
        _commit(work, rec, by0 + ROW0, ly, lx + OFF, cond)

    def commit_cell8(buf, vals, ly, lx):
        _commit(buf, vals[:, None, None], by0, ly // 8,
                t * cu8 + lx // 8 + OFF8)

    def commit_mode_fill(modes, ly, lx, k, cond):
        fill = modes[:, None, None].expand(b, k, k)
        _commit(st["mode8"], fill, by0, ly // 8, t * cu8 + lx // 8 + OFF8,
                cond)

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
    qsum = torch.zeros((b,), dtype=f32, device=dev)
    qa4, qa8, qa16 = zeros8(), zeros8(), zeros8()
    for quad in range(4):
        qdx, qdy = quad & 1, quad >> 1
        zb4, zb8 = zeros8(), zeros8()
        for z in range(4):
            ly8 = (qdy * 2 + (z >> 1)) * 8
            lx8 = (qdx * 2 + (z & 1)) * 8
            if plan["enable_nxn"]:
                # NxN: the four 4x4 PUs predict from the evolving
                # reconstruction; if 2Nx2N wins, its rec overwrites them.
                cost_nxn = torch.zeros((b,), dtype=f32, device=dev)
                cnt_nxn = zeros8()
                for s4 in range(4):
                    ly4 = ly8 + (s4 >> 1) * 4
                    lx4 = lx8 + (s4 & 1) * 4
                    c4, m4b, rec4, q4b, cn4 = encode_unit_b(4, ly4, lx4)
                    commit_rec(rec4, ly4, lx4)
                    cost_nxn = cost_nxn + c4
                    cnt_nxn = cnt_nxn + cn4
                    ys["m4"][t, quad, z, s4] = m4b.to(torch.int8)
                    ys["q4"][t, quad, z, s4] = q4b.to(torch.int16)
                last_m4 = m4b
                # The 8x8 2Nx2N trial reads only outside the cell, so
                # running it after the 4x4 chain is exact.
                cost8, mode8b, rec8, q8b, cn8 = encode_unit_b(8, ly8, lx8)
                use2n = cost8 + lam_p2n < cost_nxn + lam_pnxn
                cell_cost = torch.where(use2n, cost8 + lam_p2n,
                                        cost_nxn + lam_pnxn)
            else:
                cost8, mode8b, rec8, q8b, cn8 = encode_unit_b(8, ly8, lx8)
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
            ys["m8"][t, quad, z] = mode8b.to(torch.int8)
            ys["q8"][t, quad, z] = q8b.to(torch.int16)
            ys["s8"][t, quad, z] = (~use2n).to(torch.int8)
            if rate_evolve:
                u2 = use2n[:, None]
                zb4 = zb4 + torch.where(u2, 0, cnt_nxn)
                zb8 = zb8 + torch.where(u2, cn8, 0)

        ly16, lx16 = qdy * 16, qdx * 16
        cost16, mode16, rec16, qq16, cn16 = encode_unit_b(16, ly16, lx16)
        # Fixed-order adds over the 2x2 cell costs.
        csub = _box(st["c8"], by0, b, ly16 // 8, 2,
                    t * cu8 + lx16 // 8 + OFF8, 2)
        cost8s = (((csub[:, 0, 0] + csub[:, 0, 1]) + csub[:, 1, 0])
                  + csub[:, 1, 1]) + lam_s1
        cost16f = cost16 + lam_s0
        use16 = cost16f < cost8s
        qcost_q = torch.where(use16, cost16f, cost8s)
        commit_rec(rec16, ly16, lx16, use16)
        commit_mode_fill(mode16, ly16, lx16, 2, use16)
        ys["m16"][t, quad] = mode16.to(torch.int8)
        ys["q16"][t, quad] = qq16.to(torch.int16)
        ys["s16"][t, quad] = (~use16).to(torch.int8)
        if rate_evolve:
            u16 = use16[:, None]
            qa4 = qa4 + torch.where(u16, 0, zb4)
            qa8 = qa8 + torch.where(u16, 0, zb8)
            qa16 = qa16 + torch.where(u16, cn16, 0)
        qsum = qsum + qcost_q

    # --- 32x32 candidate ---
    cost32, mode32, rec32, qq32, cn32 = encode_unit_b(32, 0, 0)
    cost_quads = qsum + lam_s1
    cost32f = cost32 + lam_s0
    use32 = cost32f < cost_quads
    commit_rec(rec32, 0, 0, use32)
    commit_mode_fill(mode32, 0, 0, 4, use32)
    ys["m32"][t] = mode32.to(torch.int8)
    ys["q32"][t] = qq32.to(torch.int16)
    ys["s32"][t] = (~use32).to(torch.int8)

    if rate_evolve:
        u32 = use32[:, None]
        fb4 = torch.where(u32, 0, qa4)
        fb8 = torch.where(u32, 0, qa8)
        fb16 = torch.where(u32, 0, qa16)
        fb32 = torch.where(u32, cn32, 0)
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
        _commit(rs_sk, blk, by0 + ROW0, 0, 0)


def run(plan, dp, frame_u8, impl="kernel"):
    """The device half of the encode: returns (recon (H, W) uint8 numpy,
    ys dict of numpy per-step decisions)."""
    dev = dp["mode_bits"].device
    ctb, OFF, W_sk = plan["ctb"], plan["OFF"], plan["W_sk"]
    sby, b_max = plan["sby"], plan["b_max"]
    height, width = plan["height"], plan["width"]
    i32 = torch.int32
    frame = torch.as_tensor(np.ascontiguousarray(frame_u8)).to(
        device=dev, dtype=i32)
    if tuple(frame.shape) != (height, width):
        raise ValueError(f"frame {tuple(frame.shape)} != plan "
                         f"{(height, width)}")
    frame_sk = torch.zeros((sby + b_max - 1, ctb, W_sk), dtype=i32,
                           device=dev)
    for by in range(sby):
        x0 = OFF + 2 * ctb * by
        frame_sk[by, :, x0:x0 + width] = frame[by * ctb:(by + 1) * ctb]
    st = dict(
        frame=frame_sk,
        recon=torch.zeros((plan["n_planes"], plan["PH"], W_sk), dtype=i32,
                          device=dev),
        mode8=torch.ones((sby + b_max - 1, plan["cu8"], plan["W8"]),
                         dtype=i32, device=dev),
        c8=torch.zeros((sby + b_max - 1, plan["cu8"], plan["W8"]),
                       dtype=torch.float32, device=dev))
    if plan["rate_evolve"]:
        st["rs"] = torch.zeros((plan["n_planes"], 8, 16), dtype=i32,
                               device=dev)
    ys = _new_ys(plan, dev)
    for t in range(plan["n_steps"]):
        _step(plan, dp, st, ys, t, impl)
    recon = torch.cat([
        st["recon"][ROW0 + by, :ctb, OFF + 2 * ctb * by:
                    OFF + 2 * ctb * by + width] for by in range(sby)], 0)
    return (recon.to(torch.uint8).cpu().numpy(),
            {k: v.cpu().numpy() for k, v in ys.items()})


def _assemble_arrays(ys, height, width, ctb=CTB, t_offset=0):
    """Stacked per-step outputs -> the decided grids (m8, q8, s8, m4, q4,
    m16, q16, s16, m32, q32, s32), CTB 32 (JAX package :1531-1613)."""
    if ctb != 32:
        raise NotImplementedError("the port assembles CTB-32 grids")
    ys = {k: np.asarray(v) for k, v in ys.items()}
    h4, w4 = height // 4, width // 4
    h8, w8 = height // 8, width // 8
    h16, w16 = height // 16, width // 16
    nby, nbx = height // 32, width // 32
    n_steps, b_max = ys["m32"].shape
    by, bx, ok = _schedule(nby, nbx, b_max, n_steps, t_offset)

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
    for quad in range(4):
        qdx, qdy = quad & 1, quad >> 1
        for z in range(4):
            zdx2 = qdx * 2 + (z & 1)
            zdy2 = qdy * 2 + (z >> 1)
            b8y = (by * 4 + zdy2)[ok]
            b8x = (bx * 4 + zdx2)[ok]
            m8[b8y, b8x] = ys["m8"][:, quad, z][ok]
            q8[b8y, b8x] = ys["q8"][:, quad, z][ok]
            s8[b8y, b8x] = ys["s8"][:, quad, z][ok]
            if has_nxn:
                for s4 in range(4):
                    sdx, sdy = s4 & 1, s4 >> 1
                    b4y = (by * 4 + zdy2) * 2 + sdy
                    b4x = (bx * 4 + zdx2) * 2 + sdx
                    m4[b4y[ok], b4x[ok]] = ys["m4"][:, quad, z, s4][ok]
                    q4[b4y[ok], b4x[ok]] = ys["q4"][:, quad, z, s4][ok]
        b16y = (by * 2 + qdy)[ok]
        b16x = (bx * 2 + qdx)[ok]
        m16[b16y, b16x] = ys["m16"][:, quad][ok]
        q16[b16y, b16x] = ys["q16"][:, quad][ok]
        s16[b16y, b16x] = ys["s16"][:, quad][ok]
    m32[by[ok], bx[ok]] = ys["m32"][ok]
    q32[by[ok], bx[ok]] = ys["q32"][ok]
    s32[by[ok], bx[ok]] = ys["s32"][ok]
    return (m8, q8, s8, m4, q4, m16, q16, s16, m32, q32, s32)


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
    """Decided grids -> CuNode trees (+ CABAC serialization), CTB 32
    (JAX package :1663-1773)."""
    (recon, m8, q8, s8, m4, q4, m16, q16, s16, m32, q32, s32) = arrays
    h, w = frame_uint8.shape
    trees = []
    mode_map = np.full((h // 4, w // 4), -1, np.int32)

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
            return leaf(x, y, 32, m32[by, bx], q32[by, bx])
        root = enc_mod.CuNode(x, y, 32, 0, split=True)
        for quad in range(4):
            qx = x + (quad & 1) * 16
            qy = y + (quad >> 1) * 16
            b16y, b16x = qy // 16, qx // 16
            if not s16[b16y, b16x]:
                child = leaf(qx, qy, 16, m16[b16y, b16x], q16[b16y, b16x])
                child.depth = 1
            else:
                child = enc_mod.CuNode(qx, qy, 16, 1, split=True)
                for z in range(4):
                    g = leaf8(qx + (z & 1) * 8, qy + (z >> 1) * 8)
                    g.depth = 2
                    child.children.append(g)
            root.children.append(child)
        return root

    for by in range(h // 32):
        for bx in range(w // 32):
            trees.append(tree32(bx * 32, by * 32))

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


def _prepare_device(device):
    device = torch.device(device)
    if device.type == "cuda":
        # The plain version's float32 products must stay exact.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


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
    device = _prepare_device(device)
    bundle = getattr(pnn, "bundle", pnn)
    h, w = frame_uint8.shape
    plan, dp = _get_plan(h, w, qp, lam_scale, ctb, enable_nxn, rate_evolve,
                         device, policy=policy, bundle=bundle)
    recon, ys = run(plan, dp, frame_uint8, impl=impl)
    return recon, _assemble_arrays(ys, h, w, ctb)


def encode_frame_wavefront2(frame_uint8: np.ndarray, qp: int, *,
                            serialize: bool = True, lam_scale: float = 1.0,
                            policy: str = "regular", pnn=None,
                            ctb: int = CTB, enable_nxn: bool = True,
                            rate_evolve: bool = False, device="cuda"):
    """Quadtree wavefront encode -> EncodeResult (own bitstream).

    `policy` in {regular, substitution, switch}; the NN policies take `pnn`,
    a `codec.nn_intra.PnnBundle` with quantized models (or an object with
    such a `.bundle`).  The port covers CTB 32, one frame per call.
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
