"""The v1 uniform-grid wavefront encoder in plain PyTorch, and the
container stream of its decisions by the Python CABAC coder: the
benchmark's reference for the port's `parallel/wavefront.py`.

A frozen copy of the port's single-device path (its plan, reference
gather, [1 2 1] filter, step and result), with the Python serializer
(`container.serialize_trees`, byte for byte the native `pack_grid`
stream).  Every n x n block is its own CU with one 2Nx2N PU and one TU;
blocks run along the anti-diagonals t = bx + 2*by; one step tries every
slot's block in all 35 modes: references (clamped at the frame's
edges) -> HM fill and [1 2 1] filter -> 35-mode prediction -> forward
transform, plain scalar quantisation, dequantisation, inverse transform
-> cost = SSE + lambda * (rate proxy + mode bits) -> first minimum ->
commit.  The transforms are float64 products of integers (exact);
`precision` (one of `precision.PRECISIONS`) computes them in a lower
precision for the control.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import container, intra, precision as prec, syntax, transform
from .reference_samples import DC_FILL, FILTER_THRESHOLD
from .wavefront2 import lambda_for_qp

RATE_TABLE_SIZE = 1 << 15        # |q| < 2^15 at every QP and size


@functools.lru_cache(maxsize=None)
def rate_table() -> np.ndarray:
    """float32 2*log2(1+k)+1 for k in 0..32767, 0 at k = 0: the per-level
    rate proxy, computed in float64 and rounded once to float32."""
    k = np.arange(RATE_TABLE_SIZE, dtype=np.float64)
    table = (2.0 * np.log2(1.0 + k) + 1.0).astype(np.float32)
    table[0] = 0.0
    return table


@functools.lru_cache(maxsize=None)
def mode_bits_table() -> np.ndarray:
    """(35, 35) float32: the mode bits of every mode (columns) given the
    left neighbour's mode (rows); the above neighbour is DC: 2 for the
    first MPM, 3 for the others, 6 otherwise."""
    out = np.full((35, 35), 6.0, np.float32)
    for left in range(35):
        mpms = syntax.mpm_candidates(left, syntax.DC_IDX)
        out[left, mpms] = 3.0
        out[left, mpms[0]] = 2.0
    return out


def _build_plan(height: int, width: int, n: int, qp: int, n_frames: int):
    """The host tables of an encode: the step schedule and, per (step,
    slot), the flat indices of every read and write."""
    if height % n or width % n:
        raise ValueError("frame dims must be multiples of the block size")
    nbx, nby = width // n, height // n
    n_steps = (nbx - 1) + 2 * (nby - 1) + 1
    b_max = min(nby, (nbx + 1) // 2 + 1)
    nf = n_frames
    ts = np.arange(n_steps)
    by = np.maximum(0, -((nbx - 1 - ts) // 2))[:, None] + np.arange(b_max)
    bx = ts[:, None] - 2 * by
    valid = (by < nby) & (bx >= 0) & (bx < nbx)
    # Slots off the frame compute on the clamped block.
    b_y = np.minimum(by, nby - 1)
    b_x = np.clip(bx, 0, nbx - 1)
    rep = lambda a: np.repeat(a, nf, axis=1)           # (T, b_max * NF)
    b_y, b_x, valid = rep(b_y), rep(b_x), rep(valid)
    f = np.tile(np.arange(nf), b_max)[None, :]
    plane = (height + n) * width                      # one frame's buffer
    y, x = b_y * n, b_x * n
    # References: the row above at columns x-1 .. x+2n-1 and the column
    # left at rows y .. y+2n-1, clamped to the frame.
    cols = np.clip(x[..., None] - 1 + np.arange(2 * n + 1), 0, width - 1)
    top_row = np.clip(y - 1, 0, height - 1)[..., None]
    rows = np.clip(y[..., None] + np.arange(2 * n), 0, height - 1)
    left_col = np.clip(x - 1, 0, width - 1)[..., None]
    ref_idx = np.concatenate([top_row * width + cols,
                              rows * width + left_col], -1) \
        + (f * plane)[..., None]
    # The block's origin in the frame and recon buffers; off the frame,
    # the pad rows below it.
    blk = np.where(valid, y * width + x, height * width) + f * plane
    cells = (nby + 1) * nbx
    cell = np.where(valid, b_y * nbx + b_x, nby * nbx) + f * cells
    left_cell = b_y * nbx + np.maximum(b_x - 1, 0) + f * cells
    lam = lambda_for_qp(qp)
    log2n = n.bit_length() - 1
    per, rem = qp // 6, qp % 6
    tshift = 15 - 8 - log2n
    qbits = 14 + per + tshift
    use_filtered = np.array(
        [m != 1 and min(abs(m - 10), abs(m - 26)) > FILTER_THRESHOLD[n]
         for m in range(35)])
    has_above = b_y > 0
    return dict(
        height=height, width=width, n=n, qp=qp, n_frames=nf, nbx=nbx,
        nby=nby, n_steps=n_steps, b_max=b_max, b_eff=b_max * nf,
        plane=plane, cells=cells,
        ref_idx=ref_idx.astype(np.int64), blk=blk.astype(np.int64),
        cell=cell.astype(np.int64), left_cell=left_cell.astype(np.int64),
        has_above=has_above, has_left=b_x > 0,
        has_ar=has_above & (b_x < nbx - 1),
        blk_off=(np.arange(n)[:, None] * width
                 + np.arange(n)[None, :]).reshape(-1).astype(np.int64),
        use_filtered=use_filtered,
        t_mat=transform.dct_matrix(n).astype(np.float64),
        shift1=log2n + 8 + 6 - 15, shift2=log2n + 6,
        qscale=transform.QUANT_SCALES[rem], qbits=qbits,
        qadd=171 << (qbits - 9),
        lam=np.array(lam, np.float32), rate=rate_table(),
        mode_bits=mode_bits_table())


def _device_plan(plan, device):
    """The plan's arrays as tensors on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in plan.items() if isinstance(v, np.ndarray)}


def _refs(plan, dp, raw, t):
    """HM references of every slot: (ref_top, ref_left), each (b_eff,
    2n+1) int32, from the raw clamped gathers."""
    n = plan["n"]
    top_raw, left_raw = raw[:, :2 * n + 1], raw[:, 2 * n + 1:]
    ha = dp["has_above"][t][:, None]
    hl = dp["has_left"][t][:, None]
    har = dp["has_ar"][t][:, None]
    # Below-left is never coded in raster order: replicate left[n-1];
    # above-right without a coded block: replicate top[n-1].
    left_col = torch.cat([left_raw[:, :n],
                          left_raw[:, n - 1:n].expand(-1, n)], 1)
    keep = torch.arange(2 * n + 1, device=raw.device) <= n
    top_row = torch.where(keep | har, top_raw, top_raw[:, n:n + 1])
    first_above = top_raw[:, 1:2]
    top_above_only = torch.cat([first_above, top_row[:, 1:]], 1)
    dc = torch.full_like(top_raw, DC_FILL)
    ref_top = torch.where(ha, torch.where(hl, top_row, top_above_only),
                          torch.where(hl, left_raw[:, :1].expand_as(top_raw),
                                      dc))
    ref_left_body = torch.where(
        ha, torch.where(hl, left_col, first_above.expand_as(left_col)),
        torch.where(hl, left_col, dc[:, :2 * n]))
    return ref_top, torch.cat([ref_top[:, :1], ref_left_body], 1)


def _filter(ref_top, ref_left, n):
    """[1 2 1] filter with unfiltered endpoints; no strong smoothing at
    n = 32."""
    corner, top, left = ref_top[:, :1], ref_top[:, 1:], ref_left[:, 1:]
    ext_t = torch.cat([left[:, :1], ref_top], 1)
    f_top_vals = (ext_t[:, :-2] + 2 * ext_t[:, 1:-1] + ext_t[:, 2:] + 2) >> 2
    f_top = torch.cat([f_top_vals[:, :2 * n], top[:, 2 * n - 1:]], 1)
    ext_l = torch.cat([top[:, :1], corner, left], 1)
    f_left_vals = (ext_l[:, :-2] + 2 * ext_l[:, 1:-1] + ext_l[:, 2:] + 2) >> 2
    f_left = torch.cat([f_top[:, :1], f_left_vals[:, 1:2 * n],
                        left[:, 2 * n - 1:]], 1)
    return f_top, f_left


def _dequantize(q, qp: int, n: int):
    """HM's dequantiser, int64, clipped to 16 bits."""
    per, rem = qp // 6, qp % 6
    right_shift = transform.IQUANT_SHIFT - (
        transform.transform_shift(n.bit_length() - 1) + per)
    scale = transform.INV_QUANT_SCALES[rem]
    q = q.to(torch.int64)
    if right_shift > 0:
        c = (q * scale + (1 << (right_shift - 1))) >> right_shift
    else:
        c = (q * scale) << (-right_shift)
    return torch.clamp(c, -32768, 32767)


def _inverse(c, t, precision):
    """HM's inverse DCT of (..., n, n) coefficients: the first stage
    clipped to 16 bits, the result to HM's Pel range; int32."""
    shift1 = transform.TRANSFORM_MATRIX_SHIFT + 1
    shift2 = (transform.TRANSFORM_MATRIX_SHIFT
              + transform.MAX_TR_DYNAMIC_RANGE - 1) - transform.BIT_DEPTH
    e = torch.clamp((prec.matmul(t.T, c, precision) + (1 << (shift1 - 1)))
                    >> shift1, -32768, 32767)
    r = (prec.matmul(e, t, precision) + (1 << (shift2 - 1))) >> shift2
    return torch.clamp(r, -32768, 32767).to(torch.int32)


def _step(plan, dp, st, t, precision):
    """One wavefront step: every slot's block tried in all 35 modes, the
    cheapest committed."""
    n, b = plan["n"], plan["b_eff"]
    recon, frame = st["recon"], st["frame"]
    raw = recon[dp["ref_idx"][t]]
    ref_top, ref_left = _refs(plan, dp, raw, t)
    f_top, f_left = _filter(ref_top, ref_left, n)
    both = intra.predict_all_modes(torch.cat([ref_top, f_top]),
                                   torch.cat([ref_left, f_left]))
    preds = torch.where(dp["use_filtered"][None, :, None, None], both[b:],
                        both[:b])                              # (b, 35, n, n)
    blk = dp["blk"][t][:, None] + dp["blk_off"]                # (b, n*n)
    orig = frame[blk].view(b, 1, n, n)
    tm = dp["t_mat"]
    a = (prec.matmul(orig - preds, tm.T, precision)
         + (1 << (plan["shift1"] - 1))) >> plan["shift1"]
    coeff = (prec.matmul(tm, a, precision) + (1 << (plan["shift2"] - 1))) \
        >> plan["shift2"]
    mag = (coeff.abs() * plan["qscale"] + plan["qadd"]) >> plan["qbits"]
    q = torch.sign(coeff) * mag
    resi = _inverse(_dequantize(q, plan["qp"], n), tm.to(torch.int64),
                    precision)
    rec = torch.clamp(preds + resi, 0, 255)
    sse = ((rec - orig) ** 2).sum((2, 3)).to(torch.float32)
    coeff_bits = dp["rate"][q.abs()].to(torch.float64).sum((2, 3)).to(
        torch.float32) + 4.0
    left_mode = torch.where(dp["has_left"][t], st["modes"][dp["left_cell"][t]],
                            syntax.DC_IDX)
    mode_bits = dp["mode_bits"][left_mode]                     # (b, 35)
    cost = sse + dp["lam"] * (coeff_bits + mode_bits)
    best = torch.argmin(cost, 1)
    slots = torch.arange(b, device=best.device)
    recon[blk] = rec[slots, best].reshape(b, n * n).to(torch.int32)
    cell = dp["cell"][t]
    st["modes"][cell] = best.to(torch.int32)
    st["qcoeffs"][cell] = q[slots, best].reshape(b, n * n).to(torch.int32)


def run(plan, dp, frames_u8, precision="float64"):
    """(recons (NF, H, W) uint8, modes (NF, nby, nbx) int32, qcoeffs (NF,
    nby, nbx, n, n) int32), numpy."""
    dev = dp["rate"].device
    h, w, n, nf = plan["height"], plan["width"], plan["n"], plan["n_frames"]
    nbx, nby = plan["nbx"], plan["nby"]
    frames = torch.as_tensor(np.ascontiguousarray(frames_u8)).to(
        device=dev, dtype=torch.int32)
    frame = torch.zeros((nf, h + n, w), dtype=torch.int32, device=dev)
    frame[:, :h] = frames
    st = dict(
        frame=frame.view(-1),
        recon=torch.zeros(nf * plan["plane"], dtype=torch.int32, device=dev),
        modes=torch.full((nf * plan["cells"],), -1, dtype=torch.int32,
                         device=dev),
        qcoeffs=torch.zeros((nf * plan["cells"], n * n), dtype=torch.int32,
                            device=dev))
    for t in range(plan["n_steps"]):
        _step(plan, dp, st, t, precision)
    recon = st["recon"].view(nf, h + n, w)[:, :h].to(torch.uint8)
    modes = st["modes"].view(nf, nby + 1, nbx)[:, :nby]
    qcoeffs = st["qcoeffs"].view(nf, nby + 1, nbx, n, n)[:, :nby]
    return recon.cpu().numpy(), modes.cpu().numpy(), qcoeffs.cpu().numpy()


def _stream(modes, qcoeffs, *, width, height, n, qp):
    """The container stream of one frame's decided grid: every block a CTU
    of size n with one PU and one TU, no sign hiding."""
    trees = []
    for by in range(height // n):
        for bx in range(width // n):
            x, y = bx * n, by * n
            q = qcoeffs[by, bx]
            cbf = 1 if q.any() else 0
            pu = container.PuRecord(
                x, y, n, int(modes[by, bx]),
                [container.TuRecord(x, y, n, cbf, q if cbf else None)])
            trees.append(container.CuNode(x, y, n, 0, split=False, pus=[pu]))
    return container.serialize_trees(trees, width=width, height=height,
                                     qp=qp, policy="regular", ctu_size=n,
                                     sign_hiding=False)


def encode_frames(frames, config, device, precision="float64"):
    """The reference encodes of (B, H, W) uint8 frames under a v1
    configuration: [{"recon", "modes", "levels", "stream"}] a frame."""
    frames = np.asarray(frames)
    nf, h, w = frames.shape
    n, qp = config["block_size"], config["qp"]
    device = torch.device(device)
    plan = _build_plan(h, w, n, qp, nf)
    with torch.no_grad():
        recons, modes, levels = run(plan, _device_plan(plan, device),
                                    frames, precision)
    return [{"recon": recons[f], "modes": modes[f], "levels": levels[f],
             "stream": _stream(modes[f], levels[f], width=w, height=h, n=n,
                               qp=qp)} for f in range(nf)]
