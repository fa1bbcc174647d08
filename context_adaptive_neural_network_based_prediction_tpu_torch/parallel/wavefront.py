"""Wavefront v1 encoder: the uniform n x n block grid (one frame or a batch
of frames per call), with the framework container stream or a standard
Annex-B HEVC stream at CTB 16 as output.

The port of the JAX package's `parallel/wavefront.py` (`_jitted_wavefront`
:38-305, `encode_frames_wavefront_batch` :316, `encode_frame_wavefront`
:334, `encode_frame_wavefront_hm` :389).  Every n x n block is its own CU
with one 2Nx2N PU and one TU.  Blocks run along the anti-diagonals
t = bx + 2*by, so each block's left, above, above-left and above-right
neighbours are coded one step earlier, as in raster order.  One step
codes every slot of the diagonal in all 35 modes:

    gather references (clamped at the frame's edges) -> HM fill and [1 2 1]
    filter -> 35-mode prediction (`ops/intra.predict_all_modes`, with
    the n <= 16 edge filters) -> forward transform, plain scalar
    quantisation (no RDOQ, no sign hiding), dequantisation, inverse
    transform -> cost = SSE + lambda * (rate proxy + mode bits) -> first
    minimum -> commit reconstruction, mode and levels.

The rate proxy is 2*log2(1+|q|)+1 bits per nonzero level, plus 4; the MPMs
take the above neighbour as DC (it lies in another CTU row, CTU = n).
These are the JAX package's semantics, not the wavefront2 trial's, and
the JAX package leaves the step to XLA: no TPU kernel lies on this path.
On the CPU a step is the plain PyTorch `_step`; on a CUDA device it is
one launch of the port's own kernel (`ops/v1_step.py`,
`ops/csrc/v1_step.cu`), equal to `_step` bit for bit, which launches only
the step's blocks inside the frames.

Exactness of the plain step on any device: the four integer transforms
are float64 products, exact since every sum of products stays far below
2^53, turned back into integers before the adds and arithmetic shifts.
The rate proxy's log2 terms come from one float32 table built with numpy
(`rate_table`), not from `torch.log2`, and each mode's terms are summed
in float64, exact in any order (every term is >= 3 with at most 22
fractional bits, the sum below 2^15), then rounded once to float32
before the 4.0 is added.  The cost's float32 adds and product are
separate roundings in the JAX package's order.  The kernel keeps every
one of these roundings (its integer stages are exact in int32).  So the
CPU and the card give the same decisions; where the JAX package's XLA
log2 and fused reduction round differently, its costs move by float32
roundings only.

A batch of NF frames puts its frames on the slot axis, b_eff = b_max * NF
slots ordered (slot, frame), as port `wavefront2` does; each frame's
result equals its own encode.  Slots off the frame read clamped positions
and write into a pad row below the frame, the JAX package's branchless
commit (:263-274), which no valid read touches.

Halo mode (JAX `halo_axis` / `n_tiles`, :39-58, :241-290; the tiled
encoder `parallel/tiled.encode_frame_tiled_halo`): rank d of a process
group encodes stripe d of a frame on the global schedule, its step t_loc
= t - 2 * nby * d of the global step t.  Its buffers carry one halo row
above the stripe (`top` = 1), which holds the bottom pixel row of stripe
d - 1: after every global step each rank sends its bottom row to rank
d + 1 (`mesh.shift_down`), so the stripe's first block row sees the row
above as the single-frame encode does, and the blocks of stripe d > 0
have an above neighbour at by = 0.  A rank skips the steps where its
stripe has no block (t_loc outside its schedule) but takes part in every
exchange.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..codec import deblock, hm_encoder, native, rdo, syntax
from ..codec import encoder as enc_mod
from ..codec import sao as sao_mod
from ..ops import intra, transform, v1_step
from ..ops.reference_samples import DC_FILL, FILTER_THRESHOLD
from ..ops.transform import _product
from ..utils import profiling
from ..utils.profiling import count, setup_span, span
from . import mesh

BLOCK_SIZES = (4, 8, 16, 32)
RATE_TABLE_SIZE = 1 << 15        # |q| < 2^15 at every QP and size
HM_BLOCK = 16                    # the Annex-B output's CTB (JAX :408)


@functools.lru_cache(maxsize=None)
def rate_table() -> np.ndarray:
    """float32 2*log2(1+k)+1 for k in 0..32767, 0 at k = 0 (the JAX
    package's per-level rate proxy, :213-216).  Computed in float64 and
    rounded once to float32, so every machine builds the same table."""
    k = np.arange(RATE_TABLE_SIZE, dtype=np.float64)
    table = (2.0 * np.log2(1.0 + k) + 1.0).astype(np.float32)
    table[0] = 0.0
    return table


@functools.lru_cache(maxsize=None)
def mode_bits_table() -> np.ndarray:
    """(35, 35) float32: the mode bits of every mode (columns) given the
    left neighbour's mode (rows); the above neighbour is DC (`_mpm_device`
    :227): 2 for the first MPM, 3 for the others, 6 otherwise."""
    out = np.full((35, 35), 6.0, np.float32)
    for left in range(35):
        mpms = syntax.mpm_candidates(left, syntax.DC_IDX)
        out[left, mpms] = 3.0
        out[left, mpms[0]] = 2.0
    return out


def _build_plan(height: int, width: int, n: int, qp: int, n_frames: int,
                top: int = 0, has_halo: bool = False):
    """The host tables of an encode: the step schedule and, per (step,
    slot), the flat indices of every read and write (JAX package :55-81,
    :249-257).  `top` = 1 puts a halo row above the frame in the buffers
    (halo mode), `has_halo` makes it the above neighbour of the first
    block row (a stripe below another)."""
    if n not in BLOCK_SIZES:
        raise ValueError(f"block_size must be one of {BLOCK_SIZES}, got {n}")
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
    # Slots off the frame compute on the clamped block (JAX :256-257).
    b_y = np.minimum(by, nby - 1)
    b_x = np.clip(bx, 0, nbx - 1)
    rep = lambda a: np.repeat(a, nf, axis=1)           # (T, b_max * NF)
    b_y, b_x, valid = rep(b_y), rep(b_x), rep(valid)
    f = np.tile(np.arange(nf), b_max)[None, :]
    plane = (top + height + n) * width                # one frame's buffer
    y, x = b_y * n, b_x * n
    # References: the row above at columns x-1 .. x+2n-1 and the column
    # left at rows y .. y+2n-1, clamped to the frame and its halo row
    # (JAX :89-92; buffer rows are offset by `top`).
    cols = np.clip(x[..., None] - 1 + np.arange(2 * n + 1), 0, width - 1)
    top_row = np.clip(y - 1 + top, 0, height - 1 + top)[..., None]
    rows = np.clip(y[..., None] + np.arange(2 * n) + top, 0,
                   height - 1 + top)
    left_col = np.clip(x - 1, 0, width - 1)[..., None]
    ref_idx = np.concatenate([top_row * width + cols,
                              rows * width + left_col], -1) \
        + (f * plane)[..., None]
    # The block's origin in the frame and recon buffers; off the frame,
    # the pad rows below it (JAX :267-268).
    blk = np.where(valid, (y + top) * width + x,
                   (height + top) * width) + f * plane
    cells = (nby + 1) * nbx
    cell = np.where(valid, b_y * nbx + b_x, nby * nbx) + f * cells
    left_cell = b_y * nbx + np.maximum(b_x - 1, 0) + f * cells
    lam = rdo.lambda_for_qp(qp)
    log2n = n.bit_length() - 1
    per, rem = qp // 6, qp % 6
    tshift = 15 - 8 - log2n
    qbits = 14 + per + tshift
    use_filtered = np.array(
        [m != 1 and min(abs(m - 10), abs(m - 26)) > FILTER_THRESHOLD[n]
         for m in range(35)])
    has_above = (b_y > 0) | bool(has_halo)
    return dict(
        height=height, width=width, n=n, qp=qp, n_frames=nf, nbx=nbx,
        nby=nby, n_steps=n_steps, b_max=b_max, b_eff=b_max * nf, top=top,
        plane=plane, cells=cells,
        ref_idx=ref_idx.astype(np.int64), blk=blk.astype(np.int64),
        cell=cell.astype(np.int64), left_cell=left_cell.astype(np.int64),
        has_halo=bool(has_halo), has_above=has_above, has_left=b_x > 0,
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


_PLAN_CACHE: dict = {}
_PLAN_CACHE_MAX = 4


def _get_plan(height, width, n, qp, n_frames, device, top=0,
              has_halo=False):
    """The cached (plan, device plan) of an encode configuration."""
    with span("v1.plan"):
        key = (height, width, n, qp, n_frames, str(torch.device(device)),
               top, has_halo)
        hit = _PLAN_CACHE.get(key)
        if hit is not None:
            return hit
        with setup_span("v1.plan_build"):
            plan = _build_plan(height, width, n, qp, n_frames, top,
                               has_halo)
            hit = (plan, _device_plan(plan, device))
        _PLAN_CACHE[key] = hit
        while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
            _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
        return hit


def _refs(plan, dp, raw, t):
    """HM references of every slot (JAX `build_refs` :83-129): (ref_top,
    ref_left), each (b_eff, 2n+1) int32, from the raw clamped gathers."""
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
    """[1 2 1] filter with unfiltered endpoints (JAX `filter_refs`
    :131-141); no strong smoothing at n = 32."""
    corner, top, left = ref_top[:, :1], ref_top[:, 1:], ref_left[:, 1:]
    ext_t = torch.cat([left[:, :1], ref_top], 1)
    f_top_vals = (ext_t[:, :-2] + 2 * ext_t[:, 1:-1] + ext_t[:, 2:] + 2) >> 2
    f_top = torch.cat([f_top_vals[:, :2 * n], top[:, 2 * n - 1:]], 1)
    ext_l = torch.cat([top[:, :1], corner, left], 1)
    f_left_vals = (ext_l[:, :-2] + 2 * ext_l[:, 1:-1] + ext_l[:, 2:] + 2) >> 2
    f_left = torch.cat([f_top[:, :1], f_left_vals[:, 1:2 * n],
                        left[:, 2 * n - 1:]], 1)
    return f_top, f_left


def _step(plan, dp, st, t):
    """One wavefront step: every slot's block tried in all 35 modes, the
    cheapest committed (JAX `step` / `encode_block` :187-277)."""
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
    a = (_product(orig - preds, tm.T) + (1 << (plan["shift1"] - 1))) \
        >> plan["shift1"]
    coeff = (_product(tm, a) + (1 << (plan["shift2"] - 1))) >> plan["shift2"]
    mag = (coeff.abs() * plan["qscale"] + plan["qadd"]) >> plan["qbits"]
    q = torch.sign(coeff) * mag
    resi = transform.inverse_transform(transform.dequantize(q, plan["qp"]))
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


def _state(plan, frames_u8, dev):
    """The encode's buffers on `dev`: the frames as int32 in planes of
    `top` + H + n rows (`frame`), and the reconstruction (`recon`), modes
    (-1) and levels (`qcoeffs`) the steps fill in."""
    h, w, n, nf = plan["height"], plan["width"], plan["n"], plan["n_frames"]
    top = plan["top"]
    frames = torch.as_tensor(np.ascontiguousarray(frames_u8)).to(
        device=dev, dtype=torch.int32)
    if tuple(frames.shape) != (nf, h, w):
        raise ValueError(f"frames {tuple(frames.shape)} != plan "
                         f"{(nf, h, w)}")
    frame = torch.zeros((nf, top + h + n, w), dtype=torch.int32, device=dev)
    frame[:, top:top + h] = frames
    return dict(
        frame=frame.view(-1),
        recon=torch.zeros(nf * plan["plane"], dtype=torch.int32,
                          device=dev),
        modes=torch.full((nf * plan["cells"],), -1, dtype=torch.int32,
                         device=dev),
        qcoeffs=torch.zeros((nf * plan["cells"], n * n), dtype=torch.int32,
                            device=dev))


def _stepper(plan, dp, st):
    """`step(t)` of `run`: the plain `_step` for state on the CPU, else
    the kernel (`ops/v1_step.stepper`, which takes CUDA tensors only and
    raises on any other device)."""
    if st["recon"].device.type == "cpu":
        return functools.partial(_step, plan, dp, st)
    return v1_step.stepper(plan, dp, st)


def run(plan, dp, frames_u8, group=None):
    """The device half of the encode: (recons (NF, H, W) uint8, modes (NF,
    nby, nbx) int32, qcoeffs (NF, nby, nbx, n, n) int32), numpy (JAX
    `run` :290-303).  With a process `group` (halo mode, a plan with
    `top` = 1), this rank's stripe of the global schedule, its bottom row
    sent down after every global step.

    Spans: `v1.upload` (the frames to the device as int32 and the state
    tensors), `v1.steps` (the host issuing the step loop: on a CUDA
    device one kernel launch a step, which the host issues well ahead of
    the card), `v1.drain` (only while tracing: the wait for what is
    still queued, before the readback), `v1.readback` (the three copies
    to the host).  Counter `v1.step_kernel`: the kernel's launches
    (`ops/v1_step`)."""
    dev = dp["rate"].device
    h, w, n, nf = plan["height"], plan["width"], plan["n"], plan["n_frames"]
    top = plan["top"]
    nbx, nby = plan["nbx"], plan["nby"]
    with span("v1.upload"):
        st = _state(plan, frames_u8, dev)
    step = _stepper(plan, dp, st)
    # One loop over the global schedule: without a group it is this
    # plan's own (one stripe, offset 0) and nothing is exchanged.
    d, ranks = (0, [0]) if group is None else mesh.group_position(group)
    offset = 2 * plan["nby"] * d
    rows = st["recon"].view(nf, top + h + n, w)
    with span("v1.steps"):
        for t in range(_halo_steps(plan, len(ranks))):
            if 0 <= t - offset < plan["n_steps"]:
                step(t - offset)
            if group is not None:
                recv = mesh.shift_down(rows[0, top + h - 1], group)
                if recv is not None:
                    rows[0, 0] = recv
    recon = st["recon"].view(nf, top + h + n, w)[:, top:top + h].to(
        torch.uint8)
    modes = st["modes"].view(nf, nby + 1, nbx)[:, :nby]
    qcoeffs = st["qcoeffs"].view(nf, nby + 1, nbx, n, n)[:, :nby]
    if profiling.active():
        # The copies below wait for the steps on the same stream anyway:
        # the wait, taken apart from them, leaves the card's timeline
        # as it is.
        with span("v1.drain"):
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
    with span("v1.readback"):
        out = recon.cpu().numpy(), modes.cpu().numpy(), qcoeffs.cpu().numpy()
    count("v1.readback_bytes", sum(a.nbytes for a in out))
    return out


def _halo_steps(plan, n_tiles):
    """The global schedule's steps over `n_tiles` stripes (JAX :60)."""
    return (plan["nbx"] - 1) + 2 * (plan["nby"] * n_tiles - 1) + 1


def encode_stripe_halo(stripe_uint8: np.ndarray, qp: int, group, *,
                       block_size: int = 16, device="cuda"):
    """This rank's stripe (H_s, W) of a frame split into the group's
    stripes, encoded on the global schedule with the halo exchange (the
    JAX package's `_jitted_wavefront(..., halo_axis, n_tiles)`): (recon
    (H_s, W) uint8, modes (nby_s, nbx), qcoeffs (nby_s, nbx, n, n)),
    numpy.  Every rank of `group` calls it at the same time."""
    stripe = np.asarray(stripe_uint8)
    h, w = stripe.shape
    d, _ = mesh.group_position(group)
    plan, dp = _get_plan(h, w, block_size, qp, 1, device, top=1,
                         has_halo=d > 0)
    recons, modes, qcoeffs = run(plan, dp, stripe[None], group)
    return recons[0], modes[0], qcoeffs[0]


def encode_frames_wavefront_batch(frames_uint8: np.ndarray, qp: int, *,
                                  block_size: int = 16, device="cuda"):
    """Encodes a batch of frames (B, H, W) through one plan (JAX package
    :316): the frames share every step's ops on the slot axis.  Returns
    (recons (B, H, W) uint8, modes (B, nby, nbx), qcoeffs (B, nby, nbx,
    n, n)) as numpy arrays, each frame equal to its own encode; this is
    the device half of `encode_frame_wavefront`.  Span `v1.encode_batch`
    (a batch of its own)."""
    with span("v1.encode_batch", batch=True):
        frames = np.asarray(frames_uint8)
        nf, h, w = frames.shape
        plan, dp = _get_plan(h, w, block_size, qp, nf, device)
        return run(plan, dp, frames)


def _result(frame_uint8, qp, n, recon, modes, qcoeffs, serialize):
    """CU trees, mode map and (with `serialize`) the container stream of
    one frame's decided grid (JAX package :356-386)."""
    h, w = frame_uint8.shape
    trees = []
    mode_map = np.full((h // 4, w // 4), -1, np.int32)
    for by in range(h // n):
        for bx in range(w // n):
            x, y = bx * n, by * n
            q = qcoeffs[by, bx]
            cbf = 1 if q.any() else 0
            pu = enc_mod.PuRecord(x, y, n, int(modes[by, bx]),
                                  [enc_mod.TuRecord(x, y, n, cbf,
                                                    q if cbf else None)])
            trees.append(enc_mod.CuNode(x, y, n, 0, split=False, pus=[pu]))
            mode_map[y // 4:(y + n) // 4, x // 4:(x + n) // 4] = modes[by, bx]
    bitstream = (native.serialize_grid(modes, qcoeffs, width=w, height=h,
                                       n=n, qp=qp) if serialize else b"")
    return enc_mod.EncodeResult(
        bitstream=bitstream, reconstruction=recon.astype(np.uint8),
        num_bits=len(bitstream) * 8, ctu_trees=trees, mode_map=mode_map,
        qp=qp, policy="regular")


def encode_frame_wavefront(frame_uint8: np.ndarray, qp: int, *,
                           block_size: int = 16, serialize: bool = True,
                           device="cuda"):
    """Whole-frame wavefront encode on a uniform block grid -> EncodeResult
    (JAX package :334).  The stream's header declares CTB = block_size;
    the port's decoder reconstructs it bit-exactly (at block size 32 with
    `strong_intra_smoothing=False`: this encoder filters 32x32 references
    with [1 2 1] only).  CABAC packing is the native packer's
    (`native/cabac_pack.cpp` `pack_grid`); a build or call failure
    raises.  Runs on `device` ("cuda" by default)."""
    frame = np.asarray(frame_uint8)
    recons, modes, qcoeffs = encode_frames_wavefront_batch(
        frame[None], qp, block_size=block_size, device=device)
    return _result(frame, qp, block_size, recons[0], modes[0], qcoeffs[0],
                   serialize)


def encode_frame_wavefront_hm(frame_uint8: np.ndarray, qp: int, *,
                              loop_filters: bool = True, device="cuda"):
    """Wavefront encode -> standard Annex-B HEVC stream at CTB 16 (JAX
    package :389): each 16x16 block one CTU with a 2Nx2N PU and one TU, no
    sign hiding.  With `loop_filters`, deblocking (native, on the host)
    and SAO (estimated per CTB against the source) run on the decided
    reconstruction as normative post-passes, and a decoded-picture-hash
    SEI of the final picture is embedded.  Returns (annexb_stream,
    EncodeResult) with the final reconstruction."""
    frame = np.asarray(frame_uint8)
    res = encode_frame_wavefront(frame, qp, block_size=HM_BLOCK,
                                 serialize=False, device=device)
    sao_grid = None
    if loop_filters:
        # The block grid is its own TU map (every block one CU and TU).
        h, w = frame.shape
        uh, uw = h // 4, w // 4
        tu_ids = (np.arange(uh)[:, None] // 4 * (uw // 4)
                  + np.arange(uw)[None, :] // 4)
        final = deblock.deblock_luma(res.reconstruction, tu_ids, qp)
        sao_grid = sao_mod.estimate_frame(frame, final, HM_BLOCK,
                                          rdo.lambda_for_qp(qp))
        res.reconstruction = sao_mod.apply_sao(final, sao_grid, HM_BLOCK)
    stream = hm_encoder.assemble_hm_stream(
        res, sao_enabled=loop_filters, deblocking=loop_filters,
        sign_hiding=False, transform_skip=False, max_tu_depth=0,
        sao_grid=sao_grid, ctu_size=HM_BLOCK)
    res.bitstream = stream
    res.num_bits = len(stream) * 8
    return stream, res
