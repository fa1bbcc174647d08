"""Fused per-size unit trial of the wavefront encoder: tables, the plain
PyTorch version, and the wrapper of the hand-written CUDA kernel.

One call tries every intra mode of a batch of n x n units (one unit per
wavefront slot): [1 2 1] reference filtering (bilinear at 32x32) -> the 35
predictions -> exact forward DST/DCT -> RDOQ-lite (round / round-1 / 0 per
coefficient, TU rate, cbf=0 option, sign-data hiding per 4x4 group) ->
dequantisation, inverse transform, reconstruction -> SSE + lambda * bits
-> the first minimum over ascending mode ids.  It returns the cost, the
mode, the reconstruction, the levels and 8 CABAC bin counts of the chosen
mode (the counts keep the JAX package's cbf=0 sig-bin bias).

* `build_consts` (numpy) packs the JAX package's tables unchanged (its
  `ops/unit_fused.py:56-321`), plus the raster-order tables the CUDA
  kernel reads (`k_*` keys).
* `consts_from_numpy` turns such a dict into the port's tensors.
* `_trial_blocks`, `_argmin_blocks`, `fused_trial_math` and the plain path
  of `trial_apply` are the plain PyTorch version: a transcription of the
  JAX package's formulation on (n^2, modes * slots) arrays, predictions and
  transforms as float32 matrix products of small integers (every product
  and partial sum is an integer below 2^24, so the products are exact; on
  the card TF32 is off).
* `trial_apply` is the wrapper: CPU tensors go to the plain version, CUDA
  tensors to the kernel of `csrc/unit_trial.cu`.  `impl="plain"` asks for
  the plain version on the card (for comparing the two).

Under the NN policies a PNN prediction `nn_pred` (b, n, n) takes the place
of mode 18's prediction (`nn_policy="sub18"`, substitution) or fills the
36th mode block (`"append"`, switch: PNNS, mode 35), as in the JAX
package (`ops/unit_fused.py:426-430`); without one it is the zero block.
"""

from __future__ import annotations

import numpy as np
import torch

M_PAD = 36          # mode blocks in the lane layout (35 + PNNS/dummy)
BIG_COST = 3e38
NN_MODE = {None: -1, "sub18": 18, "append": 35}   # mode block of nn_pred


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _pprime(n):
    """CG-grouped raster order: p' -> raster index (y*n+x)."""
    if n <= 4:
        return np.arange(n * n, dtype=np.int64)
    out = []
    for cgy in range(n // 4):
        for cgx in range(n // 4):
            for yy in range(4):
                for xx in range(4):
                    out.append((cgy * 4 + yy) * n + cgx * 4 + xx)
    return np.asarray(out, dtype=np.int64)


def _filter_matrix(n):
    """F (R, R) int64: filtered = (F @ comb + 2) >> 2, identity rows x4.

    Transcribes wavefront2.filter_refs (the HM [1 2 1] reference smoothing,
    `TComPattern::filterIntraReferences`) as a single linear map.
    """
    R = 4 * n + 2
    F = np.zeros((R, R), np.int64)
    TOP, LEFT = 0, 2 * n + 1

    def ext_t(k):        # ext_t = [ref_left[1], ref_top[0..2n]]
        return LEFT + 1 if k == 0 else TOP + (k - 1)

    def ext_l(k):        # ext_l = [ref_top[1], corner, ref_left[1..2n]]
        if k == 0:
            return TOP + 1
        if k == 1:
            return TOP + 0
        return LEFT + (k - 1)

    # f_top[j] = f_top_vals[j] for j < 2n, raw top[2n] at j == 2n.
    for j in range(2 * n):
        for w, k in ((1, j), (2, j + 1), (1, j + 2)):
            F[TOP + j, ext_t(k)] += w
    F[TOP + 2 * n, TOP + 2 * n] = 4
    # f_left[0] = f_top[0]; f_left[j] = f_left_vals[j] (1 <= j < 2n);
    # f_left[2n] raw.
    F[LEFT + 0] = F[TOP + 0]
    for j in range(1, 2 * n):
        for w, k in ((1, j), (2, j + 1), (1, j + 2)):
            F[LEFT + j, ext_l(k)] += w
    F[LEFT + 2 * n, LEFT + 2 * n] = 4
    return F


def _pred_matrix(n, use_filt, g0, g1, frac):
    """P (35, n*n, 2R+1) int64 mapping [raw | filtered | 1] -> 64*pred.

    pred[m, p] = (P[m, p] . comb2) >> 6, exactly predict35's planar/angular
    arithmetic (DC and the mode-10/26 edge adjustments are runtime fixups).
    """
    R = 4 * n + 2
    C = 2 * R           # constant column
    P = np.zeros((35, n * n, 2 * R + 1), np.int64)
    TOP, LEFT = 0, 2 * n + 1
    s = n.bit_length() - 1

    def col(idx, m):
        return idx + (R if use_filt[m] else 0)

    # Planar (mode 0): ((L<<s) + n + (x+1)(TR-L) + (T<<s) + (y+1)(BL-T))
    #                  >> (s+1), scaled by 2^(5-s) to the uniform >> 6.
    sc = 1 << (5 - s)
    for y in range(n):
        for x in range(n):
            p = y * n + x
            row = P[0, p]
            row[col(LEFT + 1 + y, 0)] += sc * ((1 << s) - (x + 1))
            row[col(TOP + n + 1, 0)] += sc * (x + 1)          # TR
            row[col(TOP + 1 + x, 0)] += sc * ((1 << s) - (y + 1))
            row[col(LEFT + n + 1, 0)] += sc * (y + 1)         # BL
            row[C] += sc * n
    # Angular modes 2..34 -> pred index m = mode: x2 to >> 6.
    for mi in range(33):
        m = mi + 2
        for y in range(n):
            for x in range(n):
                p = y * n + x
                f = int(frac[mi, y, x])
                P[m, p, col(int(g0[mi, y, x]), m)] += 2 * (32 - f)
                P[m, p, col(int(g1[mi, y, x]), m)] += 2 * f
                P[m, p, C] += 2 * 16
    return P


def _kron_mats(n, t_fwd, t_inv, pp):
    """Transform stage matrices (n^2, n^2) in p' order.

    fwd1[(i,k),(i,x)] = Tf[k,x]   (a = resi @ Tf^T)
    fwd2[(k,l),(i,l)] = Tf[k,i]   (coeff = Tf @ a, via hi/lo split)
    inv1[(i,l),(k,l)] = Ti[k,i]   (e = Ti^T @ coeff)
    inv2[(i,x),(i,k)] = Ti[k,x]   (r = e @ Ti)
    """
    nn = n * n
    f1 = np.zeros((nn, nn), np.int64)
    f2 = np.zeros((nn, nn), np.int64)
    i1 = np.zeros((nn, nn), np.int64)
    i2 = np.zeros((nn, nn), np.int64)
    for a in range(n):
        for b in range(n):
            for c in range(n):
                f1[a * n + b, a * n + c] = t_fwd[b, c]
                f2[b * n + a, c * n + a] = t_fwd[b, c]
                i1[b * n + a, c * n + a] = t_inv[c, b]
                i2[a * n + b, a * n + c] = t_inv[c, b]
    inv = np.empty_like(pp)
    inv[pp] = np.arange(len(pp))
    conj = lambda m: m[pp][:, pp]
    return conj(f1), conj(f2), conj(i1), conj(i2)


def build_consts(n, n_modes, c, SB, lam, qscale, iq_scale, b_eff,
                 nn_policy=None, groups=1):
    """Pack the fused-trial constants for size n.

    `c` is the wavefront2 per-size consts dict (g0/g1/frac/use_filt/
    t_fwd/t_inv/shift1/shift2/qbits/iq_shift/err_scale/sig0/sig1/
    lastx/lasty/sg/inv_sg), `SB` the scalar-bits dict.  `nn_policy` in
    {None, "sub18", "append"} controls where a PNN prediction is inserted.

    `groups` > 1 enables the mode-group GRID decomposition for the big
    sizes (16/32): the pallas kernel iterates over groups of
    36/groups mode blocks with a running argmin in scratch, bounding the
    VMEM footprint of the (n^2, modes*B) intermediates.  Requires a
    mode-independent scan (true for n > 8: HEVC uses the diagonal scan
    only, TComTrQuant::getCoefScanIdx), so the rate tables collapse to
    one (n^2, B) block shared by every group.
    """
    nn_px = n * n
    B = _round_up(max(b_eff, 1), 128)
    L = M_PAD * B
    R = 4 * n + 2
    Rp = _round_up(R, 8)
    RRp = _round_up(2 * Rp + 1, 8)
    pp = _pprime(n)
    ipp = np.empty_like(pp)
    ipp[pp] = np.arange(len(pp))

    g0 = np.asarray(c["g0"]); g1 = np.asarray(c["g1"])
    frac = np.asarray(c["frac"]); use_filt = np.asarray(c["use_filt"])
    P = _pred_matrix(n, use_filt, g0, g1, frac)      # (35, nn, 2R+1)
    # -> (M_PAD*nn, RRp) rows m*nn + p' (p' order), cols [raw Rp | filt Rp
    # at offset Rp | const at 2*Rp].
    P2 = np.zeros((M_PAD * nn_px, RRp), np.float32)
    for m in range(35):
        blk = P[m][pp]                               # (nn, 2R+1)
        P2[m * nn_px:(m + 1) * nn_px, :R] = blk[:, :R]
        P2[m * nn_px:(m + 1) * nn_px, Rp:Rp + R] = blk[:, R:2 * R]
        P2[m * nn_px:(m + 1) * nn_px, 2 * Rp] = blk[:, 2 * R]

    F = np.zeros((Rp, Rp), np.float32)
    F[:R, :R] = _filter_matrix(n)
    # Strong (bilinear) intra smoothing, normative at 32x32
    # (TComPattern.cpp:415-470): linear ramps corner<->TR / corner<->BL,
    # selected per slot by the near-linearity test computed in-kernel.
    Fs = np.zeros((8, 8), np.float32)
    if n == 32:
        Fs = np.zeros((Rp, Rp), np.float32)
        TOPs, LEFTs = 0, 2 * n + 1
        Fs[TOPs + 0, TOPs + 0] = 64
        Fs[TOPs + 2 * n, TOPs + 2 * n] = 64
        Fs[LEFTs + 0, TOPs + 0] = 64
        Fs[LEFTs + 2 * n, LEFTs + 2 * n] = 64
        for i in range(1, 2 * n):
            Fs[TOPs + i, TOPs + 0] = 2 * n - i
            Fs[TOPs + i, TOPs + 2 * n] = i
            Fs[LEFTs + i, TOPs + 0] = 2 * n - i
            Fs[LEFTs + i, LEFTs + 2 * n] = i

    # DC / edge-fixup selection rows (operate on comb2).
    TOP, LEFT = 0, 2 * n + 1
    dcw = np.zeros((8, RRp), np.float32)
    dcw[0, TOP + 1:TOP + 1 + n] = 1.0
    dcw[0, LEFT + 1:LEFT + 1 + n] = 1.0
    dcw[0, 2 * Rp] = float(n)
    selT = np.zeros((nn_px, RRp), np.float32)        # top_w[x(p')]
    selL = np.zeros((nn_px, RRp), np.float32)        # left_w[y(p')]
    adj26 = np.zeros((nn_px, RRp), np.float32)       # (left_w[y]-corner)
    adj10 = np.zeros((nn_px, RRp), np.float32)       # (top_w[x]-ref_top[0])
    y0 = np.zeros((nn_px, 1), np.float32)
    x0 = np.zeros((nn_px, 1), np.float32)
    for i, p in enumerate(pp):
        y, x = divmod(int(p), n)
        selT[i, TOP + 1 + x] = 1.0
        selL[i, LEFT + 1 + y] = 1.0
        adj26[i, LEFT + 1 + y] = 1.0
        adj26[i, LEFT + 0] = -1.0
        adj10[i, TOP + 1 + x] = 1.0
        adj10[i, TOP + 0] = -1.0
        y0[i] = 1.0 if y == 0 else 0.0
        x0[i] = 1.0 if x == 0 else 0.0

    f1, f2, i1, i2 = _kron_mats(n, np.asarray(c["t_fwd"]),
                                np.asarray(c["t_inv"]), pp)
    # The HEVC forward matrices are 2^14-scaled (FWD_MATRIX_SHIFT=14,
    # entries to +-23170): too wide for exact f32/bf16 matmuls.  Split
    # T = 256*Th + Tl (Th in [-91, 91], Tl in [0, 255], both bf16-exact);
    # the kernel recombines the two exact products in int32.  The inverse
    # matrices are 8-bit (<= 90) and stay whole.
    f1h, f1l = f1 >> 8, f1 & 255
    f2h, f2l = f2 >> 8, f2 & 255

    # Rate tables in p'-raster domain, expanded to the (nn, M*B) lane
    # layout (value constant across the slot block).
    n_modes_t = np.asarray(c["sig0"]).shape[0]       # 35 or 36
    inv_sg = np.asarray(c["inv_sg"])                 # (n_modes_t, nn) r->scan
    sig0s = np.asarray(c["sig0"], np.float32)        # scan-domain
    sig1s = np.asarray(c["sig1"], np.float32)
    scanpos = np.zeros((nn_px, M_PAD), np.int32)
    sig0r = np.zeros((nn_px, M_PAD), np.float32)
    sig1r = np.zeros((nn_px, M_PAD), np.float32)
    for m in range(M_PAD):
        mt = min(m, n_modes_t - 1)
        sp = inv_sg[mt][pp]                          # scanpos of p'
        scanpos[:, m] = sp
        sig0r[:, m] = sig0s[mt][sp]
        sig1r[:, m] = sig1s[mt][sp]
    lastx = np.asarray(c["lastx"], np.float32)
    lasty = np.asarray(c["lasty"], np.float32)
    MB = 256.0
    lastpb = np.zeros((nn_px, 1), np.int32)
    for i, p in enumerate(pp):
        y, x = divmod(int(p), n)
        lastpb[i, 0] = (int(np.round(lastx[x] * MB))
                        + int(np.round(lasty[y] * MB)))

    mg = M_PAD // groups
    assert mg * groups == M_PAD, "groups must divide 36"
    if groups > 1:
        assert np.all(scanpos == scanpos[:, :1]), \
            "mode-group grid needs a mode-independent scan (n > 8)"

    def expand(t):
        if groups > 1:
            return np.repeat(t[:, :1], B, axis=1)
        return np.repeat(t, B, axis=1)

    mode_valid = np.zeros((1, M_PAD), np.float32)
    mode_valid[0, n_modes:] = BIG_COST

    return dict(
        n=n, nn=nn_px, B=B, L=L, Rp=Rp, RRp=RRp, R=R, ipp=ipp,
        n_modes=n_modes, nn_policy=nn_policy, pp=pp,
        P2=P2, F=F, Fs=Fs, strong=(n == 32), dcw=dcw, selT=selT,
        selL=selL,
        adj26=adj26, adj10=adj10,
        y0=np.repeat(y0, B, axis=1), x0=np.repeat(x0, B, axis=1),
        f1h=f1h.astype(np.float32), f1l=f1l.astype(np.float32),
        f2h=f2h.astype(np.float32), f2l=f2l.astype(np.float32),
        i1=i1.astype(np.float32), i2=i2.astype(np.float32),
        sig0e=expand(sig0r), sig1e=expand(sig1r),
        scanpos_e=expand(scanpos),
        lastpb_e=np.repeat(lastpb, B if groups > 1 else L,
                           axis=1).astype(np.int32),
        mode_big=np.repeat(mode_valid, B, axis=1),
        groups=groups, mg=mg, tab_compact=groups > 1,
        shift1=int(c["shift1"]), shift2=int(c["shift2"]),
        qbits=int(c["qbits"]), iq_shift=int(c["iq_shift"]),
        err_scale=float(c["err_scale"]),
        qscale=float(qscale), iq_scale=int(iq_scale), lam=float(lam),
        SB={k: float(v) for k, v in SB.items()},
        dc_shift=n.bit_length(),      # >> (log2n + 1)
        **_kernel_tables(n, n_modes, c, groups > 1, lastpb, ipp, SB, lam,
                         qscale, iq_scale, nn_policy),
    )


def _kernel_tables(n, n_modes, c, compact, lastpb, ipp, SB, lam, qscale,
                   iq_scale, nn_policy):
    """Raster-order tables and scalars of the CUDA kernel (`k_*` keys).

    The kernel predicts from the angular gather tables and transforms with
    the (n, n) matrices directly, so it needs none of the (n^2, n^2)
    Kronecker or prediction matrices.  Rate tables are (rows, n^2) in
    raster order, one row per mode, or one shared row when the scan is
    mode-independent (n > 8)."""
    nn = n * n
    n_modes_t = np.asarray(c["sig0"]).shape[0]
    rows = [0] if compact else [min(m, n_modes_t - 1) for m in range(M_PAD)]
    inv_sg = np.asarray(c["inv_sg"])
    scan = np.stack([inv_sg[mt] for mt in rows]).astype(np.int32)
    sig0 = np.stack([np.asarray(c["sig0"], np.float32)[mt][inv_sg[mt]]
                     for mt in rows])
    sig1 = np.stack([np.asarray(c["sig1"], np.float32)[mt][inv_sg[mt]]
                     for mt in rows])
    mb = np.float32(256.0)
    sbi = {k: int(round(SB[k] * 256.0)) for k in
           ("g1_0", "g1_1", "g2_0", "g2_1", "csb0", "csb1", "cbf1")}
    f32 = lambda v: float(np.float32(v))
    return dict(
        k_g0=np.asarray(c["g0"], np.int32).reshape(33, nn),
        k_g1=np.asarray(c["g1"], np.int32).reshape(33, nn),
        k_frac=np.asarray(c["frac"], np.int32).reshape(33, nn),
        k_use_filt=np.asarray(c["use_filt"], np.int32),
        k_tf=np.asarray(c["t_fwd"], np.int32),
        k_ti=np.asarray(c["t_inv"], np.int32),
        k_scan=scan, k_sig0=sig0, k_sig1=sig1,
        k_sig0i=np.round(sig0 * mb).astype(np.int32),
        k_sig1i=np.round(sig1 * mb).astype(np.int32),
        k_lastpb=lastpb[ipp, 0].astype(np.int32),
        # Order matches the kernel's IP_* / FP_* indices.
        k_iparams=np.array(
            [n_modes, len(rows), int(c["shift1"]), int(c["shift2"]),
             int(c["qbits"]), int(c["iq_shift"]), int(iq_scale),
             sbi["g1_0"], sbi["g1_1"], sbi["g2_0"], sbi["g2_1"],
             sbi["csb0"], sbi["csb1"], sbi["cbf1"], NN_MODE[nn_policy], 0],
            np.int32),
        k_fparams=np.array(
            [f32(qscale), f32(c["err_scale"]), f32(lam),
             f32(lam * SB["cbf0"]), f32(SB["cbf0"]), 0.0, 0.0, 0.0],
            np.float32),
    )


# --------------------------------------------------------------- tensors --

def consts_from_numpy(cst: dict, device="cuda") -> dict:
    """A `build_consts` (or `size_consts`) dict of numpy tables -> the
    port's dict: every array becomes a tensor on `device`, other values
    stay as they are.

    For a `build_consts` dict it adds the per-mode columns the plain trial
    reads (`*_m` keys), taken from the lane-expanded tables (every slot
    column of a mode block holds the same value), so the plain trial runs
    from the JAX package's own tables as well as from the port's."""
    out = {}
    for k, v in cst.items():
        if isinstance(v, np.ndarray) and v.dtype != object:
            a = np.ascontiguousarray(v)
            if a.dtype == np.bool_:
                a = a.astype(np.int32)
            out[k] = torch.from_numpy(a.copy()).to(device)
        else:
            out[k] = v
    if "P2" in cst:
        B = cst["B"]
        # Lane-expanded table -> per-mode columns (nn, M) (or (nn, 1) where
        # every mode shares it); every slot column of a mode block is equal.
        for key, name, per_mode in (
                ("sig0e", "sig0_m", True), ("sig1e", "sig1_m", True),
                ("scanpos_e", "scanpos_m", True),
                ("mode_big", "mode_big_m", True),
                ("lastpb_e", "lastpb_m", False), ("y0", "y0_m", False),
                ("x0", "x0_m", False)):
            t = np.asarray(cst[key])
            cols = t[:, ::B] if per_mode and t.shape[1] == M_PAD * B \
                else t[:, :1]
            out[name] = torch.from_numpy(np.ascontiguousarray(cols)).to(
                device)
    return out


# ---------------------------------------------------------- plain version --

def _floordiv2(x, s):
    """floor(x / 2^s) of integer-valued float32 (== arithmetic >> s)."""
    return torch.floor(x * (2.0 ** (-s)))


def _f32(v):
    """A Python float rounded to float32, as JAX rounds weak constants."""
    return float(np.float32(v))


def _i32_sum(x, dim):
    """int32 sum with int32 wraparound, as the JAX package sums."""
    s = torch.sum(x.to(torch.int64), dim=dim, keepdim=True)
    return (((s + 2 ** 31) % 2 ** 32) - 2 ** 31).to(torch.int32)


def _trial_blocks(tc, comb, orig_p, mode_row, rate_rows, nn_pred_p=None):
    """Core of the plain trial on (n^2, M*B)-layout values (lane m*B + j =
    mode m of slot j), all M_PAD mode blocks at once.

    comb (Rp, B) f32 references, orig_p (n^2, B) i32 in CG-grouped raster
    order, mode_row (1, M*B) f32, rate_rows (8, B) i32 live rate-state
    micro-bit deltas, nn_pred_p (n^2, B) i32 PNN prediction or None (the
    zero block).  Returns (cost (1, M*B) f32, rec, q (n^2, M*B) i32,
    counts (8, M*B) i32).  Transcribes the JAX package's `_trial_blocks`
    (`ops/unit_fused.py:324-669`) operation by operation, float32 rounding
    included."""
    n, nn = tc["n"], tc["nn"]
    B = comb.shape[1]
    M = M_PAD
    L = M * B
    SB = tc["SB"]
    i32, f32 = torch.int32, torch.float32
    LAM = _f32(tc["lam"])
    MBf = 256.0

    def lane(t):    # per-mode columns (rows, M or 1) -> lanes (rows, M*B)
        if t.shape[1] == 1:
            return t.expand(t.shape[0], L).contiguous()
        return t.repeat_interleave(B, dim=1)

    # ---- references: filter + 35-mode prediction as matrix products ----
    combf = _floordiv2(tc["F"] @ comb + 2.0, 2)
    if tc.get("strong"):
        LEFT = 2 * n + 1
        c0 = comb[0:1]
        tr = comb[2 * n:2 * n + 1]
        tn = comb[n:n + 1]
        bl = comb[LEFT + 2 * n:LEFT + 2 * n + 1]
        ln_ = comb[LEFT + n:LEFT + n + 1]
        cond = ((bl + c0 - 2.0 * ln_).abs() < 8.0) \
            & ((c0 + tr - 2.0 * tn).abs() < 8.0)
        combs = _floordiv2(tc["Fs"] @ comb + 32.0, 6)
        combf = torch.where(cond, combs, combf)
    ones = torch.ones((tc["RRp"] - 2 * tc["Rp"], B), dtype=f32,
                      device=comb.device)
    comb2 = torch.cat([comb, combf, ones], dim=0)
    blocks = _floordiv2(tc["P2"] @ comb2, 6).view(M, nn, B)

    # DC plane (mode 1) + mode 10/26 edge adjustments.
    dc = _floordiv2(tc["dcw"] @ comb2, tc["dc_shift"])
    dcb = dc[0:1].expand(nn, B)
    topx = tc["selT"] @ comb2
    lefty = tc["selL"] @ comb2
    y0 = tc["y0_m"] > 0.5
    x0 = tc["x0_m"] > 0.5
    if n <= 16:
        e_top = _floordiv2(topx + 3.0 * dcb + 2.0, 2)
        e_left = _floordiv2(lefty + 3.0 * dcb + 2.0, 2)
        e_cor = _floordiv2(topx + lefty + 2.0 * dcb + 2.0, 2)
        dcplane = torch.where(y0 & x0, e_cor, torch.where(
            y0, e_top, torch.where(x0, e_left, dcb)))
    else:
        dcplane = dcb
    blocks = blocks.clone()
    blocks[1] = dcplane
    if n <= 16:
        a26 = _floordiv2(tc["adj26"] @ comb2, 1)
        blocks[26] = torch.where(x0, (blocks[26] + a26).clamp(0.0, 255.0),
                                 blocks[26])
        a10 = _floordiv2(tc["adj10"] @ comb2, 1)
        blocks[10] = torch.where(y0, (blocks[10] + a10).clamp(0.0, 255.0),
                                 blocks[10])
    if tc["nn_policy"] is not None:
        blocks[NN_MODE[tc["nn_policy"]]] = (
            0.0 if nn_pred_p is None else nn_pred_p.to(f32))
    preds = blocks.permute(1, 0, 2).reshape(nn, L)        # (nn, M*B) f32

    orig_rep = orig_p.repeat(1, M)                        # (nn, M*B) i32
    resi = orig_rep.to(f32) - preds

    # ---- forward transform, exact: split matrices keep every partial
    # product float32-exact; recombination and shifts in int32 ----
    def tdot(kh, kl, x):
        return (256 * (tc[kh] @ x).to(i32) + (tc[kl] @ x).to(i32))

    a_i = (tdot("f1h", "f1l", resi) + (1 << (tc["shift1"] - 1))) \
        >> tc["shift1"]
    hs = tdot("f2h", "f2l", (a_i >> 8).to(f32))
    ls = tdot("f2h", "f2l", (a_i & 255).to(f32))
    coeff = ((hs + ((ls + (1 << (tc["shift2"] - 1))) >> 8))
             >> (tc["shift2"] - 8)).to(f32)

    # ---- RDOQ-lite (raster domain) ----
    qstep = float(2.0 ** tc["qbits"])
    ES = _f32(tc["err_scale"])
    sig0 = lane(tc["sig0_m"])
    sig1 = lane(tc["sig1_m"])
    scanpos = lane(tc["scanpos_m"])
    lastpb = tc["lastpb_m"]
    rr = rate_rows.repeat(1, M)                           # (8, M*B)
    dsig0_i, dsig1_i = rr[0:1], rr[1:2]
    dsig0_f = dsig0_i.to(f32) * (1.0 / MBf)
    dsig1_f = dsig1_i.to(f32) * (1.0 / MBf)
    dg = {"g1_0": rr[2:3], "g1_1": rr[3:4], "g2_0": rr[4:5],
          "g2_1": rr[5:6]}
    dcbf0_i, dcbf1_i = rr[6:7], rr[7:8]
    sign = torch.sign(coeff)
    ldf = coeff.abs() * _f32(tc["qscale"])
    ma = torch.clamp(torch.floor(ldf * (1.0 / qstep) + 0.5), max=32767.0)
    lo_ = torch.clamp(ma - 1.0, min=1.0)

    sbg = {k: int(round(SB[k] * MBf)) + dg[k] for k in dg}
    pow2 = torch.tensor([1 << j for j in range(1, 16)], dtype=i32,
                        device=comb.device)

    def level_mbits_i(lvl_i):
        # Integer floor-log2 Golomb tail: g counts the j in 1..15 with
        # m >= 2^j (the JAX package sums those 15 compares).
        s = lvl_i - 3
        m = torch.clamp(s - 2, min=1)
        g = torch.bucketize(m, pow2, right=True).to(i32)
        golomb = torch.where(s < 3, s + 1, 4 + 2 * g)
        return int(round(MBf)) + torch.where(
            lvl_i == 1, sbg["g1_0"],
            torch.where(lvl_i == 2, sbg["g1_1"] + sbg["g2_0"],
                        sbg["g1_1"] + sbg["g2_1"] + golomb * int(round(MBf))))

    def level_bits(lvl_f):
        return level_mbits_i(lvl_f.to(i32)).to(f32) * (1.0 / MBf)

    def sq(x):
        return x * x

    def coded_cost(lvl):
        err = ldf - lvl * qstep
        return sq(err) * ES + LAM * (sig1 + dsig1_f + level_bits(lvl))

    d0 = sq(ldf) * ES
    cost0 = d0 + LAM * (sig0 + dsig0_f)
    cost_hi = coded_cost(ma)
    cost_lo = coded_cost(lo_)
    pick_lo = cost_lo < cost_hi
    lvl_nz = torch.where(pick_lo, lo_, ma)
    cost_nz = torch.where(pick_lo, cost_lo, cost_hi)
    nz = (ma > 0) & (cost_nz < cost0)
    lvl = torch.where(nz, lvl_nz, 0.0).to(i32)

    sig0_i = torch.round(sig0 * MBf).to(i32) + dsig0_i
    sig1_i = torch.round(sig1 * MBf).to(i32) + dsig1_i
    sbi = lambda k: int(round(SB[k] * MBf))
    nzb = lvl > 0
    last = torch.where(nzb, scanpos, -1).amax(dim=0, keepdim=True)
    cbf = last >= 0
    sig_paid = scanpos < last
    ncg = max(nn // 16, 1)
    if ncg > 1:
        cgnz = nzb.view(ncg, 16, L).any(dim=1)                # (ncg, L)
        cgi = (scanpos >> 4).view(ncg, 16, L)[:, 0]           # (ncg, L)
        lastcg = last >> 4
        paid = (cgi > 0) & (cgi < lastcg)
        csb_mb = _i32_sum(torch.where(
            paid, torch.where(cgnz, sbi("csb1"), sbi("csb0")), 0), 0)
        coded = (cgi == 0) | (cgi == lastcg) | cgnz
        sig_paid = sig_paid & coded.repeat_interleave(16, dim=0)
    else:
        csb_mb = torch.zeros_like(last)
    sig_mb = _i32_sum(torch.where(sig_paid,
                                  torch.where(nzb, sig1_i, sig0_i), 0), 0)
    lvl_mb = _i32_sum(torch.where(nzb, level_mbits_i(lvl), 0), 0)
    rsel = scanpos == torch.clamp(last, min=0)
    lb_mb = _i32_sum(torch.where(rsel, lastpb, 0), 0)
    mb_coded = sbi("cbf1") + dcbf1_i + lb_mb + csb_mb + sig_mb + lvl_mb
    bits_coded = mb_coded.to(f32) * (1.0 / MBf)
    DS = 4.0
    dc_el = torch.where(nzb, sq(ldf - lvl.to(f32) * qstep) * ES, d0)
    d_coded = _i32_sum(torch.round(dc_el * DS).to(i32), 0).to(f32) \
        * (1.0 / DS)
    d_zero = _i32_sum(torch.round(d0 * DS).to(i32), 0).to(f32) * (1.0 / DS)
    cbf0_extra = dcbf0_i.to(f32) * (1.0 / MBf)
    zero_cost = d_zero + (_f32(tc["lam"] * SB["cbf0"]) + LAM * cbf0_extra)
    keep = cbf & (d_coded + LAM * bits_coded < zero_cost)
    lvl = torch.where(keep, lvl, 0)
    tu_bits = torch.where(keep, bits_coded, _f32(SB["cbf0"]) + cbf0_extra)

    # ---- sign-data hiding (per 4x4 CG = 16 consecutive rows) ----
    wpos = (scanpos & 15).view(ncg, 16, L)
    nzr = lvl > 0
    lvl_f = lvl.to(f32)

    def dcost(new_lvl, old_lvl):
        dn_ = sq(ldf - new_lvl * qstep) - sq(ldf - old_lvl * qstep)
        return dn_ * ES + LAM * (level_bits(new_lvl) - level_bits(old_lvl))

    big = 1e30
    up = torch.where(nzr, dcost(lvl_f + 1.0, lvl_f), big)
    dn = torch.where(lvl >= 2, dcost(lvl_f - 1.0, lvl_f), big)
    bag = torch.minimum(up, dn).view(ncg, 16, L)
    nzg = nzr.view(ncg, 16, L)
    firstp = torch.where(nzg, wpos, 16).amin(dim=1, keepdim=True)
    lastp = torch.where(nzg, wpos, -1).amax(dim=1, keepdim=True)
    span_ok = (lastp - firstp) >= 4                       # (ncg, 1, L)
    parity = _i32_sum(lvl.view(ncg, 16, L), 1) & 1
    cf = firstp.clamp(0, 15)
    sfirst = _i32_sum(torch.where(wpos == cf,
                                  sign.to(i32).view(ncg, 16, L), 0), 1)
    want = (sfirst < 0).to(i32)
    mismatch = span_ok & (parity != want)
    minv = bag.amin(dim=1, keepdim=True)
    pick = torch.where(bag == minv, wpos, 16).amin(dim=1, keepdim=True)
    at_pick = wpos == pick.clamp(0, 15)
    up_p = torch.where(at_pick, up.view(ncg, 16, L), 0.0).sum(
        dim=1, keepdim=True)
    dn_p = torch.where(at_pick, dn.view(ncg, 16, L), 0.0).sum(
        dim=1, keepdim=True)
    delta = torch.where(up_p <= dn_p, 1, -1).to(i32)
    adj = torch.where(mismatch & at_pick, delta, 0).to(i32)
    hidden = span_ok.to(i32).sum(dim=0).to(i32)          # (1, L)
    lvl = lvl + adj.view(nn, L)
    tu_bits = tu_bits - hidden.to(f32)

    q = (sign * lvl.to(f32)).to(i32)

    # ---- dequant + inverse transform + reconstruction ----
    iq = tc["iq_shift"]
    if iq > 0:
        deq = (q * tc["iq_scale"] + (1 << (iq - 1))) >> iq
    else:
        deq = (q * tc["iq_scale"]) << (-iq)
    deq = deq.clamp(-32768, 32767)
    e1 = (256 * (tc["i1"] @ (deq >> 8).to(f32)).to(i32)
          + (tc["i1"] @ (deq & 255).to(f32)).to(i32))
    e1 = ((e1 + 64) >> 7).clamp(-32768, 32767)
    r2 = (256 * (tc["i2"] @ (e1 >> 8).to(f32)).to(i32)
          + (tc["i2"] @ (e1 & 255).to(f32)).to(i32))
    r2 = ((r2 + (1 << 11)) >> 12).clamp(-32768, 32767)
    rec = (preds.to(i32) + r2).clamp(0, 255)

    sse = _i32_sum(sq(rec - orig_rep), 0)
    cost = (sse.to(f32) + LAM * (tu_bits + mode_row)
            + lane(tc["mode_big_m"]))

    # CABAC bin counts of this mode's decided TU (row order of rate_rows).
    nzf = lvl > 0
    cnt = torch.cat([
        _i32_sum((sig_paid & ~nzf).to(i32), 0),
        _i32_sum((sig_paid & nzf).to(i32), 0),
        _i32_sum((lvl == 1).to(i32), 0),
        _i32_sum((lvl >= 2).to(i32), 0),
        _i32_sum((lvl == 2).to(i32), 0),
        _i32_sum((lvl >= 3).to(i32), 0),
        nzf.any(dim=0, keepdim=True).to(i32),
        torch.ones_like(dsig0_i),
    ], dim=0)
    return cost, rec, q, cnt


def _argmin_blocks(cost, rec, q, cnt, B):
    """First minimum over the mode blocks (ties -> lowest mode id, the
    JAX package's strict-< ascending scan; costs are never NaN).
    Returns (minv (B,), best (B,) i32, rec, q (nn, B), cnt (8, B))."""
    M = cost.shape[1] // B
    cm = cost.view(M, B)
    best = torch.argmin(cm, dim=0)          # first minimal index
    minv = cm.gather(0, best[None])[0]
    cols = best * B + torch.arange(B, device=cost.device)
    return (minv, best.to(torch.int32), rec[:, cols], q[:, cols],
            cnt[:, cols])


def fused_trial_math(tc, comb, orig_p, mode_row, rate_rows, nn_pred_p=None):
    """Plain trial + argmin on padded (n^2, B) values: returns (cost (B,),
    best (B,), rec (n^2, B), q (n^2, B), counts (8, B))."""
    cost, rec, q, cnt = _trial_blocks(tc, comb, orig_p, mode_row, rate_rows,
                                      nn_pred_p)
    return _argmin_blocks(cost, rec, q, cnt, comb.shape[1])


def _plain_trial(tc, ref_top, ref_left, orig, mode_bits, rate_rows,
                 nn_pred):
    n, nn = tc["n"], tc["nn"]
    b = ref_top.shape[0]
    comb = torch.cat([ref_top, ref_left], dim=1).to(torch.float32)
    comb = torch.nn.functional.pad(comb, (0, tc["Rp"] - tc["R"])).T
    orig_p = orig.reshape(b, nn)[:, tc["pp"]].T.to(torch.int32)
    mb = torch.nn.functional.pad(mode_bits.to(torch.float32),
                                 (0, M_PAD - mode_bits.shape[1]))
    mode_row = mb.T.reshape(1, M_PAD * b)
    nn_p = None if nn_pred is None else \
        nn_pred.reshape(b, nn)[:, tc["pp"]].T.contiguous()
    cost, best, rec, q, cnt = fused_trial_math(
        tc, comb.contiguous(), orig_p.contiguous(), mode_row, rate_rows,
        nn_p)
    ipp = tc["ipp"]
    return (cost, best, rec.T[:, ipp].reshape(b, n, n),
            q.T[:, ipp].reshape(b, n, n), cnt.T.contiguous())


# ---------------------------------------------------------------- kernel --

# Launches of the CUDA kernel per unit size, counted where the wrapper
# launches it.  `reset_launch_counts` sets them to 0.
launches = {4: 0, 8: 0, 16: 0, 32: 0}


def reset_launch_counts():
    for k in launches:
        launches[k] = 0


def _check(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} {shape} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device} (contiguous={t.is_contiguous()})")


def _kernel_trial(tc, ref_top, ref_left, orig, mode_bits, rate_rows,
                  nn_pred=None):
    from . import _cuda_build

    lib = _cuda_build.library("unit_trial")
    n, nn = tc["n"], tc["nn"]
    b = ref_top.shape[0]
    dev = ref_top.device
    if "k_g0" not in tc:
        raise ValueError("consts lack the kernel tables (k_*): build them "
                         "with this package's build_consts")
    i32, f32 = torch.int32, torch.float32
    n_modes = tc["n_modes"]
    _check("ref_top", ref_top, (b, 2 * n + 1), i32, dev)
    _check("ref_left", ref_left, (b, 2 * n + 1), i32, dev)
    _check("orig", orig, (b, n, n), i32, dev)
    _check("mode_bits", mode_bits, (b, n_modes), f32, dev)
    _check("rate_rows", rate_rows, (8, b), i32, dev)
    if nn_pred is not None:
        # Without one the kernel predicts the zero block for the PNN mode.
        _check("nn_pred", nn_pred, (b, n, n), i32, dev)
    for k in ("k_g0", "k_g1", "k_frac", "k_use_filt", "k_tf", "k_ti",
              "k_scan", "k_sig0", "k_sig1", "k_sig0i", "k_sig1i",
              "k_lastpb", "k_iparams", "k_fparams"):
        if tc[k].device != dev:
            raise ValueError(f"table {k} is on {tc[k].device}, not {dev}")
    cost_m = torch.empty((b, M_PAD), dtype=f32, device=dev)
    rec_m = torch.empty((b, M_PAD, nn), dtype=i32, device=dev)
    q_m = torch.empty((b, M_PAD, nn), dtype=i32, device=dev)
    cnt_m = torch.empty((b, M_PAD, 8), dtype=i32, device=dev)
    cost = torch.empty((b,), dtype=f32, device=dev)
    best = torch.empty((b,), dtype=i32, device=dev)
    rec = torch.empty((b, n, n), dtype=i32, device=dev)
    q = torch.empty((b, n, n), dtype=i32, device=dev)
    cnt = torch.empty((b, 8), dtype=i32, device=dev)
    p = lambda t: t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.unit_trial(
        n, b, n_modes, p(ref_top), p(ref_left), p(orig), p(mode_bits),
        p(rate_rows), None if nn_pred is None else p(nn_pred),
        p(tc["k_g0"]), p(tc["k_g1"]), p(tc["k_frac"]), p(tc["k_use_filt"]),
        p(tc["k_tf"]), p(tc["k_ti"]), p(tc["k_scan"]), p(tc["k_sig0"]),
        p(tc["k_sig1"]), p(tc["k_sig0i"]), p(tc["k_sig1i"]),
        p(tc["k_lastpb"]), p(tc["k_iparams"]), p(tc["k_fparams"]),
        p(cost_m), p(rec_m), p(q_m), p(cnt_m),
        p(cost), p(best), p(rec), p(q), p(cnt), stream)
    if err != 0:
        raise RuntimeError(
            f"unit_trial kernel (n={n}, b={b}) failed: "
            f"{_cuda_build.error_string('unit_trial', err)}")
    launches[n] += 1
    return cost, best, rec, q, cnt


def trial_apply(tc, ref_top, ref_left, orig, mode_bits, rate_rows=None,
                impl="kernel", nn_pred=None):
    """The fused trial of b units: ref_top/ref_left (b, 2n+1) i32, orig
    (b, n, n) i32, mode_bits (b, n_modes) f32, rate_rows (8, b) i32 live
    rate-state deltas or None (static tables), nn_pred (b, n, n) i32 PNN
    prediction for the `nn_policy` mode or None (zeros).  Returns (cost (b,) f32,
    best (b,) i32, rec (b, n, n) i32, q (b, n, n) i32, counts (b, 8) i32).

    CPU tensors run the plain version.  CUDA tensors run the kernel, or the
    plain version when `impl="plain"` (for holding the two against each
    other); a kernel that cannot build or launch raises."""
    if rate_rows is None:
        rate_rows = torch.zeros((8, ref_top.shape[0]), dtype=torch.int32,
                                device=ref_top.device)
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "plain" or ref_top.device.type == "cpu":
        return _plain_trial(tc, ref_top, ref_left, orig, mode_bits,
                            rate_rows, nn_pred)
    if ref_top.device.type != "cuda":
        raise ValueError(f"no kernel for device {ref_top.device}")
    return _kernel_trial(tc, ref_top, ref_left, orig, mode_bits, rate_rows,
                         nn_pred)
