"""Sample Adaptive Offset (SAO), luma, per CTU.

The port's copy of the JAX package's `codec/sao.py` (:41-406, the chroma
estimate `estimate_frame_chroma` included), HM-16.15 `TComSampleAdaptiveOffset` /
`TEncSampleAdaptiveOffset` semantics for 8-bit luma:

* per-CTU choice of OFF / band offset (BO) / edge offset (EO classes 0/90/135/
  45 degrees); four offsets with |offset| <= 7 (getMaxOffsetQVal for 8-bit);
* EO categories from the two directional neighbours (edgeIdx = 2 + sign(c-n0)
  + sign(c-n1) mapped {0:1, 1:2, 2:0, 3:3, 4:4}); category 1/2 offsets are
  non-negative, 3/4 non-positive (signs inferred, not coded);
* BO: 32 bands (pixel >> 3), four consecutive bands from a signalled start;
* encoder estimation per HM: category statistics (count, sum of orig-rec),
  iterative offset refinement minimizing count*o^2 - 2*o*sum + lambda*bits;
* syntax: sao_merge_left/up flags (shared context, init 153), sao_type_idx
  (first bin context init 200 I-slice, second bypass), truncated-rice abs
  offsets (cMax 7) in bypass, BO signs + 5-bit band position, 2-bit EO class;
* SAO input is the deblocked picture; applied picture-wide after decode.

Host numpy, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .contexts import OFFSETS

MAX_OFFSET = 7
MODE_OFF, MODE_BO, MODE_EO = 0, 1, 2
# Neighbour displacements per EO class (dy0,dx0),(dy1,dx1).
EO_NEIGHBORS = {
    0: ((0, -1), (0, 1)),
    1: ((-1, 0), (1, 0)),
    2: ((-1, -1), (1, 1)),
    3: ((-1, 1), (1, -1)),
}
_EDGE_CAT = np.array([1, 2, 0, 3, 4], dtype=np.int32)


@dataclass
class SaoParams:
    mode: int = MODE_OFF
    type_aux: int = 0            # eo_class (EO) or band_position (BO)
    offsets: tuple = (0, 0, 0, 0)

    def key(self):
        return (self.mode, self.type_aux, tuple(self.offsets))


def _eo_categories(rec: np.ndarray, eo_class: int) -> np.ndarray:
    """Per-pixel EO category (0 = no offset) for the whole picture."""
    h, w = rec.shape
    (dy0, dx0), (dy1, dx1) = EO_NEIGHBORS[eo_class]
    cat = np.zeros((h, w), dtype=np.int32)
    y0a, y1a = max(0, -dy0, -dy1), min(h, h - dy0, h - dy1)
    x0a, x1a = max(0, -dx0, -dx1), min(w, w - dx0, w - dx1)
    c = rec[y0a:y1a, x0a:x1a].astype(np.int32)
    n0 = rec[y0a + dy0:y1a + dy0, x0a + dx0:x1a + dx0].astype(np.int32)
    n1 = rec[y0a + dy1:y1a + dy1, x0a + dx1:x1a + dx1].astype(np.int32)
    edge_idx = 2 + np.sign(c - n0) + np.sign(c - n1)
    cat[y0a:y1a, x0a:x1a] = _EDGE_CAT[edge_idx]
    return cat


def apply_sao(deblocked: np.ndarray, params_grid, ctu_size: int) -> np.ndarray:
    """Applies per-CTU SAO params to the deblocked picture."""
    h, w = deblocked.shape
    out = deblocked.astype(np.int32).copy()
    # Precompute EO category planes lazily per class used.
    cat_planes = {}
    for cy, row in enumerate(params_grid):
        for cx, p in enumerate(row):
            if p.mode == MODE_OFF:
                continue
            y0, y1 = cy * ctu_size, min((cy + 1) * ctu_size, h)
            x0, x1 = cx * ctu_size, min((cx + 1) * ctu_size, w)
            region = out[y0:y1, x0:x1]
            if p.mode == MODE_EO:
                if p.type_aux not in cat_planes:
                    cat_planes[p.type_aux] = _eo_categories(deblocked, p.type_aux)
                cat = cat_planes[p.type_aux][y0:y1, x0:x1]
                offs = np.array([0, p.offsets[0], p.offsets[1],
                                 p.offsets[2], p.offsets[3]], dtype=np.int32)
                region += offs[cat]
            else:  # BO
                band = deblocked[y0:y1, x0:x1].astype(np.int32) >> 3
                off_map = np.zeros(32, dtype=np.int32)
                for i in range(4):
                    off_map[(p.type_aux + i) % 32] = p.offsets[i]
                region += off_map[band]
            out[y0:y1, x0:x1] = region
    return np.clip(out, 0, 255).astype(deblocked.dtype)


# ------------------------------------------------------------- estimation ---

def _tr_bits(mag: int) -> int:
    """Truncated-rice(cMax=7) bin count for an offset magnitude."""
    return mag + 1 if mag < MAX_OFFSET else MAX_OFFSET


def _best_offset(count: int, total: int, lam: float, positive: bool,
                 extra_sign_bit: bool = False):
    """HM estIterOffset: best offset + its (distortion + lam*bits) delta."""
    if count == 0:
        return 0, 0.0
    raw = int(round(total / count))
    raw = max(0, min(MAX_OFFSET, raw)) if positive else max(-MAX_OFFSET, min(0, raw))
    best_o, best_cost = 0, 0.0
    o = raw
    while o != 0:
        dist = count * o * o - 2 * o * total
        bits = _tr_bits(abs(o)) + (1 if (extra_sign_bit and o != 0) else 0)
        cost = dist + lam * bits
        if cost < best_cost:
            best_o, best_cost = o, cost
        o += -1 if o > 0 else 1
    return best_o, best_cost


def _params_dist_delta(p: SaoParams, diff: np.ndarray, r_reg: np.ndarray,
                       cat_planes: dict, y0, y1, x0, x1) -> float:
    """Delta-SSE of applying `p` to the region (count*o^2 - 2*o*sum per cat)."""
    if p.mode == MODE_OFF:
        return 0.0
    d = 0.0
    if p.mode == MODE_EO:
        cat = cat_planes[p.type_aux][y0:y1, x0:x1]
        for c in range(1, 5):
            o = p.offsets[c - 1]
            if o == 0:
                continue
            mask = cat == c
            count = int(mask.sum())
            total = int(diff[mask].sum()) if count else 0
            d += count * o * o - 2 * o * total
    else:
        band = (r_reg >> 3).astype(np.int32)
        counts = np.bincount(band.reshape(-1), minlength=32)
        sums = np.bincount(band.reshape(-1), weights=diff.reshape(-1),
                           minlength=32)
        for i in range(4):
            o = p.offsets[i]
            if o == 0:
                continue
            b = (p.type_aux + i) % 32
            d += int(counts[b]) * o * o - 2 * o * float(sums[b])
    return d


def estimate_ctu(orig: np.ndarray, deblocked: np.ndarray, cat_planes: dict,
                 y0: int, y1: int, x0: int, x1: int, lam: float) -> tuple:
    """RD-chooses new OFF/BO/EO params for one CTU region.

    Returns (params, cost) where cost = delta-SSE + lam * payload bits
    (type + all four offset codewords incl. zero offsets + aux), WITHOUT the
    merge-flag bins (added by the caller, which also evaluates merge
    candidates - HM TEncSampleAdaptiveOffset::decideBlkParams).
    """
    o_reg = orig[y0:y1, x0:x1].astype(np.int64)
    r_reg = deblocked[y0:y1, x0:x1].astype(np.int64)
    diff = o_reg - r_reg

    best = SaoParams()
    best_cost = lam * 1  # OFF: sao_type_idx first bin only

    # --- EO classes ---
    for eo_class in range(4):
        cat = cat_planes[eo_class][y0:y1, x0:x1]
        offsets = []
        cost = 0.0
        for c in range(1, 5):
            mask = cat == c
            count = int(mask.sum())
            total = int(diff[mask].sum()) if count else 0
            o, dcost = _best_offset(count, total, lam, positive=(c <= 2))
            offsets.append(o)
            # _best_offset prices nonzero offsets; a zero offset still codes
            # one truncated-rice bin.
            cost += dcost if o else lam * _tr_bits(0)
        cost += lam * (2 + 2)  # type bins + eo_class bits
        if cost < best_cost and any(offsets):
            best = SaoParams(MODE_EO, eo_class, tuple(offsets))
            best_cost = cost

    # --- BO ---
    band = (r_reg >> 3).astype(np.int32)
    counts = np.bincount(band.reshape(-1), minlength=32)
    sums = np.bincount(band.reshape(-1), weights=diff.reshape(-1), minlength=32)
    band_best = []
    for b in range(32):
        o, dcost = _best_offset(int(counts[b]), int(sums[b]), lam,
                                positive=(sums[b] >= 0), extra_sign_bit=True)
        if o == 0:
            o_neg, dcost_neg = _best_offset(int(counts[b]), int(sums[b]), lam,
                                            positive=False, extra_sign_bit=True)
            if dcost_neg < dcost:
                o, dcost = o_neg, dcost_neg
        band_best.append((o, dcost if o else lam * _tr_bits(0)))
    for pos in range(29):
        offsets = tuple(band_best[pos + i][0] for i in range(4))
        cost = sum(band_best[pos + i][1] for i in range(4)) + lam * (2 + 5)
        if cost < best_cost and any(offsets):
            best = SaoParams(MODE_BO, pos, offsets)
            best_cost = cost
    return best, best_cost


def estimate_frame(orig: np.ndarray, deblocked: np.ndarray, ctu_size: int,
                   lam: float, *, merge: bool = True):
    """Per-CTU SAO parameter grid for a frame.

    Raster order; each CTU compares merge-left / merge-up reuse of the
    already-decided neighbour params (1-2 merge-flag bins) against fresh
    params (merge flags at 0 + full payload), like HM's
    TEncSampleAdaptiveOffset::decideBlkParams.  Merged CTUs share the
    neighbour's SaoParams, so the serializer's key()-equality emits the
    merge flag.
    """
    h, w = orig.shape
    cat_planes = {c: _eo_categories(deblocked, c) for c in range(4)}
    grid = []
    for cy in range((h + ctu_size - 1) // ctu_size):
        row = []
        for cx in range((w + ctu_size - 1) // ctu_size):
            y0, y1 = cy * ctu_size, min((cy + 1) * ctu_size, h)
            x0, x1 = cx * ctu_size, min((cx + 1) * ctu_size, w)
            n_flags = (1 if cx > 0 else 0) + (1 if cy > 0 else 0)
            new_p, new_cost = estimate_ctu(orig, deblocked, cat_planes,
                                           y0, y1, x0, x1, lam)
            best_p, best_cost = new_p, new_cost + lam * n_flags
            diff = (orig[y0:y1, x0:x1].astype(np.int64)
                    - deblocked[y0:y1, x0:x1].astype(np.int64))
            r_reg = deblocked[y0:y1, x0:x1].astype(np.int64)
            if merge and cx > 0:
                p = row[cx - 1]
                cost = _params_dist_delta(p, diff, r_reg, cat_planes,
                                          y0, y1, x0, x1) + lam * 1
                if cost < best_cost:
                    best_p, best_cost = p, cost
            if merge and cy > 0:
                p = grid[cy - 1][cx]
                cost = (_params_dist_delta(p, diff, r_reg, cat_planes,
                                           y0, y1, x0, x1)
                        + lam * (2 if cx > 0 else 1))
                if cost < best_cost:
                    best_p, best_cost = p, cost
            row.append(best_p)
        grid.append(row)
    return grid


# ----------------------------------------------------------------- syntax ---

def _encode_offset_mag(enc, mag: int):
    for _ in range(mag):
        enc.encode_bin_ep(1)
    if mag < MAX_OFFSET:
        enc.encode_bin_ep(0)


def _decode_offset_mag(dec) -> int:
    mag = 0
    while mag < MAX_OFFSET and dec.decode_bin_ep():
        mag += 1
    return mag


def encode_params(enc, ctx, grid) -> None:
    """Encodes the per-CTU SAO grid (raster order, merge flags first)."""
    for cy, row in enumerate(grid):
        for cx, p in enumerate(row):
            if cx > 0:
                merge_left = p.key() == row[cx - 1].key()
                enc.encode_bin(1 if merge_left else 0, ctx, OFFSETS.sao_merge)
                if merge_left:
                    continue
            if cy > 0:
                merge_up = p.key() == grid[cy - 1][cx].key()
                enc.encode_bin(1 if merge_up else 0, ctx, OFFSETS.sao_merge)
                if merge_up:
                    continue
            enc.encode_bin(0 if p.mode == MODE_OFF else 1, ctx, OFFSETS.sao_type)
            if p.mode == MODE_OFF:
                continue
            enc.encode_bin_ep(1 if p.mode == MODE_EO else 0)
            for o in p.offsets:
                _encode_offset_mag(enc, abs(o))
            if p.mode == MODE_BO:
                for o in p.offsets:
                    if o != 0:
                        enc.encode_bin_ep(1 if o < 0 else 0)
                enc.encode_bins_ep(p.type_aux, 5)
            else:
                enc.encode_bins_ep(p.type_aux, 2)


def decode_params(dec, ctx, n_ctu_y: int, n_ctu_x: int):
    grid = [[None] * n_ctu_x for _ in range(n_ctu_y)]
    for cy in range(n_ctu_y):
        for cx in range(n_ctu_x):
            if cx > 0 and dec.decode_bin(ctx, OFFSETS.sao_merge):
                grid[cy][cx] = grid[cy][cx - 1]
                continue
            if cy > 0 and dec.decode_bin(ctx, OFFSETS.sao_merge):
                grid[cy][cx] = grid[cy - 1][cx]
                continue
            if not dec.decode_bin(ctx, OFFSETS.sao_type):
                grid[cy][cx] = SaoParams()
                continue
            is_eo = bool(dec.decode_bin_ep())
            mags = [_decode_offset_mag(dec) for _ in range(4)]
            if not is_eo:
                offsets = []
                for m in mags:
                    if m != 0 and dec.decode_bin_ep():
                        offsets.append(-m)
                    else:
                        offsets.append(m)
                pos = dec.decode_bins_ep(5)
                grid[cy][cx] = SaoParams(MODE_BO, pos, tuple(offsets))
            else:
                eo_class = dec.decode_bins_ep(2)
                offsets = (mags[0], mags[1], -mags[2], -mags[3])
                grid[cy][cx] = SaoParams(MODE_EO, eo_class, offsets)
    return grid


def estimate_frame_chroma(orig_cb, deblocked_cb, orig_cr, deblocked_cr,
                          ctu_size_chroma: int, lam: float):
    """Joint per-CTU SAO params for Cb+Cr (shared mode and EO class,
    per-component offsets/band - HEVC chroma SAO signalling).

    Returns (grid_cb, grid_cr).
    """
    h, w = orig_cb.shape
    cats = {"cb": {c: _eo_categories(deblocked_cb, c) for c in range(4)},
            "cr": {c: _eo_categories(deblocked_cr, c) for c in range(4)}}
    grid_cb, grid_cr = [], []
    n_y = (h + ctu_size_chroma - 1) // ctu_size_chroma
    n_x = (w + ctu_size_chroma - 1) // ctu_size_chroma
    for cy in range(n_y):
        row_cb, row_cr = [], []
        for cx in range(n_x):
            y0, y1 = cy * ctu_size_chroma, min((cy + 1) * ctu_size_chroma, h)
            x0, x1 = cx * ctu_size_chroma, min((cx + 1) * ctu_size_chroma, w)

            def comp_cost(orig, deb, plane_cats, mode, aux):
                o = orig[y0:y1, x0:x1].astype(np.int64)
                r = deb[y0:y1, x0:x1].astype(np.int64)
                diff = o - r
                offsets, cost = [], 0.0
                if mode == MODE_EO:
                    cat = plane_cats[aux][y0:y1, x0:x1]
                    for c in range(1, 5):
                        mask = cat == c
                        count = int(mask.sum())
                        total = int(diff[mask].sum()) if count else 0
                        off, dcost = _best_offset(count, total, lam,
                                                  positive=(c <= 2))
                        offsets.append(off)
                        cost += dcost + lam * _tr_bits(abs(off))
                    return tuple(offsets), cost
                band = (r >> 3).astype(np.int32)
                counts = np.bincount(band.reshape(-1), minlength=32)
                sums = np.bincount(band.reshape(-1), weights=diff.reshape(-1),
                                   minlength=32)
                best = None
                for pos in range(29):
                    offs, c_total = [], 0.0
                    for i in range(4):
                        b = pos + i
                        off, dcost = _best_offset(
                            int(counts[b]), int(sums[b]), lam,
                            positive=(sums[b] >= 0), extra_sign_bit=True)
                        offs.append(off)
                        c_total += dcost + lam * (_tr_bits(abs(off))
                                                  + (1 if off else 0))
                    c_total += lam * 5
                    if best is None or c_total < best[1]:
                        best = ((tuple(offs), pos), c_total)
                return best[0], best[1]

            best = (SaoParams(), SaoParams(), lam * 1.0)  # OFF
            for eo_class in range(4):
                ob, cb_cost = comp_cost(orig_cb, deblocked_cb, cats["cb"],
                                        MODE_EO, eo_class)
                orr, cr_cost = comp_cost(orig_cr, deblocked_cr, cats["cr"],
                                         MODE_EO, eo_class)
                cost = cb_cost + cr_cost + lam * (2 + 2)
                if cost < best[2] and (any(ob) or any(orr)):
                    best = (SaoParams(MODE_EO, eo_class, ob),
                            SaoParams(MODE_EO, eo_class, orr), cost)
            (ob, pb), cb_cost = comp_cost(orig_cb, deblocked_cb, cats["cb"],
                                          MODE_BO, None)
            (orr, pr), cr_cost = comp_cost(orig_cr, deblocked_cr, cats["cr"],
                                           MODE_BO, None)
            cost = cb_cost + cr_cost + lam * 2
            if cost < best[2] and (any(ob) or any(orr)):
                best = (SaoParams(MODE_BO, pb, ob),
                        SaoParams(MODE_BO, pr, orr), cost)
            row_cb.append(best[0])
            row_cr.append(best[1])
        grid_cb.append(row_cb)
        grid_cr.append(row_cr)
    return grid_cb, grid_cr
