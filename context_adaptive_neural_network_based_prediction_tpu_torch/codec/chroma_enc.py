"""Encoder-side 4:2:0 chroma: mode decision + TB coding.

The port's copy of the JAX package's `codec/chroma_enc.py`, host numpy.
Per leaf CU it RD-selects the chroma mode among HM's five candidates
(planar / ver / hor / dc with angular-34 substitution + DM,
`TComDataCU::getAllowedChromaDir`; the switch policy's list with the PNNS
slot), coding every chroma TB of the CU's transform tree (RDOQ with the
chroma context set, optional sign hiding) against the running chroma
reconstruction.  `FrameEncoder` calls `encode_cu` inside each CU trial
(HM's integrated chroma RDO, `TEncCu.cpp:763,1544`); `run` is the
decoupled pass over frozen luma trees.

The chroma TB layout mirrors the luma TU tree: a TB of half size per luma TU
leaf above 4x4, and one shared 4x4 TB at the 8x8 parent of four 4x4 luma TUs
(coded at blkIdx 3) - identical to `hm_decoder._transform_tree`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..ops import intra, reference_samples as rs, transform
from . import rdo, rdoq as rdoq_mod, syntax
from .contexts import OFFSETS
from .encoder import MAX_TU, CuNode
from .hm_decoder import (CHROMA_CANDIDATES, SWITCH_CHROMA_CANDIDATES,
                         chroma_qp_420)

DM_INDEX = 4


@dataclass
class ChromaTb:
    xc: int
    yc: int
    nc: int
    cbf_cb: int
    cbf_cr: int
    coeffs_cb: Optional[np.ndarray]
    coeffs_cr: Optional[np.ndarray]


@dataclass
class CuChroma:
    mode_index: int            # 0..3 candidate or 4 = DM
    mode: int                  # derived prediction mode
    tbs: List[ChromaTb] = field(default_factory=list)


class ChromaPass:
    def __init__(self, cb: np.ndarray, cr: np.ndarray, qp: int, *,
                 lam: float, sign_hiding: bool, use_rdoq: bool = True,
                 cb_qp_offset: int = 0, cr_qp_offset: int = 0,
                 policy: str = "regular", pnn=None):
        self.cb = cb.astype(np.int32)
        self.cr = cr.astype(np.int32)
        self.hc, self.wc = cb.shape
        self.qp = qp
        self.qp_cb = chroma_qp_420(qp, cb_qp_offset)
        self.qp_cr = chroma_qp_420(qp, cr_qp_offset)
        self.policy = policy
        self.pnn = pnn.bind_qp(qp) if pnn is not None else None
        self.lam = lam
        self.sign_hiding = sign_hiding
        self.use_rdoq = use_rdoq
        self.recon_cb = np.zeros_like(self.cb)
        self.recon_cr = np.zeros_like(self.cr)
        uh, uw = (2 * self.hc + 3) // 4, (2 * self.wc + 3) // 4
        self.unit_coded = np.zeros((uh, uw), dtype=bool)
        self.est_ctx = None  # set per frame by run()

    # ----------------------------------------------------------- TB list ----

    def _chroma_tbs_of_cu(self, node: CuNode) -> List[tuple]:
        """(xc, yc, nc, tr_depth) of the CU's chroma TBs in coding order."""
        out = []

        def walk(x, y, size, depth, leaves):
            if size > MAX_TU:
                half = size // 2
                for (cx, cy) in ((x, y), (x + half, y), (x, y + half),
                                 (x + half, y + half)):
                    walk(cx, cy, half, depth + 1, leaves)
                return
            if (x, y, size) in leaves:
                if size > 4:
                    out.append((x // 2, y // 2, size // 2, depth))
                return
            half = size // 2
            quads = ((x, y), (x + half, y), (x, y + half), (x + half, y + half))
            if half == 4:
                for (cx, cy) in quads:
                    walk(cx, cy, half, depth + 1, leaves)
                # shared 4x4 chroma TB at the parent, after the 4 luma TUs
                out.append((x // 2, y // 2, 4, depth))
                return
            for (cx, cy) in quads:
                walk(cx, cy, half, depth + 1, leaves)

        if node.part_nxn:
            # NxN: luma TUs are the four 4x4 PUs; one shared 4x4 chroma TB.
            out.append((node.x // 2, node.y // 2, 4, 0))
        else:
            pu = node.pus[0]
            leaves = {(tu.x, tu.y, tu.n) for tu in pu.tus}
            walk(node.x, node.y, node.size, 0, leaves)
        return out

    # ------------------------------------------------------------ coding ----

    def _code_tb(self, plane, recon, xc, yc, nc, mode, qpc, counter, ctx):
        """Predict/transform/quant/recon one chroma TB; returns
        (sse, cbf, coeffs, rec)."""
        if mode == 35:
            # Switch chroma PNNS: same normative forward the decoder runs.
            pred = self.pnn.predict_chroma(recon, self.unit_coded, xc, yc,
                                           nc, self.hc, self.wc)
        else:
            flags = rs.coded_unit_flags(self.unit_coded, xc, yc, nc,
                                           self.hc, self.wc, unit=2)
            ref_top, ref_left = rs.fill_reference_samples(recon, xc, yc, nc,
                                                          flags, unit=2)
            pred = intra.predict_one_mode_np(ref_top, ref_left, mode,
                                             filtered_edges=False)
        orig = plane[yc:yc + nc, xc:xc + nc]
        resi = orig - pred
        coeff = transform.forward_transform_np(resi[None], use_dst=False)[0]
        if self.use_rdoq:
            q = rdoq_mod.rdoq(coeff, qpc, mode, self.lam, ctx,
                              cbf_ctx_offset=0, sign_hiding=self.sign_hiding,
                              channel=syntax.CHROMA)
        else:
            q = transform.quantize_np(coeff[None], qpc)[0]
        cbf = 1 if q.any() else 0
        if cbf:
            deq = transform.dequantize_np(q[None], qpc)[0]
            rec = np.clip(pred + transform.inverse_transform_np(
                deq[None], use_dst=False)[0], 0, 255)
            counter.count_coefficients(ctx, q, mode, self.sign_hiding,
                                       channel=syntax.CHROMA)
        else:
            rec = pred
        sse = int(((orig - rec) ** 2).sum())
        return sse, cbf, (q if cbf else None), rec

    @property
    def dist_weight(self) -> float:
        """HM's chroma distortion weight in the CU RD trial:
        2^((qp_luma - qp_chroma)/3) (TEncSearch weighted chroma SSE)."""
        return 2.0 ** ((self.qp - self.qp_cb) / 3.0)

    def save_cu(self, x, y, w_cu, h_cu):
        """Snapshot of the chroma state a CU trial may touch (luma-coord
        box); paired with `restore_cu` by FrameEncoder's save/restore."""
        xc, yc = x // 2, y // 2
        x1, y1 = min((x + w_cu) // 2, self.wc), min((y + h_cu) // 2, self.hc)
        return (self.recon_cb[yc:y1, xc:x1].copy(),
                self.recon_cr[yc:y1, xc:x1].copy(),
                self.unit_coded[yc // 2:y1 // 2, xc // 2:x1 // 2].copy())

    def restore_cu(self, x, y, w_cu, h_cu, snap):
        xc, yc = x // 2, y // 2
        x1, y1 = min((x + w_cu) // 2, self.wc), min((y + h_cu) // 2, self.hc)
        self.recon_cb[yc:y1, xc:x1] = snap[0]
        self.recon_cr[yc:y1, xc:x1] = snap[1]
        self.unit_coded[yc // 2:y1 // 2, xc // 2:x1 // 2] = snap[2]

    def _try_mode(self, node: CuNode, tbs, mode: int):
        """Codes all chroma TBs of the CU with `mode` directly into the
        running reconstruction (caller snapshots/restores the CU region).

        Returns (cost, records, ctx_after)."""
        counter = rdo.BitCounter()
        ctx = self.est_ctx.copy()
        sse_total = 0
        records = []
        for (xc, yc, nc, depth) in tbs:
            sse_b, cbf_b, q_b, rec_b = self._code_tb(
                self.cb, self.recon_cb, xc, yc, nc, mode, self.qp_cb,
                counter, ctx)
            counter.encode_bin(cbf_b, ctx, OFFSETS.cbf_chroma + depth)
            sse_r, cbf_r, q_r, rec_r = self._code_tb(
                self.cr, self.recon_cr, xc, yc, nc, mode, self.qp_cr,
                counter, ctx)
            counter.encode_bin(cbf_r, ctx, OFFSETS.cbf_chroma + depth)
            self.recon_cb[yc:yc + nc, xc:xc + nc] = rec_b
            self.recon_cr[yc:yc + nc, xc:xc + nc] = rec_r
            # Mark availability per TB so later TBs of the same CU see their
            # intra-CU neighbours exactly as the decoder does.
            self.unit_coded[yc // 2:(yc + nc) // 2,
                            xc // 2:(xc + nc) // 2] = True
            sse_total += sse_b + sse_r
            records.append(ChromaTb(xc, yc, nc, cbf_b, cbf_r, q_b, q_r))
        cost = sse_total + self.lam * counter.frac_bits
        return cost, records, ctx, sse_total, counter.frac_bits

    def _candidates(self, luma_mode: int):
        """Chroma mode candidates: H.265 8.4.3 list, or the switch list
        {Planar, DC, Ver, 35, DM} with HOR collision-substitution
        (hm_16_15_switch/.../TComDataCU.cpp:1364-1400)."""
        cands = []
        if self.policy == "switch":
            for i, m in enumerate(SWITCH_CHROMA_CANDIDATES):
                mode = 10 if m == luma_mode else m
                if mode == 35 and (self.pnn is None
                                   or not self.pnn.supports(4)):
                    continue
                cands.append((i, mode))
        else:
            for i, m in enumerate(CHROMA_CANDIDATES):
                cands.append((i, 34 if m == luma_mode else m))
        cands.append((DM_INDEX, luma_mode))
        return cands

    def encode_cu(self, node: CuNode):
        """RD-selects and COMMITS this CU's chroma mode; returns
        (sse, frac_bits incl. the chroma-mode syntax bits) of the winner so
        an integrated caller can fold them into the CU split decision."""
        luma_mode0 = node.pus[0].mode
        if luma_mode0 >= 35 and self.policy != "switch":
            # PNNS luma under a non-switch chroma pass: DM maps to a real
            # angular surrogate.
            luma_mode0 = syntax.DC_IDX
        tbs = self._chroma_tbs_of_cu(node)
        x, y, size = node.x, node.y, node.size
        xc, yc, nc = x // 2, y // 2, size // 2
        pre_cb = self.recon_cb[yc:yc + nc, xc:xc + nc].copy()
        pre_cr = self.recon_cr[yc:yc + nc, xc:xc + nc].copy()
        u = (slice(y // 4, (y + size) // 4), slice(x // 4, (x + size) // 4))
        pre_units = self.unit_coded[u].copy()
        best = None
        for index, mode in self._candidates(luma_mode0):
            # Chroma mode syntax: ~1 bin for DM, 3 for the list candidates
            # (ctx bin + 2 EP bins), in REAL bits.  (Round 3 multiplied by
            # the 2^15 fixed-point constant here, over-penalizing non-DM
            # candidates by ~32768 bits - the chroma mode search was
            # effectively DM-only.)
            bits_mode = 1.0 if index == DM_INDEX else 3.0
            cost, records, ctx, sse_t, fbits = self._try_mode(node, tbs,
                                                              mode)
            fbits = fbits + bits_mode
            cost += self.lam * bits_mode
            if best is None or cost < best[0]:
                best = (cost, index, mode, records,
                        self.recon_cb[yc:yc + nc, xc:xc + nc].copy(),
                        self.recon_cr[yc:yc + nc, xc:xc + nc].copy(), ctx,
                        sse_t, fbits)
            self.recon_cb[yc:yc + nc, xc:xc + nc] = pre_cb
            self.recon_cr[yc:yc + nc, xc:xc + nc] = pre_cr
            self.unit_coded[u] = pre_units
        (_, index, mode, records, post_cb, post_cr, ctx, sse_t,
         fbits) = best
        self.recon_cb[yc:yc + nc, xc:xc + nc] = post_cb
        self.recon_cr[yc:yc + nc, xc:xc + nc] = post_cr
        self.est_ctx = ctx
        node.chroma = CuChroma(index, mode, records)
        self.unit_coded[y // 4:(y + size) // 4, x // 4:(x + size) // 4] = True
        return sse_t, fbits

    def run(self, trees: List[CuNode], est_ctx: np.ndarray):
        self.est_ctx = est_ctx

        def walk(node):
            if node is None:
                return
            if node.split:
                for child in node.children:
                    walk(child)
                return
            self.encode_cu(node)

        for node in trees:
            walk(node)
        return self.recon_cb.astype(np.uint8), self.recon_cr.astype(np.uint8)

