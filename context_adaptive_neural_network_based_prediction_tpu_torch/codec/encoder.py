"""The host RDO encoder, its records and the framework container.

The port's copy of the JAX package's `codec/encoder.py`: the decided
CU-tree records, `EncodeResult`, `stream_header` (the header the native
packer's payload follows), the structure constants, the switch policy's
MPM rule, and the All-Intra luma encoder with quadtree RDO `FrameEncoder`
(HM-16.15 semantics: CU quadtree 64 -> 8 with NxN 4x4 PUs, a SATD fast
pass then full RD with RDOQ, transform skip and HM's truncated CABAC bit
counts, deblocking and SAO; see the JAX package's module docstring),
`serialize_trees` (the real CABAC pass over decided trees) and
`encode_frame`.  The encoder is host numpy, as in the JAX package; the
NN policies' PNN forwards run on the predictor's device.  The stream
format is the JAX package's, so its decoder reads the port's streams and
the port's decoder reads its streams.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..ops import intra, reference_samples as rs, transform
from . import cabac, deblock, rdo, rdoq as rdoq_mod, sao as sao_mod, syntax
from .contexts import OFFSETS, make_context_states
from .nn_intra import as_predictor, check_device

MAGIC = b"CPNN"
VERSION = 6
POLICIES = ("regular", "substitution", "switch")
PNNS_MODE = 35
MIN_CU = 8
MAX_TU = 32


@dataclass
class TuRecord:
    x: int
    y: int
    n: int
    cbf: int
    coeffs: Optional[np.ndarray]
    tskip: int = 0


@dataclass
class PuRecord:
    x: int
    y: int
    n: int
    mode: int
    tus: List[TuRecord] = field(default_factory=list)


@dataclass
class CuNode:
    x: int
    y: int
    size: int
    depth: int
    split: bool
    part_nxn: bool = False
    pus: List[PuRecord] = field(default_factory=list)
    children: list = field(default_factory=list)


@dataclass
class EncodeResult:
    bitstream: bytes
    reconstruction: np.ndarray
    num_bits: int
    ctu_trees: List[CuNode]
    mode_map: np.ndarray  # per 4x4 unit: chosen luma mode (-1 outside)
    qp: int
    policy: str


def stream_header(*, width: int, height: int, qp: int, policy: str,
                  ctu_size: int, sign_hiding: bool, deblocking: bool = False,
                  max_tu_depth: int = 0, has_sao: bool = False,
                  transform_skip: bool = False) -> bytes:
    """The framework container header (shared by Python + native packers)."""
    return struct.pack("<4sBBBBBBBBBII", MAGIC, VERSION,
                       POLICIES.index(policy), qp, 1 if sign_hiding else 0,
                       1 if deblocking else 0, max_tu_depth,
                       1 if has_sao else 0, 1 if transform_skip else 0,
                       ctu_size, width, height)


def mpms_switch(left: int, above: int):
    """hm_16_15_switch MPM rules (TComDataCU.cpp:1475-1596; the JAX
    package's `FrameEncoder._mpms_switch`)."""
    if left == above:
        if 1 < left < PNNS_MODE:
            return [left, ((left + 29) % 32) + 2, ((left - 1) % 32) + 2]
        return [syntax.PLANAR_IDX, syntax.DC_IDX, syntax.VER_IDX]
    if left == PNNS_MODE or above == PNNS_MODE:
        m0 = above if left == PNNS_MODE else left
        if m0 > 1:
            return [m0, syntax.PLANAR_IDX, syntax.DC_IDX]
        if m0 == syntax.DC_IDX:
            return [syntax.DC_IDX, syntax.PLANAR_IDX, syntax.VER_IDX]
        return [syntax.PLANAR_IDX, syntax.DC_IDX, syntax.VER_IDX]
    return syntax.mpm_candidates(left, above)


class FrameEncoder:
    """HM-style RDO encode of one luma frame (JAX package :115-741), host
    numpy; the NN policies' PNN forwards run on `device` ("cuda" by
    default; a CUDA device without a card raises).  `pnn` is a
    `PnnPredictor` or a `PnnBundle`."""

    def __init__(self, frame_uint8: np.ndarray, qp: int, *,
                 policy: str = "regular", pnn=None,
                 ctu_size: int = 64, sign_hiding: bool = True,
                 strong_intra_smoothing: bool = True,
                 rd_candidates: Optional[dict] = None,
                 use_rdoq: bool = True, deblocking: bool = True,
                 max_tu_depth: int = 2, sao: bool = True,
                 transform_skip: bool = True, tskip_fast: bool = True,
                 chroma_rdo=None, device="cuda"):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}")
        if policy != "regular" and pnn is None:
            raise ValueError("NN policies need a PnnPredictor")
        frame = np.asarray(frame_uint8)
        if frame.dtype != np.uint8 or frame.ndim != 2:
            raise ValueError("frame must be a (H, W) uint8 luma channel")
        if frame.shape[0] % MIN_CU or frame.shape[1] % MIN_CU:
            raise ValueError("frame dims must be multiples of 8 (crop first)")
        self.frame = frame.astype(np.int32)
        self.h, self.w = frame.shape
        self.qp = qp
        self.policy = policy
        self.device = check_device(device)
        # QP-based single/pair model selection (TComPrediction.cpp:155-170).
        self.pnn = (as_predictor(pnn, self.device).bind_qp(qp)
                    if pnn is not None else None)
        self.ctu = ctu_size
        self.sign_hiding = sign_hiding
        self.strong_smoothing = strong_intra_smoothing
        self.lam = rdo.lambda_for_qp(qp)
        self.sqrt_lam = self.lam ** 0.5
        self.use_rdoq = use_rdoq
        if sign_hiding and not use_rdoq:
            raise ValueError("sign_hiding requires RDOQ (the quantizer must "
                             "enforce the hidden sign's parity)")
        # Full-RD candidate counts.  HM takes 3 for PUs >= 16
        # (g_aucIntraModeNumFast_UseMPM); with the RD accounting now
        # matching HM's exactly, widening to 8 is a strict search
        # improvement - measured -0.12% BD-rate avg over the two anchor
        # frames (artifacts/real_cost_cmp_cand8.json) for ~1.5x host encode
        # time.  Pass rd_candidates={16: 3, 32: 3, 64: 3} for HM parity.
        self.n_candidates = dict(rdo.NUM_FAST_CANDIDATES)
        self.n_candidates.update({16: 8, 32: 8, 64: 8})
        if rd_candidates:
            self.n_candidates.update(rd_candidates)

        self.deblocking = deblocking
        self.sao = sao
        self.transform_skip = transform_skip
        # tskip_fast = TransformSkipFast (tskip trialled for NxN 4x4 only).
        self.tskip_fast = tskip_fast
        self.max_tu_depth = max_tu_depth
        uh, uw = self.h // 4, self.w // 4
        self.recon = np.zeros((self.h, self.w), dtype=np.int32)
        self.unit_coded = np.zeros((uh, uw), dtype=bool)
        self.mode_map = np.full((uh, uw), -1, dtype=np.int32)
        self.depth_map = np.zeros((uh, uw), dtype=np.int32)
        self.tu_map = np.full((uh, uw), -1, dtype=np.int32)
        self.tu_counter = 0
        self.est_ctx = make_context_states(qp)
        # Integrated 4:2:0 RDO (a `chroma_enc.ChromaPass`): every CU trial
        # adds the CU's best chroma mode cost into the split decision, as
        # HM's xCheckRDCostIntra -> estIntraPredChromaQT does
        # (TEncCu.cpp:763,1544).  None = luma-only (or the decoupled
        # post-pass, the round-3 simplification).
        self.chroma_rdo = chroma_rdo

    # ------------------------------------------------------------ helpers --

    def _save(self, x, y, size):
        x1 = min(x + size, self.w)
        y1 = min(y + size, self.h)
        # Snapshot covers the CU area plus everything the trial may touch
        # (only the CU area itself changes; maps are unit-granular).  The
        # context array is managed explicitly by the trial choreography
        # (it mirrors HM's CI_* snapshot discipline), NOT here.
        snap = (self.recon[y:y1, x:x1].copy(),
                self.unit_coded[y // 4:y1 // 4, x // 4:x1 // 4].copy(),
                self.mode_map[y // 4:y1 // 4, x // 4:x1 // 4].copy(),
                self.depth_map[y // 4:y1 // 4, x // 4:x1 // 4].copy(),
                self.tu_map[y // 4:y1 // 4, x // 4:x1 // 4].copy())
        if self.chroma_rdo is not None:
            snap = snap + (self.chroma_rdo.save_cu(x, y, x1 - x, y1 - y),)
        return snap

    def _restore(self, x, y, size, snap):
        x1 = min(x + size, self.w)
        y1 = min(y + size, self.h)
        self.recon[y:y1, x:x1] = snap[0]
        self.unit_coded[y // 4:y1 // 4, x // 4:x1 // 4] = snap[1]
        self.mode_map[y // 4:y1 // 4, x // 4:x1 // 4] = snap[2]
        self.depth_map[y // 4:y1 // 4, x // 4:x1 // 4] = snap[3]
        self.tu_map[y // 4:y1 // 4, x // 4:x1 // 4] = snap[4]
        if self.chroma_rdo is not None:
            self.chroma_rdo.restore_cu(x, y, x1 - x, y1 - y, snap[5])

    def _neighbor_mode(self, x: int, y: int, left: bool) -> int:
        """Luma mode of the left/above PU for MPM (DC if unavailable)."""
        if left:
            nx, ny = x - 1, y
        else:
            nx, ny = x, y - 1
            if y % self.ctu == 0:
                return syntax.DC_IDX  # above CTU row: unavailable for MPM
        if nx < 0 or ny < 0:
            return syntax.DC_IDX
        m = int(self.mode_map[ny // 4, nx // 4])
        return m if m >= 0 else syntax.DC_IDX

    def _mpms(self, x: int, y: int):
        left = self._neighbor_mode(x, y, True)
        above = self._neighbor_mode(x, y, False)
        if self.policy == "switch":
            return mpms_switch(left, above)
        return syntax.mpm_candidates(left, above)

    def _split_ctx(self, x: int, y: int, depth: int) -> int:
        ctx = 0
        ux, uy = x // 4, y // 4
        if x > 0 and self.unit_coded[uy, ux - 1]:
            ctx += 1 if self.depth_map[uy, ux - 1] > depth else 0
        if y > 0 and self.unit_coded[uy - 1, ux]:
            ctx += 1 if self.depth_map[uy - 1, ux] > depth else 0
        return ctx

    def _encode_mode_bits(self, counter, ctx, mode, mpms):
        if self.policy == "switch":
            counter.encode_bin(1 if mode == PNNS_MODE else 0, ctx, OFFSETS.pnns_flag)
            if mode == PNNS_MODE:
                return
        syntax.encode_intra_mode(counter, ctx, mode, mpms)

    # ------------------------------------------------------- prediction ----

    def _predict_modes(self, x, y, n):
        """All candidate-mode predictions for a TU/PU of size n at (x, y).

        Returns (preds dict mode->(n,n) int32 lazily materialized as array,
        flags) - concretely a (n_modes, n, n) array where entry m is mode m's
        prediction; for NN policies mode 18/35 are replaced appropriately.
        """
        flags = rs.coded_unit_flags(self.unit_coded, x, y, n, self.h, self.w)
        ref_top, ref_left = rs.fill_reference_samples(self.recon, x, y, n, flags)
        f_top, f_left = rs.filter_reference_samples(
            ref_top, ref_left, n, strong_intra_smoothing=self.strong_smoothing)
        both_top = np.stack([ref_top, f_top])
        both_left = np.stack([ref_left, f_left])
        preds_both = intra.predict_all_modes_np(both_top, both_left)
        use_filtered = np.array([rs.use_filtered_for_mode(m, n) for m in range(35)])
        preds = np.where(use_filtered[:, None, None], preds_both[1], preds_both[0])

        if self.policy == "substitution" and self.pnn.supports(n):
            # Widths without a model keep the angular mode-18 prediction
            # (the reference ships models for every width it runs; this
            # fallback only matters when the zoo is partial).
            preds[18] = self.pnn.predict(self.recon, x, y, n, flags)
        elif self.policy == "switch":
            pnns = self.pnn.predict(self.recon, x, y, n, flags)[None]
            preds = np.concatenate([preds, pnns], axis=0)
        return preds, flags

    def _predict_single(self, x, y, n, mode):
        """One-mode prediction for TU reconstruction (35x cheaper than the
        full sweep; NN modes route through the PnnPredictor)."""
        flags = rs.coded_unit_flags(self.unit_coded, x, y, n, self.h, self.w)
        if ((self.policy == "substitution" and mode == 18
             and self.pnn.supports(n)) or mode == PNNS_MODE):
            return self.pnn.predict(self.recon, x, y, n, flags)
        ref_top, ref_left = rs.fill_reference_samples(self.recon, x, y, n, flags)
        if rs.use_filtered_for_mode(mode, n):
            ref_top, ref_left = rs.filter_reference_samples(
                ref_top, ref_left, n,
                strong_intra_smoothing=self.strong_smoothing)
        return intra.predict_one_mode_np(ref_top, ref_left, mode)

    # ------------------------------------------------------ TU machinery ---

    def _quantize_tu(self, x, y, n, mode, ctx, *, pred=None, tskip: int,
                     depth0: bool):
        """Transform/quantize/reconstruct one TU (no state committed).

        RDOQ reads `ctx` exactly as HM's RDOQ reads the estBit tables
        refreshed from the RD coder at this point in the trial.
        Returns (TuRecord, rec, sse).
        """
        if pred is None:
            pred = self._predict_single(x, y, n, mode)
        orig = self.frame[y:y + n, x:x + n]
        resi = orig - pred
        syn_mode = mode if mode != PNNS_MODE else 0
        if tskip:
            tshift = transform.transform_shift(2)
            coeff = resi.astype(np.int32) << tshift
        else:
            coeff = transform.forward_transform_np(resi[None],
                                                   use_dst=(n == 4))[0]
        if self.use_rdoq:
            q = rdoq_mod.rdoq(coeff, self.qp, syn_mode, self.lam, ctx,
                              cbf_ctx_offset=1 if depth0 else 0,
                              sign_hiding=self.sign_hiding)
        else:
            q = transform.quantize_np(coeff[None], self.qp)[0]
        cbf = 1 if q.any() else 0
        if cbf:
            deq = transform.dequantize_np(q[None], self.qp)[0]
            if tskip:
                tshift = transform.transform_shift(2)
                rr = (deq + (1 << (tshift - 1))) >> tshift
            else:
                rr = transform.inverse_transform_np(deq[None],
                                                    use_dst=(n == 4))[0]
            rec = np.clip(pred + rr, 0, 255)
        else:
            rec = pred
        sse = int(((orig - rec) ** 2).sum())
        return TuRecord(x, y, n, cbf, q if cbf else None, tskip), rec, sse

    def _commit_tu(self, turec: TuRecord, rec: np.ndarray):
        x, y, n = turec.x, turec.y, turec.n
        self.recon[y:y + n, x:x + n] = rec
        self.unit_coded[y // 4:(y + n) // 4, x // 4:(x + n) // 4] = True
        self.tu_map[y // 4:(y + n) // 4, x // 4:(x + n) // 4] = self.tu_counter
        self.tu_counter += 1

    def _count_leaf(self, counter, ctx, turec: TuRecord, mode, *,
                    depth0: bool):
        """cbf (+ transform-skip flag) + coefficients of one decided TU."""
        counter.encode_bin(turec.cbf, ctx,
                           OFFSETS.cbf_luma + (1 if depth0 else 0))
        if turec.cbf:
            if self.transform_skip and turec.n == 4:
                counter.encode_bin(turec.tskip, ctx, OFFSETS.transform_skip)
            counter.count_coefficients(ctx, turec.coeffs,
                                       mode if mode != PNNS_MODE else 0,
                                       self.sign_hiding)

    def _count_subtree(self, counter, ctx, x, y, size, depth, leaves, mode,
                       *, nxn: bool):
        """Subdiv flags + leaf syntax of a decided TU subtree (z-order)."""
        forced = size > MAX_TU
        flag_present = (not forced) and size > 4 and depth < self.max_tu_depth
        leaf = leaves.get((x, y, size))
        if flag_present:
            counter.encode_bin(0 if leaf is not None else 1, ctx,
                               OFFSETS.trans_subdiv
                               + (5 - (size.bit_length() - 1)))
        if leaf is not None:
            self._count_leaf(counter, ctx, leaf, mode,
                             depth0=(depth == 0 and not nxn))
            return
        half = size // 2
        for (cx, cy) in ((x, y), (x + half, y), (x, y + half),
                         (x + half, y + half)):
            self._count_subtree(counter, ctx, cx, cy, half, depth + 1,
                                leaves, mode, nxn=nxn)

    def _tu_node(self, x, y, size, depth, mode, ctx, *, nxn: bool,
                 check_first: bool, hdr, preds=None):
        """xRecurIntraCodingLumaQT analog: decide + commit one TU subtree.

        `ctx` is the LIVE trial context array: counting passes mutate it
        exactly like HM's RD coder, with store/load at the same points
        (CI_QT_TRAFO_ROOT / CI_QT_TRAFO_TEST / CI_TEMP_BEST).  `hdr` is
        (part_size_bin_or_None, cu_pos, mode_pos, mpms): the node header
        (xEncIntraHeader) re-codes part_size at the CU's top-left node and
        the PU mode at the mode position's node in EVERY counting pass.
        Returns (sse, bits_int, cost, leaves) where cost carries ONE
        fractional-bit truncation over header + decided subtree.
        """
        forced = size > MAX_TU
        flag_present = (not forced) and size > 4 and depth < self.max_tu_depth
        flag_ctx = OFFSETS.trans_subdiv + (5 - (size.bit_length() - 1))
        check_split = forced or (flag_present and not check_first)
        half = size // 2
        quadrants = ((x, y), (x + half, y), (x, y + half),
                     (x + half, y + half))
        part_size_bin, cu_pos, mode_pos, mpms = hdr

        def code_hdr(counter, cctx):
            if (x, y) == cu_pos and part_size_bin is not None:
                counter.encode_bin(part_size_bin, cctx, OFFSETS.part_size)
            if (x, y) == mode_pos:
                self._encode_mode_bits(counter, cctx, mode, mpms)

        single = None
        root_ctx = ctx.copy()                      # CI_QT_TRAFO_ROOT
        if not forced:
            pre = self._save(x, y, size)
            pred = None
            if preds is not None and depth == 0:
                pred = preds[-1] if mode == PNNS_MODE else preds[mode]
            depth0 = depth == 0 and not nxn
            tu0, rec0, sse0 = self._quantize_tu(x, y, size, mode, ctx,
                                                pred=pred, tskip=0,
                                                depth0=depth0)
            counter = rdo.BitCounter()
            code_hdr(counter, ctx)
            if flag_present:
                counter.encode_bin(0, ctx, flag_ctx)
            self._count_leaf(counter, ctx, tu0, mode, depth0=depth0)
            bits0 = counter.bits >> 15
            cost0 = sse0 + self.lam * bits0
            chosen = (cost0, sse0, bits0, tu0, rec0)
            post0 = ctx.copy()
            if (size == 4 and self.transform_skip
                    and (nxn or not self.tskip_fast)):
                ctx[:] = root_ctx
                tu1, rec1, sse1 = self._quantize_tu(x, y, size, mode, ctx,
                                                    pred=pred, tskip=1,
                                                    depth0=depth0)
                # TS with cbf 0 is forbidden (TEncSearch.cpp:1565-1569).
                if tu1.cbf:
                    counter = rdo.BitCounter()
                    code_hdr(counter, ctx)
                    self._count_leaf(counter, ctx, tu1, mode, depth0=depth0)
                    bits1 = counter.bits >> 15
                    cost1 = sse1 + self.lam * bits1
                    if cost1 < cost0:
                        chosen = (cost1, sse1, bits1, tu1, rec1)
                    else:
                        ctx[:] = post0
                else:
                    ctx[:] = post0
            cost_s, sse_s, bits_s, tu_s, rec_s = chosen
            self._commit_tu(tu_s, rec_s)
            single = (sse_s, bits_s, cost_s, [tu_s])
            if not check_split:
                return single
            state_single = self._save(x, y, size)   # CI_QT_TRAFO_TEST
            ctx_single = ctx.copy()
            self._restore(x, y, size, pre)
            ctx[:] = root_ctx

        # ---- split trial ----
        sse_sp, leaves_sp = 0, []
        for (cx, cy) in quadrants:
            s, _b, _c, l = self._tu_node(cx, cy, half, depth + 1, mode, ctx,
                                         nxn=nxn, check_first=check_first,
                                         hdr=hdr, preds=None)
            sse_sp += s
            leaves_sp += l
        # One truncation over header + the whole decided subtree, counted
        # from the node-root state (TEncSearch.cpp:1706-1712).
        ctx[:] = root_ctx
        counter = rdo.BitCounter()
        code_hdr(counter, ctx)
        self._count_subtree(counter, ctx, x, y, size, depth,
                            {(t.x, t.y, t.n): t for t in leaves_sp}, mode,
                            nxn=nxn)
        bits_sp = counter.bits >> 15
        cost_sp = sse_sp + self.lam * bits_sp

        if single is not None and cost_sp >= single[2]:
            # Single wins (split must beat it strictly, TEncSearch.cpp:1715).
            self._restore(x, y, size, state_single)
            ctx[:] = ctx_single
            return single
        return sse_sp, bits_sp, cost_sp, leaves_sp

    # ---------------------------------------------------------- PU search --

    def _search_pu(self, x, y, n, *, cu_pos, cu_ctx, nxn: bool = False):
        """Mode decision for one PU (estIntraPredLumaQT per-PU analog).

        Every candidate trial starts from `cu_ctx`, the context state at CU
        entry (HM loads CI_CURR_BEST per candidate, TEncSearch.cpp:2469 -
        even for later PUs of an NxN CU).  Two-stage TU search per
        HHI_RQT_INTRA_SPEEDUP.  Commits the winner; returns (PuRecord, sse).
        """
        mpms = self._mpms(x, y)
        preds, flags = self._predict_modes(x, y, n)
        orig = self.frame[y:y + n, x:x + n]
        resi = preds - orig[None]
        satd = rdo.satd(resi.astype(np.int32))
        n_modes = preds.shape[0]
        # Fast pass: SATD + sqrtLambda * floor(mode bits) (xModeBitsIntra
        # truncates to integer bits).
        fast_costs = np.empty(n_modes)
        for m in range(n_modes):
            counter = rdo.BitCounter()
            scratch = cu_ctx.copy()
            self._encode_mode_bits(counter, scratch,
                                   m if m < 35 else PNNS_MODE, mpms)
            fast_costs[m] = (float(satd[m])
                             + self.sqrt_lam * float(counter.bits >> 15))

        k = self.n_candidates[n]
        order = np.argsort(fast_costs, kind="stable")
        candidates = list(order[:k])
        for m in mpms:
            if m not in candidates:
                candidates.append(m)
        if self.policy == "switch" and (n_modes - 1) not in candidates:
            candidates.append(n_modes - 1)  # force-include PNNS in full RD

        # part_size is syntax only at min-size CUs (callers pass cu_pos for
        # those); the bin rides the counting pass of the node at the CU's
        # top-left, so only PU0 of an NxN CU carries it.
        if cu_pos is not None and (x, y) == cu_pos:
            part_size_bin = 0 if nxn else 1
        else:
            part_size_bin = None
        ps_pos = cu_pos if cu_pos is not None else (x, y)

        pre = self._save(x, y, n)
        best = None
        hdr = (part_size_bin, ps_pos, (x, y), mpms)
        for m in candidates:
            mode = (PNNS_MODE if (self.policy == "switch"
                                  and m == n_modes - 1) else int(m))
            ctx = cu_ctx.copy()
            sse, bits, cost, leaves = self._tu_node(
                x, y, n, 0, mode, ctx, nxn=nxn, check_first=True, hdr=hdr,
                preds=preds)
            if best is None or cost < best[0]:
                best = (cost, mode, sse, leaves, self._save(x, y, n))
            self._restore(x, y, n, pre)
        # Second pass: full TU-split search for the winning mode only.
        if n > 4:
            mode = best[1]
            ctx = cu_ctx.copy()
            sse, bits, cost, leaves = self._tu_node(
                x, y, n, 0, mode, ctx, nxn=nxn, check_first=False, hdr=hdr,
                preds=preds)
            if cost < best[0]:
                best = (cost, mode, sse, leaves, self._save(x, y, n))
            self._restore(x, y, n, pre)
        # Commit the winner.
        self._restore(x, y, n, best[4])
        self.mode_map[y // 4:(y + n) // 4, x // 4:(x + n) // 4] = best[1]
        return PuRecord(x, y, n, best[1], tus=best[3]), best[2]

    # ---------------------------------------------------------- CU search --

    def _count_cu(self, ctx, node: CuNode) -> int:
        """One truncated count over the complete CU syntax (the
        xCheckRDCostIntra whole-CU accounting); mutates `ctx` like HM's
        CI_TEMP_BEST/CI_NEXT_BEST chain."""
        counter = rdo.BitCounter()
        if node.size == MIN_CU:
            counter.encode_bin(0 if node.part_nxn else 1, ctx,
                               OFFSETS.part_size)
        for pu in node.pus:
            mpms = self._mpms(pu.x, pu.y)
            self._encode_mode_bits(counter, ctx, pu.mode, mpms)
        for pu in node.pus:
            leaves = {(t.x, t.y, t.n): t for t in pu.tus}
            self._count_subtree(counter, ctx, pu.x, pu.y, pu.n, 0, leaves,
                                pu.mode, nxn=node.part_nxn)
        return counter.bits >> 15

    def _compress_leaf(self, x, y, size, depth):
        """Leaf CU: 2Nx2N PU (and NxN alternative at the minimum CU size).

        Commits the winner incl. `self.est_ctx` (the post-count state) and
        returns (bits_int, sse, node)."""
        cu_ctx = self.est_ctx.copy()               # CI_CURR_BEST
        pre = self._save(x, y, size)
        node = CuNode(x, y, size, depth, split=False)
        cu_pos = (x, y) if size == MIN_CU else None
        pu, sse2n = self._search_pu(x, y, size, cu_pos=cu_pos, cu_ctx=cu_ctx)
        node.pus = [pu]
        ctx2n = cu_ctx.copy()
        bits2n = self._count_cu(ctx2n, node)
        cost2n = sse2n + self.lam * bits2n
        best = (bits2n, sse2n, node, self._save(x, y, size), ctx2n)
        best_cost = cost2n

        if size == MIN_CU and size > 4:
            self._restore(x, y, size, pre)
            node_n = CuNode(x, y, size, depth, split=False, part_nxn=True)
            sse_n = 0
            for (px, py) in ((x, y), (x + 4, y), (x, y + 4), (x + 4, y + 4)):
                pu_k, s_k = self._search_pu(px, py, 4, cu_pos=(x, y),
                                            cu_ctx=cu_ctx, nxn=True)
                node_n.pus.append(pu_k)
                sse_n += s_k
            ctx_n = cu_ctx.copy()
            bits_n = self._count_cu(ctx_n, node_n)
            cost_n = sse_n + self.lam * bits_n
            # NxN replaces 2Nx2N only strictly (xCheckBestMode).
            if cost_n < best_cost:
                best = (bits_n, sse_n, node_n, self._save(x, y, size), ctx_n)
                best_cost = cost_n

        self._restore(x, y, size, best[3])
        self.est_ctx = best[4]
        self._commit_depth(x, y, size, depth)
        return best[0], best[1], best[2]

    def compress_cu(self, x, y, size, depth):
        """Returns (bits_int, sse, cost, CuNode or None); commits the winner.

        Bit totals are integers accumulated exactly as HM's
        TotalBits/TotalCost chain: whole-CU count, then split-flag bits with
        their own truncation; split children sum their own totals."""
        if x >= self.w or y >= self.h:
            return 0, 0, 0.0, None
        inside = x + size <= self.w and y + size <= self.h
        can_split = size > MIN_CU
        node = CuNode(x, y, size, depth, split=False)
        ctx_entry = self.est_ctx.copy()
        ch = self.chroma_rdo
        ch_ctx_entry = ch.est_ctx.copy() if ch is not None else None

        whole = None
        if inside:
            pre = self._save(x, y, size)
            bits_w, sse_w, node_w = self._compress_leaf(x, y, size, depth)
            if ch is not None:
                # HM folds the CU's best chroma mode into the same RD trial
                # (xCheckRDCostIntra -> estIntraPredChromaQT); distortion is
                # weighted by 2^((qp - qp_chroma)/3), HM's chroma distortion
                # weight.  Accumulated into (sse, bits) so parent-level
                # split sums carry it too.
                ch_sse, ch_fbits = ch.encode_cu(node_w)
                sse_w = sse_w + ch.dist_weight * ch_sse
                bits_w = bits_w + ch_fbits
            if can_split:
                # Split-flag bits appended to the whole option
                # (TEncCu.cpp:795-805; the count mutates NEXT_BEST).
                c = rdo.BitCounter()
                c.encode_bin(0, self.est_ctx,
                             OFFSETS.split_cu + self._split_ctx(x, y, depth))
                bits_w += c.bits >> 15
            cost_w = sse_w + self.lam * bits_w
            whole = (bits_w, sse_w, cost_w, node_w,
                     self._save(x, y, size), self.est_ctx,
                     ch.est_ctx if ch is not None else None)
            if not can_split:
                return bits_w, sse_w, cost_w, node_w
            self._restore(x, y, size, pre)
            self.est_ctx = ctx_entry.copy()
            if ch is not None:
                ch.est_ctx = ch_ctx_entry.copy()

        # Split branch.
        bits_s, sse_s = 0, 0
        children = []
        half = size // 2
        for (cx, cy) in ((x, y), (x + half, y), (x, y + half),
                         (x + half, y + half)):
            b, s, _c, child = self.compress_cu(cx, cy, half, depth + 1)
            bits_s += b
            sse_s += s
            children.append(child)
        if inside:
            c = rdo.BitCounter()
            c.encode_bin(1, self.est_ctx,
                         OFFSETS.split_cu + self._split_ctx(x, y, depth))
            bits_s += c.bits >> 15
        cost_s = sse_s + self.lam * bits_s
        if whole is None or cost_s < whole[2]:
            node.split = True
            node.children = children
            return bits_s, sse_s, cost_s, node
        self._restore(x, y, size, whole[4])
        self.est_ctx = whole[5]
        if ch is not None:
            ch.est_ctx = whole[6]
        return whole[0], whole[1], whole[2], whole[3]

    def _commit_depth(self, x, y, size, depth):
        self.depth_map[y // 4:(y + size) // 4, x // 4:(x + size) // 4] = depth

    # ------------------------------------------------------------ encode ---

    def encode(self) -> EncodeResult:
        trees = []
        for cy in range(0, self.h, self.ctu):
            for cx in range(0, self.w, self.ctu):
                _bits, _sse, _cost, node = self.compress_cu(cx, cy, self.ctu, 0)
                trees.append(node)
        if self.deblocking:
            final = deblock.deblock_luma(self.recon.astype(np.uint8),
                                         self.tu_map, self.qp)
        else:
            final = self.recon.astype(np.uint8)
        sao_grid = None
        if self.sao:
            sao_grid = sao_mod.estimate_frame(
                self.frame.astype(np.uint8), final, self.ctu, self.lam)
            final = sao_mod.apply_sao(final, sao_grid, self.ctu)
        self._sao_grid = sao_grid
        bitstream = self._serialize(trees)
        return EncodeResult(
            bitstream=bitstream,
            reconstruction=final,
            num_bits=len(bitstream) * 8,
            ctu_trees=trees,
            mode_map=self.mode_map.copy(),
            qp=self.qp,
            policy=self.policy,
        )

    # -------------------------------------------------------- serialization

    def _serialize(self, trees) -> bytes:
        return serialize_trees(trees, width=self.w, height=self.h, qp=self.qp,
                               policy=self.policy, ctu_size=self.ctu,
                               sign_hiding=self.sign_hiding,
                               deblocking=self.deblocking,
                               max_tu_depth=self.max_tu_depth,
                               sao_grid=self._sao_grid,
                               transform_skip=self.transform_skip)


def serialize_trees(trees, *, width: int, height: int, qp: int, policy: str,
                    ctu_size: int, sign_hiding: bool,
                    deblocking: bool = False, max_tu_depth: int = 0,
                    sao_grid=None, transform_skip: bool = False) -> bytes:
    """Real CABAC pass over decided CU trees -> framework bitstream.

    Shared by the RDO encoder and the wavefront (fixed-grid) encoder.
    """
    header = stream_header(width=width, height=height, qp=qp, policy=policy,
                           ctu_size=ctu_size, sign_hiding=sign_hiding,
                           deblocking=deblocking, max_tu_depth=max_tu_depth,
                           has_sao=sao_grid is not None,
                           transform_skip=transform_skip)
    enc = cabac.CabacEncoder()
    ctx = make_context_states(qp)
    uh, uw = height // 4, width // 4
    mode_map = np.full((uh, uw), -1, dtype=np.int32)
    depth_map = np.zeros((uh, uw), dtype=np.int32)
    coded = np.zeros((uh, uw), dtype=bool)

    def split_ctx(x, y, depth):
        c = 0
        ux, uy = x // 4, y // 4
        if x > 0 and coded[uy, ux - 1]:
            c += 1 if depth_map[uy, ux - 1] > depth else 0
        if y > 0 and coded[uy - 1, ux]:
            c += 1 if depth_map[uy - 1, ux] > depth else 0
        return c

    def mpms_at(x, y):
        def nb(left):
            if left:
                nx, ny = x - 1, y
            else:
                nx, ny = x, y - 1
                if y % ctu_size == 0:
                    return syntax.DC_IDX
            if nx < 0 or ny < 0:
                return syntax.DC_IDX
            m = int(mode_map[ny // 4, nx // 4])
            return m if m >= 0 else syntax.DC_IDX
        left, above = nb(True), nb(False)
        if policy == "switch":
            return mpms_switch(left, above)
        return syntax.mpm_candidates(left, above)

    def ser_cu(node):
        if node is None:
            return
        x, y, size, depth = node.x, node.y, node.size, node.depth
        inside = x + size <= width and y + size <= height
        if size > MIN_CU and inside:
            enc.encode_bin(1 if node.split else 0, ctx,
                           OFFSETS.split_cu + split_ctx(x, y, depth))
        if node.split:
            for child in node.children:
                ser_cu(child)
            return
        if size == MIN_CU:
            enc.encode_bin(0 if node.part_nxn else 1, ctx, OFFSETS.part_size)
        for pu in node.pus:
            mpms = mpms_at(pu.x, pu.y)
            if policy == "switch":
                enc.encode_bin(1 if pu.mode == PNNS_MODE else 0, ctx,
                               OFFSETS.pnns_flag)
                if pu.mode != PNNS_MODE:
                    syntax.encode_intra_mode(enc, ctx, pu.mode, mpms)
            else:
                syntax.encode_intra_mode(enc, ctx, pu.mode, mpms)
            mode_map[pu.y // 4:(pu.y + pu.n) // 4,
                     pu.x // 4:(pu.x + pu.n) // 4] = pu.mode
            leaves = {(tu.x, tu.y, tu.n): tu for tu in pu.tus}

            def ser_tus(tx, ty, tsize, tdepth):
                forced = tsize > MAX_TU
                half = tsize // 2
                if forced:
                    for (cx, cy) in ((tx, ty), (tx + half, ty),
                                     (tx, ty + half), (tx + half, ty + half)):
                        ser_tus(cx, cy, half, tdepth + 1)
                    return
                leaf = leaves.get((tx, ty, tsize))
                if tsize > 4 and tdepth < max_tu_depth:
                    flag_ctx = OFFSETS.trans_subdiv + (5 - (tsize.bit_length() - 1))
                    enc.encode_bin(0 if leaf is not None else 1, ctx, flag_ctx)
                if leaf is None:
                    for (cx, cy) in ((tx, ty), (tx + half, ty),
                                     (tx, ty + half), (tx + half, ty + half)):
                        ser_tus(cx, cy, half, tdepth + 1)
                    return
                enc.encode_bin(leaf.cbf, ctx,
                               OFFSETS.cbf_luma + (1 if tdepth == 0 else 0))
                if leaf.cbf:
                    if transform_skip and leaf.n == 4:
                        enc.encode_bin(leaf.tskip, ctx, OFFSETS.transform_skip)
                    syntax.encode_coefficients(
                        enc, ctx, leaf.coeffs,
                        pu.mode if pu.mode != PNNS_MODE else 0, sign_hiding)

            # NxN PUs are quadrants of the CU-level transform tree: their TUs
            # sit at trafo depth 1 (cbf_luma context 0), like the HM layout.
            ser_tus(pu.x, pu.y, pu.n, 1 if node.part_nxn else 0)
        depth_map[y // 4:(y + size) // 4, x // 4:(x + size) // 4] = depth
        coded[y // 4:(y + size) // 4, x // 4:(x + size) // 4] = True

    for node in trees:
        ser_cu(node)
    if sao_grid is not None:
        sao_mod.encode_params(enc, ctx, sao_grid)
    return header + enc.terminate_and_finish()


def encode_frame(frame_uint8: np.ndarray, qp: int, **kwargs) -> EncodeResult:
    """Encodes one luma frame All-Intra at a fixed QP (`FrameEncoder`; the
    PNN forwards on `device`, "cuda" by default)."""
    return FrameEncoder(frame_uint8, qp, **kwargs).encode()
