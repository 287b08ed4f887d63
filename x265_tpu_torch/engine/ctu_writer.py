"""Serial CABAC finalizer: decision tensors -> slice-data bytes.

This is the encoder half of the split that defines the whole framework
(SURVEY.md §7.1 "split decision-math from bit-math"): all pixel math and
mode decisions happen in batched TPU computation (x265 analog:
Analysis::compressCTU); this writer only *re-derives deterministic state*
(predictions, residuals, reconstruction) and emits syntax (x265 analog:
Entropy::encodeCTU, frameencoder.cpp:1533).

The writer walks the CU quadtree given by the decision maps and must stay
bin-exact with x265_tpu_torch.decoder — both share tables, MPM derivation and
residual syntax helpers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from x265_tpu_torch.hevc.cabac import CabacEncoder
from x265_tpu_torch.hevc.cu_tools import (
    chroma_cand_list, encode_cu_qp_delta, mpm_list,
)
from x265_tpu_torch.hevc.deblock import DeblockState, deblock_frame
from x265_tpu_torch.hevc.headers import (
    PPS, SPS, SliceHeader, SLICE_B, SLICE_I, SLICE_P,
)
from x265_tpu_torch.hevc.inter_tools import (
    InterCtx, Motion, amvp_candidates, encode_mvd, merge_candidates,
    _same_motion,
)
from x265_tpu_torch.hevc.residual import encode_residual
from x265_tpu_torch.hevc.tables import CTX_OFF, SCANS, chroma_qp, coeff_scan_index
from x265_tpu_torch.ops.ref.intra import predict_block, get_ref_samples, predict
from x265_tpu_torch.ops.ref.transform import (
    forward_transform, quantize, dequantize, inverse_transform, rdoq,
    sign_bit_hiding_adjust,
)


@dataclass
class FrameDecisions:
    """Decision tensors from the analysis stage.

    cu_log2_map:  [H/8, W/8] int — log2 size of the chosen CU covering each
                  8x8 luma block (uniform within a CU's footprint).
    luma_mode8:   [H/8, W/8] int — intra mode of the CU covering the block.
    chroma_mode8: optional [H/8, W/8] int — explicit chroma mode per CU, or
                  None for derived (DM) everywhere.
    For P slices additionally:
    inter8:       [H/8, W/8] bool — CU coded inter (MV from mv8).
    mv8:          [H/8, W/8, 2] int — luma MV in quarter-pel units.
    """
    cu_log2_map: np.ndarray
    luma_mode8: np.ndarray
    chroma_mode8: Optional[np.ndarray] = None
    inter8: Optional[np.ndarray] = None
    dir8: Optional[np.ndarray] = None        # 1=L0, 2=L1, 3=BI
    mv8: Optional[np.ndarray] = None         # [h8, w8, 2(list), 2(xy)]
    ref8: Optional[np.ndarray] = None        # [h8, w8] L0 ref idx (multi-ref)
    qp_map: Optional[np.ndarray] = None      # [cty, ctx] per-CTB QP (AQ)
    nxn8: Optional[np.ndarray] = None        # [h8, w8] bool — 8x8 intra CU
    #                                          coded PART_NxN (4x 4x4 PBs)
    luma_mode4: Optional[np.ndarray] = None  # [H/4, W/4] per-PB modes for
    #                                          NxN CUs (falls back to
    #                                          luma_mode8 when None)
    tusplit8: Optional[np.ndarray] = None    # [h8, w8] u8 — inter CU's
    #                                          TU quad-split flag (RQT
    #                                          depth 1; uniform per CU)


def _l0_weight(sh, ref_idx, c_idx):
    """(w, off, denom) for an explicit-weighted L0 ref, else None.

    pred_weight_table semantics, 7.4.7.3 / 8.5.4.2.3.2 (P slices only —
    weighted_bipred is never enabled by this encoder)."""
    if getattr(sh, "slice_type", None) != 1:      # SLICE_P
        return None
    if c_idx == 0:
        lw = getattr(sh, "luma_weights_l0", None)
        if not lw or ref_idx >= len(lw) or lw[ref_idx] is None:
            return None
        w, off = lw[ref_idx]
        return w, off, sh.luma_log2_weight_denom
    cw = getattr(sh, "chroma_weights_l0", None)
    if not cw or ref_idx >= len(cw) or cw[ref_idx] is None:
        return None
    w, off = cw[ref_idx][c_idx - 1]
    return w, off, sh.chroma_log2_weight_denom


class FrameSyntaxWriter:
    def __init__(self, sps: SPS, pps: PPS, sh: SliceHeader, lossless: bool,
                 ref_planes=None, refs=None, ref_poc=((), ()),
                 cur_poc: int = 0, col=None):
        """refs: ([ (y,cb,cr) per L0 ref ], [ per L1 ref ]) reconstructed
        reference planes; ref_poc the matching POC lists; legacy
        ref_planes= keeps the single-L0-reference call shape."""
        self.sps, self.pps, self.sh = sps, pps, sh
        self.lossless = lossless
        self.rdoq_level = 0          # set by the encoder (x265 --rdoq-level)
        self.psy_fx = 0              # Q8 psy-rdoq strength (luma RDOQ)
        # scaling lists (--scaling-list; 7.4.5): per-(size, intra, plane)
        # m matrices for quant/dequant, None = flat 16
        self._sm_cache = {}
        # transform skip (--tskip; 7.3.8.11 transform_skip_flag, 4x4 TBs
        # only): per-TB decisions recorded here by the coeff functions,
        # read back by the residual emitters
        self.tskip = bool(getattr(pps, "transform_skip_enabled", False))
        self._tsmap = {}
        self.bd = sps.bit_depth
        self.qp_y = sh.qp
        self.cur_poc = cur_poc
        if ref_planes is not None and refs is None:
            refs = ([ref_planes], [])
            ref_poc = ((max(0, cur_poc - 1),), ())
        self.ref_poc = ref_poc
        self.nr = None     # (offsets u16[16,1024], sums u32, counts u32)
        # collocated motion (TMVP); active only when the slice header
        # says so (8.5.3.2.7)
        self.col = col if getattr(sh, "temporal_mvp_enabled", False) else None
        self.pad = 80
        self.ref_pad = ([], [])
        if refs is not None:
            for lx in (0, 1):
                for planes in refs[lx]:
                    self.ref_pad[lx].append(tuple(
                        np.pad(planes[i].astype(np.int32),
                               self.pad >> (0 if i == 0 else 1), mode="edge")
                        for i in range(3)))

    def encode_slice_data(self, src_y: np.ndarray, src_cb: np.ndarray,
                          src_cr: np.ndarray, dec: FrameDecisions,
                          sao_params=None) -> bytes:
        sps = self.sps
        h, w = sps.height, sps.width
        self.dec = dec
        self.sao_params = sao_params
        # reconstruction state (lossless => recon == source, but we keep the
        # full loop so the CQP path works identically)
        self.y = np.zeros((h, w), dtype=np.int32)
        self.cb = np.zeros((h // 2, w // 2), dtype=np.int32)
        self.cr = np.zeros((h // 2, w // 2), dtype=np.int32)
        self.src = {0: src_y.astype(np.int32), 1: src_cb.astype(np.int32),
                    2: src_cr.astype(np.int32)}
        h4, w4 = (h + 3) // 4, (w + 3) // 4
        self.avail4 = np.zeros((h4, w4), dtype=bool)
        self.intra_mode4 = np.full((h4, w4), -1, dtype=np.int32)
        self.is_intra4 = np.zeros((h4, w4), dtype=bool)
        self.depth4 = np.zeros((h4, w4), dtype=np.int32)

        self.ic = InterCtx(h, w)
        self.dbs = DeblockState(h, w)
        cab = CabacEncoder()
        cab.init_slice({SLICE_I: 0, SLICE_P: 1, SLICE_B: 2}[self.sh.slice_type],
                       self.sh.qp)
        self.cab = cab

        # per-CU QP state (QG == CTB: qPY_PRED == previous QG's QP, 8.6.1)
        self.dqp_on = (self.pps.cu_qp_delta_enabled and
                       dec.qp_map is not None)
        self.qp_prev = self.sh.qp
        h4w, w4w = self.avail4.shape
        self.qp4 = np.full((h4w, w4w), self.sh.qp, dtype=np.int32)

        ctb = sps.ctb_size
        wc = sps.pic_width_in_ctbs
        n_ctbs = wc * sps.pic_height_in_ctbs
        # WPP (entropy_coding_sync, 7.3.8.1 + 9.3.1): per-CTU-row
        # byte-aligned substreams, contexts synced from the snapshot
        # after the second CTU of the row above (x265 entropy.cpp:724,
        # frameencoder.cpp:1033 serializeSubstreams analog)
        wpp = bool(self.pps.entropy_coding_sync_enabled)
        init_type = {SLICE_I: 0, SLICE_P: 1,
                     SLICE_B: 2}[self.sh.slice_type]
        wpp_snap = None
        parts = []
        self.substream_parts = None
        for addr in range(n_ctbs):
            cx_i = addr % wc
            cy_i = addr // wc
            x0, y0 = cx_i * ctb, cy_i * ctb
            if wpp and cx_i == 0 and addr > 0:
                # row start: fresh engine, ctx from the row-above snapshot
                cab.reset_engine()
                if wc > 1 and wpp_snap is not None:
                    cab.ctx = wpp_snap.copy()
                else:
                    from x265_tpu_torch.hevc.cabac import init_contexts
                    cab.ctx = init_contexts(init_type, self.sh.qp)
                # 8.6.1: qPY_PREV resets to SliceQpY each CTB row
                self.qp_prev = self.sh.qp
            if self.dqp_on:
                self.qg_wanted = int(dec.qp_map[cy_i, cx_i])
                self.qg_coded = False
                self.qp_y = self.qg_wanted      # quantize with the target
            if self.sao_params is not None and (self.sh.sao_luma or
                                                self.sh.sao_chroma):
                from x265_tpu_torch.hevc.sao import write_sao_ctu
                write_sao_ctu(cab, CTX_OFF, self.sao_params, cy_i, cx_i,
                              self.sh.sao_luma, self.sh.sao_chroma, self.bd)
            self._coding_quadtree(x0, y0, sps.ctb_log2, 0)
            if self.dqp_on:
                # qPY_PREV for the next QG = QP of the last CU of this one
                self.qp_prev = (self.qg_wanted if self.qg_coded
                                else self.qp_prev)
            if wpp and cx_i == 1:
                wpp_snap = cab.ctx.copy()
            cab.encode_bin_trm(1 if addr == n_ctbs - 1 else 0)
            if wpp and cx_i == wc - 1 and addr != n_ctbs - 1:
                # end of substream: end_of_subset_one_bit + flush/align
                cab.encode_bin_trm(1)
                parts.append(cab.finish())
        parts.append(cab.finish())
        if wpp:
            self.substream_parts = parts
        return b"".join(parts)

    # ---- quadtree ----

    def _coding_quadtree(self, x0, y0, log2_cb, depth) -> None:
        sps = self.sps
        size = 1 << log2_cb
        inside = x0 + size <= sps.width and y0 + size <= sps.height
        want_split = int(self.dec.cu_log2_map[y0 >> 3, x0 >> 3]) < log2_cb
        if inside and log2_cb > sps.log2_min_cb:
            ctx = CTX_OFF["split_cu"] + self._split_ctx(x0, y0, depth)
            self.cab.encode_bin(ctx, 1 if want_split else 0)
            split = want_split
        else:
            split = log2_cb > sps.log2_min_cb
        if split:
            half = size >> 1
            for (dx, dy) in ((0, 0), (half, 0), (0, half), (half, half)):
                x1, y1 = x0 + dx, y0 + dy
                if x1 < sps.width and y1 < sps.height:
                    self._coding_quadtree(x1, y1, log2_cb - 1, depth + 1)
        else:
            self._coding_unit(x0, y0, log2_cb, depth)
            if self.dqp_on:
                # per-CU QpY (8.6.1): CUs before the QG's delta keep the
                # prediction; the delta-bearing CU and later ones get it
                cuqp = self.qg_wanted if self.qg_coded else self.qp_prev
                self.qp4[y0 >> 2:(y0 + size) >> 2,
                         x0 >> 2:(x0 + size) >> 2] = cuqp

    def _split_ctx(self, x0, y0, depth) -> int:
        ctx = 0
        if x0 > 0 and self.avail4[y0 >> 2, (x0 - 1) >> 2]:
            ctx += 1 if self.depth4[y0 >> 2, (x0 - 1) >> 2] > depth else 0
        if y0 > 0 and self.avail4[(y0 - 1) >> 2, x0 >> 2]:
            ctx += 1 if self.depth4[(y0 - 1) >> 2, x0 >> 2] > depth else 0
        return ctx

    # ---- coding unit ----

    def _coding_unit(self, x0, y0, log2_cb, depth) -> None:
        sps, pps, cab = self.sps, self.pps, self.cab
        size = 1 << log2_cb
        p_slice = self.sh.slice_type in (SLICE_P, SLICE_B)
        is_inter = (p_slice and self.dec.inter8 is not None and
                    bool(self.dec.inter8[y0 >> 3, x0 >> 3]))

        if pps.transquant_bypass_enabled:
            cab.encode_bin(CTX_OFF["cu_transquant_bypass"],
                           1 if self.lossless else 0)
        if p_slice:
            if is_inter:
                self._inter_cu(x0, y0, log2_cb, depth)
                return
            # cu_skip_flag = 0, then pred_mode = intra
            self._encode_skip_flag(x0, y0, 0)
            cab.encode_bin(CTX_OFF["pred_mode"], 1)
        if log2_cb == sps.log2_min_cb:
            nxn = self._want_nxn(x0, y0, log2_cb)
            cab.encode_bin(CTX_OFF["part_mode"], 0 if nxn else 1)
            if nxn:
                self._intra_nxn_cu(x0, y0, log2_cb, depth)
                return

        mode = int(self.dec.luma_mode8[y0 >> 3, x0 >> 3])
        cands = mpm_list(self.intra_mode4, self.is_intra4, self.avail4,
                         x0, y0, sps.ctb_size)
        if mode in cands:
            idx = cands.index(mode)
            cab.encode_bin(CTX_OFF["prev_intra_luma_pred"], 1)
            if idx == 0:
                cab.encode_bin_ep(0)
            else:
                cab.encode_bin_ep(1)
                cab.encode_bin_ep(idx - 1)
        else:
            cab.encode_bin(CTX_OFF["prev_intra_luma_pred"], 0)
            rem = mode
            for c in sorted(cands, reverse=True):
                if rem > c:
                    rem -= 1
            cab.encode_bins_ep(rem, 5)

        self.intra_mode4[y0 >> 2:(y0 + size) >> 2, x0 >> 2:(x0 + size) >> 2] = mode
        self.is_intra4[y0 >> 2:(y0 + size) >> 2, x0 >> 2:(x0 + size) >> 2] = True
        self.depth4[y0 >> 2:(y0 + size) >> 2, x0 >> 2:(x0 + size) >> 2] = depth

        # chroma mode: DM (derived) or explicit from decisions
        chroma_mode = mode
        if self.dec.chroma_mode8 is not None:
            cm = int(self.dec.chroma_mode8[y0 >> 3, x0 >> 3])
            if cm == mode:
                cab.encode_bin(CTX_OFF["intra_chroma_pred"], 0)
            else:
                cand = chroma_cand_list(mode)
                idx = cand.index(cm)
                cab.encode_bin(CTX_OFF["intra_chroma_pred"], 1)
                cab.encode_bins_ep(idx, 2)
                chroma_mode = cm
        else:
            cab.encode_bin(CTX_OFF["intra_chroma_pred"], 0)

        # transform tree: TU == CU (max hierarchy depth 0, 2Nx2N)
        self._transform_tree_leaf(x0, y0, log2_cb, mode, chroma_mode)

    def _want_nxn(self, x0, y0, log2_cb) -> bool:
        """PART_NxN decision for a min-size intra CU (only 8x8 CUs: the
        x265 analog codes NxN at the minimum CU size, analysis.cpp
        checkIntra PART_NxN; our quadtree's min CU is 8)."""
        if log2_cb != 3:
            return False
        if getattr(self, "force_nxn", False):
            return True
        nxn8 = getattr(self.dec, "nxn8", None)
        return nxn8 is not None and bool(nxn8[y0 >> 3, x0 >> 3])

    def _nxn_modes(self, x0, y0) -> list:
        """Per-PB (4x4) luma modes for an 8x8 NxN CU."""
        m4 = getattr(self.dec, "luma_mode4", None)
        if m4 is not None:
            return [int(m4[(y0 + dy) >> 2, (x0 + dx) >> 2])
                    for (dx, dy) in ((0, 0), (4, 0), (0, 4), (4, 4))]
        return [int(self.dec.luma_mode8[y0 >> 3, x0 >> 3])] * 4

    def _intra_nxn_cu(self, x0, y0, log2_cb, depth) -> None:
        """PART_NxN intra 8x8 CU: four 4x4 PBs/TBs (7.3.8.5 two-loop mode
        syntax; forced RQT split at trafoDepth 0, 7.3.8.8). MPM candidate
        lists use z-scan (parse-order) availability, so earlier PBs of
        this same CU are candidates for later ones."""
        sps, cab = self.sps, self.cab
        modes = self._nxn_modes(x0, y0)
        offs = ((0, 0), (4, 0), (0, 4), (4, 4))
        # candidate lists: sequential, seeing earlier PBs' modes
        im4 = self.intra_mode4
        ii4 = self.is_intra4
        cands_per = []
        for i, (dx, dy) in enumerate(offs):
            cands_per.append(mpm_list(im4, ii4, self.avail4,
                                      x0 + dx, y0 + dy, sps.ctb_size))
            im4[(y0 + dy) >> 2, (x0 + dx) >> 2] = modes[i]
            ii4[(y0 + dy) >> 2, (x0 + dx) >> 2] = True
            self.avail4[(y0 + dy) >> 2, (x0 + dx) >> 2] = True
        # loop 1: the four prev_intra_luma_pred flags
        for i in range(4):
            cab.encode_bin(CTX_OFF["prev_intra_luma_pred"],
                           1 if modes[i] in cands_per[i] else 0)
        # loop 2: mpm_idx / rem_intra_luma_pred_mode
        for i in range(4):
            cands = cands_per[i]
            if modes[i] in cands:
                idx = cands.index(modes[i])
                if idx == 0:
                    cab.encode_bin_ep(0)
                else:
                    cab.encode_bin_ep(1)
                    cab.encode_bin_ep(idx - 1)
            else:
                rem = modes[i]
                for c in sorted(cands, reverse=True):
                    if rem > c:
                        rem -= 1
                cab.encode_bins_ep(rem, 5)
        self.depth4[y0 >> 2:(y0 + 8) >> 2, x0 >> 2:(x0 + 8) >> 2] = depth
        # availability was set optimistically for the mode loop above;
        # real sample availability is restored per-TB below
        for (dx, dy) in offs:
            self.avail4[(y0 + dy) >> 2, (x0 + dx) >> 2] = False

        # chroma mode (DM or explicit), derived from PB0's mode (8.4.3)
        chroma_mode = modes[0]
        if self.dec.chroma_mode8 is not None:
            cm = int(self.dec.chroma_mode8[y0 >> 3, x0 >> 3])
            if cm == modes[0]:
                cab.encode_bin(CTX_OFF["intra_chroma_pred"], 0)
            else:
                cand = chroma_cand_list(modes[0])
                cab.encode_bin(CTX_OFF["intra_chroma_pred"], 1)
                cab.encode_bins_ep(cand.index(cm), 2)
                chroma_mode = cm
        else:
            cab.encode_bin(CTX_OFF["intra_chroma_pred"], 0)

        # ---- transform tree: forced split at depth 0 ----
        # chroma TB (4x4 at CU level) is predictable upfront: its refs
        # lie outside the CU
        cb_coeff, cb_resi = self._tb_coeffs(1, x0 >> 1, y0 >> 1, 2,
                                            chroma_mode)
        cr_coeff, cr_resi = self._tb_coeffs(2, x0 >> 1, y0 >> 1, 2,
                                            chroma_mode)
        cbf_cb = 1 if np.any(cb_coeff) else 0
        cbf_cr = 1 if np.any(cr_coeff) else 0
        cab.encode_bin(CTX_OFF["cbf_chroma"] + 0, cbf_cb)
        cab.encode_bin(CTX_OFF["cbf_chroma"] + 0, cbf_cr)
        pps = self.pps
        self.dbs.mark_block(x0, y0, 8)
        for i, (dx, dy) in enumerate(offs):
            xb, yb = x0 + dx, y0 + dy
            # luma TB i: predict from reconstructed neighbours (earlier
            # PBs of this CU included), code cbf + residual, reconstruct
            y_coeff, y_resi = self._tb_coeffs(0, xb, yb, 2, modes[i])
            cbf_luma = 1 if np.any(y_coeff) else 0
            self.dbs.set_tu(xb, yb, 4, bool(cbf_luma), self.lossless)
            cab.encode_bin(CTX_OFF["cbf_luma"] + 0, cbf_luma)  # depth 1
            self._maybe_code_dqp(bool(cbf_luma or cbf_cb or cbf_cr))
            if cbf_luma:
                scan = coeff_scan_index(2, 0, modes[i], True)
                encode_residual(cab, y_coeff, 2, 0, scan,
                                sign_hiding=pps.sign_data_hiding,
                                transquant_bypass=self.lossless,
                                transform_skip=self._ts_arg(0, xb, yb, 2))
            self._reconstruct(0, xb, yb, 2, modes[i], y_resi)
            self.avail4[yb >> 2, xb >> 2] = True
            if i == 3:
                # chroma residual rides the last child TU (7.3.8.10)
                if cbf_cb:
                    scan = coeff_scan_index(2, 1, chroma_mode, True)
                    encode_residual(cab, cb_coeff, 2, 1, scan,
                                    sign_hiding=pps.sign_data_hiding,
                                    transquant_bypass=self.lossless,
                                    transform_skip=self._ts_arg(
                                        1, x0 >> 1, y0 >> 1, 2))
                if cbf_cr:
                    scan = coeff_scan_index(2, 2, chroma_mode, True)
                    encode_residual(cab, cr_coeff, 2, 2, scan,
                                    sign_hiding=pps.sign_data_hiding,
                                    transquant_bypass=self.lossless,
                                    transform_skip=self._ts_arg(
                                        2, x0 >> 1, y0 >> 1, 2))
                self._reconstruct(1, x0 >> 1, y0 >> 1, 2, chroma_mode,
                                  cb_resi)
                self._reconstruct(2, x0 >> 1, y0 >> 1, 2, chroma_mode,
                                  cr_resi)

    def _transform_tree_leaf(self, x0, y0, log2_tb, mode, chroma_mode=None) -> None:
        """Single-TU transform tree (split inferred 0; max TB >= CU size)."""
        if chroma_mode is None:
            chroma_mode = mode
        sps, cab = self.sps, self.cab
        max_tb = sps.log2_min_tb + sps.log2_diff_max_min_tb
        assert log2_tb <= max_tb, "CU larger than max TB needs RQT split"
        # no split_transform_flag (MaxTrafoDepth intra == 0 => not present)
        nt = 1 << log2_tb

        # compute chroma first (cbf_cb/cr are coded before cbf_luma)
        cb_coeff, cb_resi = self._tb_coeffs(1, x0 >> 1, y0 >> 1, log2_tb - 1, chroma_mode)
        cr_coeff, cr_resi = self._tb_coeffs(2, x0 >> 1, y0 >> 1, log2_tb - 1, chroma_mode)
        y_coeff, y_resi = self._tb_coeffs(0, x0, y0, log2_tb, mode)
        cbf_cb = 1 if np.any(cb_coeff) else 0
        cbf_cr = 1 if np.any(cr_coeff) else 0
        cbf_luma = 1 if np.any(y_coeff) else 0
        self.dbs.mark_block(x0, y0, nt)
        self.dbs.set_tu(x0, y0, nt, bool(cbf_luma), self.lossless)

        cab.encode_bin(CTX_OFF["cbf_chroma"] + 0, cbf_cb)
        cab.encode_bin(CTX_OFF["cbf_chroma"] + 0, cbf_cr)
        cab.encode_bin(CTX_OFF["cbf_luma"] + 1, cbf_luma)
        self._maybe_code_dqp(bool(cbf_luma or cbf_cb or cbf_cr))

        pps = self.pps
        if cbf_luma:
            scan = coeff_scan_index(log2_tb, 0, mode, True)
            encode_residual(cab, y_coeff, log2_tb, 0, scan,
                            sign_hiding=pps.sign_data_hiding,
                            transquant_bypass=self.lossless)
        if cbf_cb:
            scan = coeff_scan_index(log2_tb - 1, 1, chroma_mode, True)
            encode_residual(cab, cb_coeff, log2_tb - 1, 1, scan,
                            sign_hiding=pps.sign_data_hiding,
                            transquant_bypass=self.lossless,
                            transform_skip=self._ts_arg(
                                1, x0 >> 1, y0 >> 1, log2_tb - 1))
        if cbf_cr:
            scan = coeff_scan_index(log2_tb - 1, 2, chroma_mode, True)
            encode_residual(cab, cr_coeff, log2_tb - 1, 2, scan,
                            sign_hiding=pps.sign_data_hiding,
                            transquant_bypass=self.lossless,
                            transform_skip=self._ts_arg(
                                2, x0 >> 1, y0 >> 1, log2_tb - 1))

        # reconstruct + update availability
        self._reconstruct(0, x0, y0, log2_tb, mode, y_resi)
        self._reconstruct(1, x0 >> 1, y0 >> 1, log2_tb - 1, chroma_mode, cb_resi)
        self._reconstruct(2, x0 >> 1, y0 >> 1, log2_tb - 1, chroma_mode, cr_resi)
        self.avail4[y0 >> 2:(y0 + nt) >> 2, x0 >> 2:(x0 + nt) >> 2] = True

    # ---- inter CU path (P slices) ----

    def _encode_skip_flag(self, x0, y0, val) -> None:
        ctx = 0
        if x0 > 0 and self.avail4[y0 >> 2, (x0 - 1) >> 2]:
            ctx += 1 if self.ic.skip4[y0 >> 2, (x0 - 1) >> 2] else 0
        if y0 > 0 and self.avail4[(y0 - 1) >> 2, x0 >> 2]:
            ctx += 1 if self.ic.skip4[(y0 - 1) >> 2, x0 >> 2] else 0
        self.cab.encode_bin(CTX_OFF["cu_skip"] + ctx, val)

    def _encode_merge_idx(self, idx) -> None:
        cmax = self.sh.max_num_merge_cand - 1
        if cmax == 0:
            return
        self.cab.encode_bin(CTX_OFF["merge_idx"], 1 if idx > 0 else 0)
        if idx > 0:
            for i in range(1, idx):
                self.cab.encode_bin_ep(1)
            if idx < cmax:
                self.cab.encode_bin_ep(0)

    def _mc_pred(self, c_idx, x0, y0, nt, motion):
        """Motion compensation at quarter-pel (luma 8-tap) / eighth-pel
        (chroma 4-tap), uni or bi — spec 8.5.4.2.2-8.5.4.2.3."""
        from x265_tpu_torch.ops.ref.interp import (
            bipred, mc_chroma_14, mc_luma_14, unipred, weighted_unipred)
        dir_, mv0, mv1, r0, r1 = motion

        def one(lx, mv, r):
            ref = self.ref_pad[lx][r][c_idx]
            if c_idx == 0:
                return mc_luma_14(ref, self.pad, x0, y0, nt, nt, mv, self.bd)
            return mc_chroma_14(ref, self.pad >> 1, x0, y0, nt, nt, mv,
                                self.bd)

        if dir_ == 3:
            return bipred(one(0, mv0, r0), one(1, mv1, r1), self.bd)
        if dir_ == 1:
            wp = _l0_weight(self.sh, r0, c_idx)
            if wp is not None:
                return weighted_unipred(one(0, mv0, r0), *wp, self.bd)
            return unipred(one(0, mv0, r0), self.bd)
        return unipred(one(1, mv1, r1), self.bd)

    def _block_motion(self, x0, y0) -> Motion:
        dir_ = (int(self.dec.dir8[y0 >> 3, x0 >> 3])
                if self.dec.dir8 is not None else 1)
        mv8 = self.dec.mv8[y0 >> 3, x0 >> 3]
        if mv8.ndim == 1:      # legacy single-list layout
            mv0 = (int(mv8[0]), int(mv8[1]))
            mv1 = (0, 0)
        else:
            mv0 = (int(mv8[0, 0]), int(mv8[0, 1]))
            mv1 = (int(mv8[1, 0]), int(mv8[1, 1]))
        if not (dir_ & 1):
            mv0 = (0, 0)
        if not (dir_ & 2):
            mv1 = (0, 0)
        r0 = (int(self.dec.ref8[y0 >> 3, x0 >> 3])
              if self.dec.ref8 is not None else 0)
        return (dir_, mv0, mv1, r0 if (dir_ & 1) else -1,
                0 if (dir_ & 2) else -1)

    def _inter_cu(self, x0, y0, log2_cb, depth) -> None:
        sps, pps, cab, sh = self.sps, self.pps, self.cab, self.sh
        size = 1 << log2_cb
        motion = self._block_motion(x0, y0)

        pred_y = self._mc_pred(0, x0, y0, size, motion)
        pred_cb = self._mc_pred(1, x0 >> 1, y0 >> 1, size >> 1, motion)
        pred_cr = self._mc_pred(2, x0 >> 1, y0 >> 1, size >> 1, motion)
        # 64x64 CU: log2TrafoSize 6 > MaxTbLog2SizeY => implicit split
        # into 4 32x32 luma TUs (+16x16 chroma), no split flag bins
        # (7.3.8.8; x265 estimateResidualQT forced split, search.cpp:3178).
        # 16/32 CUs may carry an EXPLICIT depth-1 split from the device
        # RD choice (decisions.tusplit8; x265 tuQTMaxInterDepth 2)
        cu64 = log2_cb == 6
        tusplit = bool(self.dec.tusplit8 is not None and not cu64
                       and log2_cb >= 4
                       and self.dec.tusplit8[y0 >> 3, x0 >> 3])
        split = cu64 or tusplit
        tn = 32 if cu64 else (size >> 1 if tusplit else size)  # luma TB
        tc = tn >> 1
        quads = (((0, 0),) if not split
                 else ((0, 0), (1, 0), (0, 1), (1, 1)))  # z-order (dx,dy)
        lvls = []                           # per quadrant (y, cb, cr)
        y_res = np.zeros((size, size), np.int64)
        cb_res = np.zeros((size >> 1, size >> 1), np.int64)
        cr_res = np.zeros((size >> 1, size >> 1), np.int64)
        tnl2 = tn.bit_length() - 1
        for (dx, dy) in quads:
            py = pred_y[dy * tn:dy * tn + tn, dx * tn:dx * tn + tn]
            pb = pred_cb[dy * tc:dy * tc + tc, dx * tc:dx * tc + tc]
            pr = pred_cr[dy * tc:dy * tc + tc, dx * tc:dx * tc + tc]
            yl, yr = self._coeffs_from_pred(0, x0 + dx * tn, y0 + dy * tn,
                                            tnl2, py, False)
            bl, br = self._coeffs_from_pred(1, (x0 >> 1) + dx * tc,
                                            (y0 >> 1) + dy * tc,
                                            tnl2 - 1, pb, False)
            rl, rr = self._coeffs_from_pred(2, (x0 >> 1) + dx * tc,
                                            (y0 >> 1) + dy * tc,
                                            tnl2 - 1, pr, False)
            lvls.append((yl, bl, rl))
            y_res[dy * tn:dy * tn + tn, dx * tn:dx * tn + tn] = yr
            cb_res[dy * tc:dy * tc + tc, dx * tc:dx * tc + tc] = br
            cr_res[dy * tc:dy * tc + tc, dx * tc:dx * tc + tc] = rr
        qy = [1 if np.any(l[0]) else 0 for l in lvls]
        qcb = [1 if np.any(l[1]) else 0 for l in lvls]
        qcr = [1 if np.any(l[2]) else 0 for l in lvls]
        cbf_y, cbf_cb, cbf_cr = max(qy), max(qcb), max(qcr)
        y_lvl, cb_lvl, cr_lvl = lvls[0]
        all_zero = not (cbf_y or cbf_cb or cbf_cr)

        is_b = sh.slice_type == SLICE_B
        cands = merge_candidates(self.ic, self.avail4, x0, y0, size, size,
                                 sps.width, sps.height,
                                 sh.max_num_merge_cand, sps.ctb_size,
                                 is_b=is_b, ref_poc=self.ref_poc,
                                 col=self.col,
                                 col_from_l0=int(sh.collocated_from_l0),
                                 cur_poc=self.cur_poc)
        merge_idx = next((i for i, c in enumerate(cands)
                          if _same_motion(c, motion)), -1)
        skip = merge_idx >= 0 and all_zero

        self._encode_skip_flag(x0, y0, 1 if skip else 0)
        if skip:
            self._encode_merge_idx(merge_idx)
            self._finish_inter(x0, y0, size, depth, motion, True,
                               pred_y, pred_cb, pred_cr, 0, 0, 0)
            return
        cab.encode_bin(CTX_OFF["pred_mode"], 0)          # inter
        cab.encode_bin(CTX_OFF["part_mode"], 1)          # 2Nx2N
        if merge_idx >= 0:
            cab.encode_bin(CTX_OFF["merge_flag"], 1)
            self._encode_merge_idx(merge_idx)
        else:
            cab.encode_bin(CTX_OFF["merge_flag"], 0)
            dir_ = motion[0]
            if is_b:
                # inter_pred_idc (9.3.3.7): bin0 BI? ctx=CtDepth, bin1 ctx 4
                cab.encode_bin(CTX_OFF["inter_pred_idc"] + depth,
                               1 if dir_ == 3 else 0)
                if dir_ != 3:
                    cab.encode_bin(CTX_OFF["inter_pred_idc"] + 4,
                                   0 if dir_ == 1 else 1)
            nact = (sh.num_ref_idx_l0_active, sh.num_ref_idx_l1_active)
            for lx in (0, 1):
                if not (dir_ & (1 << lx)):
                    continue
                rid = motion[3 + lx]
                if nact[lx] > 1:     # ref_idx: TR, bins 0/1 ctx, rest ep
                    cab.encode_bin(CTX_OFF["ref_idx"], 1 if rid > 0 else 0)
                    if rid > 0:
                        cmax = nact[lx] - 1
                        i = 1
                        while i < cmax and i < rid:
                            if i == 1:
                                cab.encode_bin(CTX_OFF["ref_idx"] + 1, 1)
                            else:
                                cab.encode_bin_ep(1)
                            i += 1
                        if rid < cmax:
                            if rid == 1:
                                cab.encode_bin(CTX_OFF["ref_idx"] + 1, 0)
                            else:
                                cab.encode_bin_ep(0)
                mv = motion[1 + lx]
                amvp = amvp_candidates(self.ic, self.avail4, x0, y0, size,
                                       size, sps.width, sps.height,
                                       lx=lx, ref_idx=rid,
                                       cur_poc=self.cur_poc,
                                       ref_poc=self.ref_poc,
                                       col=self.col,
                                       col_from_l0=int(
                                           sh.collocated_from_l0),
                                       ctb_size=sps.ctb_size)
                costs = [abs(mv[0] - c[0]) + abs(mv[1] - c[1]) for c in amvp]
                mvp_idx = 0 if costs[0] <= costs[1] else 1
                mvd = (mv[0] - amvp[mvp_idx][0], mv[1] - amvp[mvp_idx][1])
                encode_mvd(cab, CTX_OFF["mvd"], mvd[0], mvd[1])
                cab.encode_bin(CTX_OFF["mvp_flag"], mvp_idx)
        if merge_idx < 0:
            cab.encode_bin(CTX_OFF["rqt_root_cbf"], 0 if all_zero else 1)
            if all_zero:
                self._finish_inter(x0, y0, size, depth, motion, False,
                                   pred_y, pred_cb, pred_cr, 0, 0, 0)
                return
        sdh = pps.sign_data_hiding
        # split_transform_flag (7.3.8.8): present for inter CUs when the
        # SPS allows an explicit RQT level (log2 in (MinTb, MaxTb])
        if (sps.max_transform_hierarchy_depth_inter > 0 and not cu64
                and 3 <= log2_cb <= 5):
            cab.encode_bin(CTX_OFF["split_transform"] + (5 - log2_cb),
                           1 if tusplit else 0)
        if not split:
            # transform tree, single TU (hierarchy depth 0)
            cab.encode_bin(CTX_OFF["cbf_chroma"] + 0, cbf_cb)
            cab.encode_bin(CTX_OFF["cbf_chroma"] + 0, cbf_cr)
            if cbf_cb or cbf_cr:
                cab.encode_bin(CTX_OFF["cbf_luma"] + 1, cbf_y)
            # else cbf_luma inferred 1 (not all_zero, chroma zero)
            self._maybe_code_dqp(True)
            if cbf_y:
                encode_residual(cab, y_lvl, log2_cb, 0, 0, sign_hiding=sdh,
                                transquant_bypass=self.lossless)
            if cbf_cb:
                encode_residual(cab, cb_lvl, log2_cb - 1, 1, 0,
                                sign_hiding=sdh,
                                transquant_bypass=self.lossless,
                                transform_skip=self._ts_arg(
                                    1, x0 >> 1, y0 >> 1, log2_cb - 1))
            if cbf_cr:
                encode_residual(cab, cr_lvl, log2_cb - 1, 2, 0,
                                sign_hiding=sdh,
                                transquant_bypass=self.lossless,
                                transform_skip=self._ts_arg(
                                    2, x0 >> 1, y0 >> 1, log2_cb - 1))
        else:
            # transform_tree with one split level (implicit for 64x64,
            # explicit for 16/32): hierarchical chroma cbfs (ctxInc =
            # trafoDepth), 4 z-order leaves, each a transform_unit with
            # cbf_luma ctx 0 (trafoDepth 1)
            tnl2 = tn.bit_length() - 1
            cab.encode_bin(CTX_OFF["cbf_chroma"] + 0, cbf_cb)
            cab.encode_bin(CTX_OFF["cbf_chroma"] + 0, cbf_cr)
            for q in range(4):
                if cbf_cb:
                    cab.encode_bin(CTX_OFF["cbf_chroma"] + 1, qcb[q])
                if cbf_cr:
                    cab.encode_bin(CTX_OFF["cbf_chroma"] + 1, qcr[q])
                cab.encode_bin(CTX_OFF["cbf_luma"] + 0, qy[q])
                if qy[q] or qcb[q] or qcr[q]:
                    self._maybe_code_dqp(True)
                    if qy[q]:
                        encode_residual(cab, lvls[q][0], tnl2, 0, 0,
                                        sign_hiding=sdh,
                                        transquant_bypass=self.lossless)
                    if qcb[q]:
                        encode_residual(cab, lvls[q][1], tnl2 - 1, 1, 0,
                                        sign_hiding=sdh,
                                        transquant_bypass=self.lossless)
                    if qcr[q]:
                        encode_residual(cab, lvls[q][2], tnl2 - 1, 2, 0,
                                        sign_hiding=sdh,
                                        transquant_bypass=self.lossless)
        self._finish_inter(x0, y0, size, depth, motion, False,
                           pred_y, pred_cb, pred_cr, y_res, cb_res, cr_res,
                           cbf_luma=cbf_y)
        if split:
            # per-quadrant TU deblock maps (TU != CU here): the internal
            # TU edges exist and cbf varies per quadrant
            for q, (dx, dy) in enumerate(quads):
                self.dbs.mark_block(x0 + dx * tn, y0 + dy * tn, tn)
                self.dbs.set_tu(x0 + dx * tn, y0 + dy * tn, tn,
                                bool(qy[q]), self.lossless)

    def _finish_inter(self, x0, y0, size, depth, motion, skip,
                      pred_y, pred_cb, pred_cr, y_res, cb_res, cr_res,
                      cbf_luma=0):
        self.dbs.mark_block(x0, y0, size)
        self.dbs.set_tu(x0, y0, size, bool(cbf_luma), self.lossless)
        maxv = (1 << self.bd) - 1
        self.y[y0:y0 + size, x0:x0 + size] = np.clip(pred_y + y_res, 0, maxv)
        hs = size >> 1
        self.cb[y0 >> 1:(y0 >> 1) + hs, x0 >> 1:(x0 >> 1) + hs] = \
            np.clip(pred_cb + cb_res, 0, maxv)
        self.cr[y0 >> 1:(y0 >> 1) + hs, x0 >> 1:(x0 >> 1) + hs] = \
            np.clip(pred_cr + cr_res, 0, maxv)
        self.ic.set_block(x0, y0, size, size, motion, skip)
        s4 = slice(y0 >> 2, (y0 + size) >> 2), slice(x0 >> 2, (x0 + size) >> 2)
        self.depth4[s4] = depth
        self.avail4[s4] = True

    def _maybe_code_dqp(self, any_cbf: bool) -> None:
        """cu_qp_delta at the first TU with coded coefficients in the QG
        (7.3.8.10); qPY_PRED == previous QG's QP since QG == CTB."""
        if not getattr(self, "dqp_on", False) or self.qg_coded or not any_cbf:
            return
        encode_cu_qp_delta(self.cab, CTX_OFF["cu_qp_delta"],
                           self.qg_wanted - self.qp_prev)
        self.qg_coded = True

    def apply_loop_filters(self) -> None:
        """In-loop filter stage (x265 FrameFilter::processRow analog,
        framefilter.cpp:564): deblock the reconstruction in place. Must run
        after the whole slice is coded (intra prediction uses unfiltered
        samples; the *filtered* picture becomes the reference)."""
        pps = self.pps
        if pps.deblocking_filter_disabled:   # (no slice-level override emitted)
            return
        beta_off = pps.beta_offset_div2
        tc_off = pps.tc_offset_div2
        qp_arg = (self.qp4 if getattr(self, "dqp_on", False)
                  else self.sh.qp)
        self.y, self.cb, self.cr = deblock_frame(
            self.y, self.cb, self.cr, self.dbs, self.is_intra4,
            self.ic.mv4, self._refpoc4(), qp_arg, beta_off, tc_off,
            pps.cb_qp_offset, pps.cr_qp_offset, self.bd)

    def _refpoc4(self) -> np.ndarray:
        """Per-4x4 POC of the referenced picture per list (NOPOC unused)."""
        from x265_tpu_torch.hevc.deblock import NOPOC
        out = np.full(self.ic.ref4.shape, NOPOC, dtype=np.int64)
        for lx in (0, 1):
            pocs = self.ref_poc[lx]
            for r, poc in enumerate(pocs):
                out[..., lx][self.ic.ref4[..., lx] == r] = poc
        return out

    def _try_tskip(self, c_idx, x0, y0, resi, qp, is_intra, scan,
                   level_d, rres_d, m):
        """Transform-skip candidate for a 4x4 TB (quant.cpp transformNxN
        tskip branch): quantize resi << trShift, reconstruct via the
        spec's ts inverse (8.6.4.2), keep whichever of {DCT/DST, skip}
        wins the shared integer RD cost. Records the flag for the
        residual emitter. DCT-domain noise reduction never applies to
        the skip chain (there is no DCT)."""
        from x265_tpu_torch.ops.ref.transform import (
            forward_transform_skip, transform_skip_residual, tb_cost32)
        cf_s = forward_transform_skip(resi, self.bd)
        lvl_s = quantize(cf_s, qp, 2, is_intra, self.bd, m)
        if self.rdoq_level > 0 and np.any(lvl_s):
            lvl_s = rdoq(cf_s, lvl_s, qp, 2, None, self.bd, m,
                         consts=self._rk(c_idx),
                         psy_fx=self.psy_fx if c_idx == 0 else 0)
        if self.pps.sign_data_hiding and np.any(lvl_s):
            lvl_s = sign_bit_hiding_adjust(lvl_s, scan)
        if np.any(lvl_s):
            deq = dequantize(lvl_s, qp, 2, self.bd, m)
            rres_s = transform_skip_residual(deq, self.bd)
        else:
            rres_s = np.zeros_like(resi)
        cost_d = tb_cost32(resi, rres_d, level_d, qp)
        cost_s = tb_cost32(resi, rres_s, lvl_s, qp)
        if cost_s < cost_d:
            self._tsmap[(c_idx, x0, y0)] = 1
            return lvl_s, rres_s
        self._tsmap[(c_idx, x0, y0)] = 0
        return level_d, rres_d

    def _ts_arg(self, c_idx, x0, y0, log2):
        """transform_skip_flag to signal for this TB (-1 = not present)."""
        if log2 != 2 or not self.tskip or self.lossless:
            return -1
        return self._tsmap.get((c_idx, x0, y0), 0)

    def _rk(self, c_idx):
        """estBit fractional-bit RDOQ constants for a plane
        (hevc/rate_model.py; same derivation as native and device)."""
        rk = getattr(self, "_rk_cache", None)
        if rk is None:
            from x265_tpu_torch.hevc.rate_model import slice_rate_consts
            rk = slice_rate_consts(self.sh.slice_type, self.sh.qp)
            self._rk_cache = rk
        return rk[0 if c_idx == 0 else 1]

    def _sm(self, log2, is_intra, c_idx):
        """Scaling matrix m for quant/dequant (None when lists are off)."""
        key = (log2, is_intra, c_idx)
        if key not in self._sm_cache:
            from x265_tpu_torch.hevc.headers import sps_scaling_matrix
            self._sm_cache[key] = sps_scaling_matrix(
                self.sps, 1 << log2, is_intra, c_idx)
        return self._sm_cache[key]

    def _coeffs_from_pred(self, c_idx, x0, y0, log2, pred, is_intra_tb):
        """Transform+quant (or bypass) of src-pred; returns (levels, recon_resi)."""
        nt = 1 << log2
        src = self.src[c_idx][y0:y0 + nt, x0:x0 + nt]
        resi = (src - pred).astype(np.int32)
        if self.lossless:
            return resi, resi
        if c_idx == 0:
            qp = self.qp_y + 6 * (self.bd - 8)      # Qp'Y (8.6.1)
        else:
            off = (self.pps.cb_qp_offset if c_idx == 1
                   else self.pps.cr_qp_offset)
            qp = chroma_qp(self.qp_y, off, self.bd)  # Qp'C incl. offset
        use_dst = is_intra_tb and c_idx == 0 and log2 == 2
        coeff = forward_transform(resi, use_dst, self.bd)
        if self.nr is not None:
            coeff = self._denoise(coeff, log2, c_idx, is_intra_tb)
        m = self._sm(log2, is_intra_tb, c_idx)
        level = quantize(coeff, qp, log2, is_intra_tb, self.bd, m)
        if self.rdoq_level > 0 and np.any(level):
            level = rdoq(coeff, level, qp, log2, None, self.bd, m,
                         consts=self._rk(c_idx),
                         psy_fx=self.psy_fx if c_idx == 0 else 0)
        if self.pps.sign_data_hiding and np.any(level):
            level = sign_bit_hiding_adjust(level, SCANS[(log2, 0)])
        if np.any(level):
            deq = dequantize(level, qp, log2, self.bd, m)
            recon_resi = inverse_transform(deq, use_dst, self.bd)
        else:
            recon_resi = np.zeros_like(resi)
        if log2 == 2 and self.tskip and not self.lossless:
            return self._try_tskip(c_idx, x0, y0, resi, qp, is_intra_tb,
                                   SCANS[(2, 0)], level, recon_resi, m)
        return level, recon_resi

    def _denoise(self, coeff, log2, c_idx, is_intra_tb):
        """DCT-domain noise reduction (x265 denoiseDct, dct.cpp:744):
        resSum[i] += |c|; c = sign * max(0, |c| - offset[i])."""
        off, sums, cnt = self.nr
        cat = (log2 - 2) + 4 * (c_idx != 0) + 8 * (not is_intra_tb)
        nc = 1 << (2 * log2)
        a = np.abs(coeff).ravel()
        sums[cat, :nc] += a.astype(np.uint32)
        cnt[cat] += 1
        d = np.maximum(0, a - off[cat, :nc].astype(np.int64))
        return (np.sign(coeff).ravel() * d).reshape(coeff.shape) \
            .astype(coeff.dtype)

    def _plane(self, c_idx):
        return (self.y, self.cb, self.cr)[c_idx]

    def _avail_chroma(self):
        h, w = self.cb.shape
        h4, w4 = (h + 3) // 4, (w + 3) // 4
        ys = np.minimum(np.arange(h4) * 2, self.avail4.shape[0] - 1)
        xs = np.minimum(np.arange(w4) * 2, self.avail4.shape[1] - 1)
        return self.avail4[np.ix_(ys, xs)]

    def _predict(self, c_idx, x0, y0, log2, mode):
        nt = 1 << log2
        plane = self._plane(c_idx)
        if c_idx == 0:
            return predict_block(plane, self.avail4, x0, y0, nt, mode, 0,
                                 self.sps.strong_intra_smoothing, self.bd)
        ref = get_ref_samples(plane, self._avail_chroma(), x0, y0, nt, self.bd)
        return predict(ref, nt, mode, c_idx, self.bd)

    def _tb_coeffs(self, c_idx, x0, y0, log2, mode):
        """Returns (coeff_block_to_code, reconstruction_residual)."""
        nt = 1 << log2
        pred = self._predict(c_idx, x0, y0, log2, mode)
        src = self.src[c_idx][y0:y0 + nt, x0:x0 + nt]
        resi = (src - pred).astype(np.int32)
        self._last_pred = pred
        if self.lossless:
            return resi, resi
        if c_idx == 0:
            qp = self.qp_y + 6 * (self.bd - 8)      # Qp'Y (8.6.1)
        else:
            off = (self.pps.cb_qp_offset if c_idx == 1
                   else self.pps.cr_qp_offset)
            qp = chroma_qp(self.qp_y, off, self.bd)  # Qp'C incl. offset
        use_dst = (c_idx == 0 and log2 == 2)
        coeff = forward_transform(resi, use_dst, self.bd)
        m = self._sm(log2, True, c_idx)
        level = quantize(coeff, qp, log2, True, self.bd, m)
        if self.rdoq_level > 0 and np.any(level):
            level = rdoq(coeff, level, qp, log2, None, self.bd, m,
                         consts=self._rk(c_idx),
                         psy_fx=self.psy_fx if c_idx == 0 else 0)
        if self.pps.sign_data_hiding and np.any(level):
            scan = SCANS[(log2, coeff_scan_index(log2, c_idx, mode, True))]
            level = sign_bit_hiding_adjust(level, scan)
        if np.any(level):
            deq = dequantize(level, qp, log2, self.bd, m)
            recon_resi = inverse_transform(deq, use_dst, self.bd)
        else:
            recon_resi = np.zeros_like(resi)
        if log2 == 2 and self.tskip and not self.lossless:
            sc = SCANS[(2, coeff_scan_index(2, c_idx, mode, True))]
            return self._try_tskip(c_idx, x0, y0, resi, qp, True, sc,
                                   level, recon_resi, m)
        return level, recon_resi

    def _reconstruct(self, c_idx, x0, y0, log2, mode, resi):
        nt = 1 << log2
        pred = self._predict(c_idx, x0, y0, log2, mode)
        maxv = (1 << self.bd) - 1
        plane = self._plane(c_idx)
        plane[y0:y0 + nt, x0:x0 + nt] = np.clip(pred + resi, 0, maxv)
