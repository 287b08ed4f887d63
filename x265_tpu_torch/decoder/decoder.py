"""In-repo reference HEVC decoder (verification asset).

Decodes the subset of HEVC the encoder emits (growing with it), so that
every encoded stream can be validated without an external decoder — and,
inversely, streams produced by the reference x265 binary validate this
decoder's (and thus the shared tables'/syntax's) spec conformance.
Mirrors the test strategy of SURVEY.md §4 (regression suites decode-verify
every bitstream).

Currently supported: Main profile 4:2:0 8/10-bit, I slices (all intra),
transquant bypass (lossless) and regular transform path, part 2Nx2N + NxN,
full RQT, mode-dependent scans, sign-data hiding, transform skip.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from x265_tpu_torch.hevc.bitstream import (
    split_annexb, strip_emulation_prevention,
    NAL_VPS, NAL_SPS, NAL_PPS, NAL_AUD, NAL_PREFIX_SEI, NAL_SUFFIX_SEI,
    NAL_EOS, NAL_EOB, NAL_FD,
)
from x265_tpu_torch.hevc.cabac import CabacDecoder
from x265_tpu_torch.hevc.headers import (
    SPS, PPS, SliceHeader, parse_vps, parse_sps, parse_pps,
    parse_slice_header, SLICE_I, SLICE_P, SLICE_B, is_idr,
)
from x265_tpu_torch.hevc.cu_tools import (
    chroma_cand_list, decode_cu_qp_delta, mpm_list,
)
from x265_tpu_torch.hevc.deblock import DeblockState, deblock_frame
from x265_tpu_torch.hevc.inter_tools import (
    InterCtx, amvp_candidates, decode_mvd, merge_candidates,
)
from x265_tpu_torch.hevc.residual import decode_residual
from x265_tpu_torch.hevc.tables import CTX_OFF, chroma_qp, coeff_scan_index
from x265_tpu_torch.ops.ref.intra import predict_block
from x265_tpu_torch.ops.ref.transform import (
    dequantize, inverse_transform, transform_skip_residual,
)

INTRA_DM_CHROMA = 36  # marker: derive from luma


@dataclass
class DecodedPicture:
    poc: int
    y: np.ndarray
    cb: np.ndarray
    cr: np.ndarray


class PictureDecodeState:
    """Per-picture working state (the decoder-side CUData analog)."""

    def __init__(self, sps: SPS):
        self.sps = sps
        h, w = sps.height, sps.width
        self.y = np.zeros((h, w), dtype=np.int32)
        self.cb = np.zeros((h // 2, w // 2), dtype=np.int32)
        self.cr = np.zeros((h // 2, w // 2), dtype=np.int32)
        h4, w4 = (h + 3) // 4, (w + 3) // 4
        self.avail4 = np.zeros((h4, w4), dtype=bool)
        # parse-order (z-scan, 6.4.1) availability: set when a CU's mode
        # syntax is parsed, ahead of reconstruction. MPM derivation must
        # use THIS map — inside a PART_NxN CU the earlier PBs are
        # z-scan-available to later PBs' candidate lists even though
        # their samples are not yet reconstructed.
        self.parsed4 = np.zeros((h4, w4), dtype=bool)
        self.intra_mode4 = np.full((h4, w4), -1, dtype=np.int32)
        self.depth4 = np.zeros((h4, w4), dtype=np.int32)
        self.is_intra4 = np.zeros((h4, w4), dtype=bool)
        self.ic = InterCtx(h, w)
        self.ref_pads = ([], [])  # padded reference planes per list
        self.ref_poc = ((), ())   # POC of each reference per list
        self.poc = 0
        self.dbs = DeblockState(h, w)
        self.deblock_params = None  # (qp, beta_off, tc_off, cbqp, crqp)
        self.sao_params = None      # SaoParams once a slice enables SAO
        self.sao_flags = (False, False)
        self.qp4 = None             # per-4x4 QP map once cu_qp_delta seen
        self.filtered = False
        self.colctx = None          # ColCtx built at finish (TMVP source)
        self.col = None             # collocated ColCtx for THIS picture


class SliceDecoder:
    """Decodes one independent slice segment of an I picture."""

    def __init__(self, sps: SPS, pps: PPS, sh: SliceHeader, data: bytes,
                 stats=None):
        self.sps = sps
        self.pps = pps
        self.sh = sh
        # optional per-CU statistics collector (list): the analog of
        # x265's csv-log-level-2 analysis surface (x265.h x265_frame_stats).
        # Each coded CU appends (slice_type, size, kind, total_bytes,
        # residual_bytes, any_cbf) where kind in
        # {"skip","merge","amvp","intra","intra_nxn"} (intra_nxn: a
        # PART_NxN intra CU, four luma prediction blocks); byte spans come from the CABAC
        # read position, so they are exact to within engine carry (~1 byte).
        self.stats = stats
        self.data = data
        self.cab = CabacDecoder(data)
        init_type = {SLICE_I: 0, SLICE_P: 1, SLICE_B: 2}[sh.slice_type]
        if pps.cabac_init_present and sh.cabac_init_flag and sh.slice_type != SLICE_I:
            init_type = 3 - init_type
        self._init_type = init_type
        self.cab.init_slice(init_type, sh.qp)
        self.bd = sps.bit_depth
        self.qp_y = sh.qp
        # resolved scaling matrices (spec 7.4.5; PPS-level data overrides
        # SPS-level, both default to the Table 7-5/7-6 matrices)
        self._sl_cache = {}

    def _scaling_m(self, log2: int, is_intra: bool, c_idx: int):
        """[n,n] scaling matrix m for dequant, or None (flat) when scaling
        lists are off."""
        if not self.sps.scaling_list_enabled:
            return None
        key = (log2, is_intra, c_idx)
        if key not in self._sl_cache:
            from x265_tpu_torch.hevc.headers import scaling_factor_matrix
            n = 1 << log2
            size_id = log2 - 2
            if size_id == 3:
                matrix_id = 0 if is_intra else 1
            else:
                matrix_id = (0 if is_intra else 3) + c_idx
            sld = (self.pps.scaling_list_data
                   if self.pps.scaling_list_data is not None
                   else self.sps.scaling_list_data)
            self._sl_cache[key] = scaling_factor_matrix(sld, n, matrix_id)
        return self._sl_cache[key]

    def decode(self, pic: PictureDecodeState) -> None:
        sps, pps, sh = self.sps, self.pps, self.sh
        if not sh.deblocking_filter_disabled:
            pic.deblock_params = (sh.qp, sh.beta_offset_div2,
                                  sh.tc_offset_div2, pps.cb_qp_offset,
                                  pps.cr_qp_offset)
        ctb = sps.ctb_size
        w_ctbs = sps.pic_width_in_ctbs
        n_ctbs = w_ctbs * sps.pic_height_in_ctbs
        sao_on = sh.sao_luma or sh.sao_chroma
        if sao_on and pic.sao_params is None:
            from x265_tpu_torch.hevc.sao import empty_params
            pic.sao_params = empty_params(sps.pic_height_in_ctbs, w_ctbs)
            pic.sao_flags = (sh.sao_luma, sh.sao_chroma)
        self.dqp_on = pps.cu_qp_delta_enabled
        # quantization groups (8.6.1): size ctb >> diff_cu_qp_delta_depth
        # (x265 --qg-size; 32 at medium). qp_last = QpY of the last decoded
        # CU (qPY_PREV source).
        self.qg_log2 = sps.ctb_log2 - pps.diff_cu_qp_delta_depth
        self.qp_last = sh.qp
        self.qp_prev = sh.qp
        if self.dqp_on and pic.qp4 is None:
            h4, w4 = pic.avail4.shape
            pic.qp4 = np.full((h4, w4), sh.qp, dtype=np.int32)
        # slice isolation: neighbours in a different slice segment are
        # unavailable for intra refs / MPM / merge / AMVP (the map is
        # only consulted for current-slice decisions, so resetting per
        # slice start implements the spec's availability rule)
        pic.avail4[:] = False
        pic.parsed4[:] = False
        # WPP substreams (entropy_coding_sync, spec 9.3.1/9.3.2.3): each
        # CTU row is a byte-aligned substream at its entry_point_offset;
        # contexts sync from the snapshot taken after the second CTU of
        # the row above (x265 writes these by default, frameencoder.cpp
        # serializeSubstreams).
        wpp = bool(pps.entropy_coding_sync_enabled)
        entry = [0]
        acc = 0
        for off in sh.entry_point_offsets:
            acc += off
            entry.append(acc)
        self._wpp_ctx = None              # ctx snapshot after col-1 CTU
        addr = self.sh.segment_address
        while True:
            col = addr % w_ctbs
            if wpp and col == 0 and addr != sh.segment_address:
                k = (addr - sh.segment_address) // w_ctbs
                if k < len(entry):
                    self.cab = CabacDecoder(self.data[entry[k]:])
                    above_right = addr - w_ctbs + 1
                    if (w_ctbs > 1 and self._wpp_ctx is not None and
                            above_right >= sh.segment_address):
                        self.cab.ctx = self._wpp_ctx.copy()
                    else:
                        self.cab.init_slice(self._init_type, sh.qp)
            x0 = col * ctb
            y0 = (addr // w_ctbs) * ctb
            if self.dqp_on and wpp and col == 0:
                # 8.6.1: qPY_PREV resets to SliceQpY at the first QG of
                # every CTB row under entropy_coding_sync
                self.qp_last = sh.qp
            if sao_on:
                from x265_tpu_torch.hevc.sao import parse_sao_ctu
                parse_sao_ctu(self.cab, CTX_OFF, pic.sao_params,
                              addr // w_ctbs, addr % w_ctbs,
                              sh.sao_luma, sh.sao_chroma, self.bd,
                              first_row_of_slice=(
                                  addr - sh.segment_address < w_ctbs))
            self._coding_quadtree(pic, x0, y0, sps.ctb_log2, 0)
            if wpp and col == 1:
                self._wpp_ctx = self.cab.ctx.copy()
            addr += 1
            end = self.cab.decode_bin_trm()
            if end or addr >= n_ctbs:
                break

    def _qp_pred(self, pic, xqg: int, yqg: int) -> int:
        """qPY_PRED (8.6.1): average of the left/above neighbours' QpY when
        they fall in the same CTB as the quantization group, else
        qPY_PREV (the last decoded CU's QpY)."""
        prev = self.qp_last
        cl = self.sps.ctb_log2

        def nb(x, y):
            if x < 0 or y < 0:
                return prev
            if (x >> cl) != (xqg >> cl) or (y >> cl) != (yqg >> cl):
                return prev
            return int(pic.qp4[y >> 2, x >> 2])

        return (nb(xqg - 1, yqg) + nb(xqg, yqg - 1) + 1) >> 1

    def _maybe_parse_dqp(self, any_cbf: bool) -> None:
        """cu_qp_delta at the first coded TU of the QG (7.3.8.10); applies
        the delta to qPY_PRED stored at the QG root (8.6.1)."""
        if not getattr(self, "dqp_on", False) or self.qg_coded or not any_cbf:
            return
        delta = decode_cu_qp_delta(self.cab, CTX_OFF["cu_qp_delta"])
        bdo = 6 * (self.bd - 8)
        self.qp_y = ((self.qg_pred + delta + 52 + 2 * bdo) %
                     (52 + bdo)) - bdo
        self.qg_coded = True

    # ---- coding tree ----

    def _coding_quadtree(self, pic, x0, y0, log2_cb, depth) -> None:
        sps = self.sps
        size = 1 << log2_cb
        if getattr(self, "dqp_on", False) and log2_cb >= self.qg_log2:
            # quantization-group root (7.3.8.8 IsCuQpDeltaCoded reset)
            self.qg_coded = False
            self.qg_pred = self._qp_pred(pic, x0, y0)
            self.qp_y = self.qg_pred
        inside = x0 + size <= sps.width and y0 + size <= sps.height
        if inside and log2_cb > sps.log2_min_cb:
            ctx = CTX_OFF["split_cu"] + self._split_ctx(pic, x0, y0, depth)
            split = self.cab.decode_bin(ctx)
        else:
            split = 1 if log2_cb > sps.log2_min_cb else 0
        if split:
            half = size >> 1
            for (dx, dy) in ((0, 0), (half, 0), (0, half), (half, half)):
                x1, y1 = x0 + dx, y0 + dy
                if x1 < sps.width and y1 < sps.height:
                    self._coding_quadtree(pic, x1, y1, log2_cb - 1, depth + 1)
        else:
            if self.stats is not None:
                pos0 = self.cab.pos
                self._cu_kind, self._cu_res, self._cu_cbf = "intra", 0, True
                self._coding_unit(pic, x0, y0, log2_cb, depth)
                self.stats.append((self.sh.slice_type, size, self._cu_kind,
                                   self.cab.pos - pos0, self._cu_res,
                                   self._cu_cbf))
            else:
                self._coding_unit(pic, x0, y0, log2_cb, depth)
            if getattr(self, "dqp_on", False):
                pic.qp4[y0 >> 2:(y0 + size) >> 2,
                        x0 >> 2:(x0 + size) >> 2] = self.qp_y
                self.qp_last = self.qp_y

    def _split_ctx(self, pic, x0, y0, depth) -> int:
        ctx = 0
        if x0 > 0 and pic.avail4[y0 >> 2, (x0 - 1) >> 2]:
            ctx += 1 if pic.depth4[y0 >> 2, (x0 - 1) >> 2] > depth else 0
        if y0 > 0 and pic.avail4[(y0 - 1) >> 2, x0 >> 2]:
            ctx += 1 if pic.depth4[(y0 - 1) >> 2, x0 >> 2] > depth else 0
        return ctx

    # ---- coding unit (intra only) ----

    def _coding_unit(self, pic, x0, y0, log2_cb, depth) -> None:
        sps, pps = self.sps, self.pps
        cab = self.cab
        size = 1 << log2_cb

        tqb = 0
        if pps.transquant_bypass_enabled:
            tqb = cab.decode_bin(CTX_OFF["cu_transquant_bypass"])
        if self.sh.slice_type != SLICE_I:
            # cu_skip_flag
            ctx = 0
            if x0 > 0 and pic.avail4[y0 >> 2, (x0 - 1) >> 2]:
                ctx += 1 if pic.ic.skip4[y0 >> 2, (x0 - 1) >> 2] else 0
            if y0 > 0 and pic.avail4[(y0 - 1) >> 2, x0 >> 2]:
                ctx += 1 if pic.ic.skip4[(y0 - 1) >> 2, x0 >> 2] else 0
            if cab.decode_bin(CTX_OFF["cu_skip"] + ctx):
                self._inter_cu(pic, x0, y0, log2_cb, depth, bool(tqb),
                               skip=True)
                return
            if cab.decode_bin(CTX_OFF["pred_mode"]) == 0:
                self._inter_cu(pic, x0, y0, log2_cb, depth, bool(tqb),
                               skip=False)
                return

        part_nxn = False
        if log2_cb == sps.log2_min_cb:
            part_nxn = cab.decode_bin(CTX_OFF["part_mode"]) == 0
        if part_nxn:
            self._cu_kind = "intra_nxn"

        n_pbs = 4 if part_nxn else 1
        pb_size = size >> 1 if part_nxn else size
        prev_flags = [cab.decode_bin(CTX_OFF["prev_intra_luma_pred"])
                      for _ in range(n_pbs)]
        luma_modes = []
        for i in range(n_pbs):
            dx = (i & 1) * pb_size
            dy = (i >> 1) * pb_size
            cands = mpm_list(pic.intra_mode4, pic.is_intra4, pic.parsed4,
                             x0 + dx, y0 + dy, self.sps.ctb_size)
            if prev_flags[i]:
                idx = 0
                if cab.decode_bin_ep():
                    idx = 1 + cab.decode_bin_ep()
                mode = cands[idx]
            else:
                rem = cab.decode_bins_ep(5)
                s = sorted(cands)
                for c in s:
                    if rem >= c:
                        rem += 1
                mode = rem
            luma_modes.append(mode)
            # record modes for future MPM derivation
            pic.intra_mode4[(y0 + dy) >> 2:(y0 + dy + pb_size) >> 2,
                            (x0 + dx) >> 2:(x0 + dx + pb_size) >> 2] = mode
            pic.is_intra4[(y0 + dy) >> 2:(y0 + dy + pb_size) >> 2,
                          (x0 + dx) >> 2:(x0 + dx + pb_size) >> 2] = True
            pic.parsed4[(y0 + dy) >> 2:(y0 + dy + pb_size) >> 2,
                        (x0 + dx) >> 2:(x0 + dx + pb_size) >> 2] = True
        pic.depth4[y0 >> 2:(y0 + size) >> 2, x0 >> 2:(x0 + size) >> 2] = depth

        # chroma mode (one for the CU in 4:2:0)
        if cab.decode_bin(CTX_OFF["intra_chroma_pred"]):
            m = cab.decode_bins_ep(2)
            chroma_mode = chroma_cand_list(luma_modes[0])[m]
        else:
            chroma_mode = luma_modes[0]

        ctx = _CuCtx(tqb=bool(tqb), luma_modes=luma_modes,
                     chroma_mode=chroma_mode, part_nxn=part_nxn,
                     cu_x=x0, cu_y=y0, log2_cb=log2_cb)
        # transform tree
        max_depth = sps.max_transform_hierarchy_depth_intra + (1 if part_nxn else 0)
        res_pos0 = cab.pos
        self._transform_tree(pic, ctx, x0, y0, x0, y0, log2_cb, 0, 0,
                             max_depth, 1, 1)
        self._cu_res = cab.pos - res_pos0

    # ---- inter CU (P slices) ----

    def _decode_merge_idx(self) -> int:
        cmax = self.sh.max_num_merge_cand - 1
        if cmax == 0:
            return 0
        if not self.cab.decode_bin(CTX_OFF["merge_idx"]):
            return 0
        idx = 1
        while idx < cmax and self.cab.decode_bin_ep():
            idx += 1
        return idx

    def _mc_pred(self, pic, c_idx, x0, y0, nt, motion):
        from x265_tpu_torch.ops.ref.interp import (
            bipred, mc_chroma_14, mc_luma_14, unipred, weighted_unipred)
        from x265_tpu_torch.engine.ctu_writer import _l0_weight
        dir_, mv0, mv1, r0, r1 = motion

        def one(lx, mv, r):
            ref = pic.ref_pads[lx][r][c_idx]
            if c_idx == 0:
                return mc_luma_14(ref, 80, x0, y0, nt, nt, mv, self.bd)
            return mc_chroma_14(ref, 40, x0, y0, nt, nt, mv, self.bd)

        if dir_ == 3:
            return bipred(one(0, mv0, r0), one(1, mv1, r1), self.bd)
        if dir_ == 1:
            wp = _l0_weight(self.sh, r0, c_idx)
            if wp is not None:
                return weighted_unipred(one(0, mv0, r0), *wp, self.bd)
            return unipred(one(0, mv0, r0), self.bd)
        return unipred(one(1, mv1, r1), self.bd)

    def _inter_cu(self, pic, x0, y0, log2_cb, depth, tqb, skip) -> None:
        sps, pps, cab, sh = self.sps, self.pps, self.cab, self.sh
        size = 1 << log2_cb
        is_b = sh.slice_type == SLICE_B
        if skip:
            idx = self._decode_merge_idx()
            cands = merge_candidates(pic.ic, pic.avail4, x0, y0, size, size,
                                     sps.width, sps.height,
                                     sh.max_num_merge_cand, sps.ctb_size,
                                     is_b=is_b, ref_poc=pic.ref_poc,
                                     col=pic.col,
                                     col_from_l0=int(sh.collocated_from_l0),
                                     cur_poc=pic.poc)
            motion = cands[idx]
            cbf_y = cbf_cb = cbf_cr = 0
            merge = True
            self._cu_kind, self._cu_res, self._cu_cbf = "skip", 0, False
        else:
            # part_mode: inter coded at every size; we support 2Nx2N only
            if cab.decode_bin(CTX_OFF["part_mode"]) == 0:
                raise NotImplementedError("non-2Nx2N inter partitions")
            if cab.decode_bin(CTX_OFF["merge_flag"]):
                idx = self._decode_merge_idx()
                cands = merge_candidates(pic.ic, pic.avail4, x0, y0, size,
                                         size, sps.width, sps.height,
                                         sh.max_num_merge_cand, sps.ctb_size,
                                         is_b=is_b, ref_poc=pic.ref_poc,
                                         col=pic.col,
                                         col_from_l0=int(
                                             sh.collocated_from_l0),
                                         cur_poc=pic.poc)
                motion = cands[idx]
                merge = True
            else:
                dir_ = 1
                if is_b:
                    if cab.decode_bin(CTX_OFF["inter_pred_idc"] + depth):
                        dir_ = 3
                    else:
                        dir_ = 2 if cab.decode_bin(
                            CTX_OFF["inter_pred_idc"] + 4) else 1
                mvs = [(0, 0), (0, 0)]
                rids = [-1, -1]
                nact = (sh.num_ref_idx_l0_active, sh.num_ref_idx_l1_active)
                for lx in (0, 1):
                    if not (dir_ & (1 << lx)):
                        continue
                    rid = 0
                    if nact[lx] > 1:      # ref_idx: TR, bins 0/1 ctx, rest ep
                        if cab.decode_bin(CTX_OFF["ref_idx"]):
                            rid = 1
                            cmax = nact[lx] - 1
                            while rid < cmax:
                                b = (cab.decode_bin(CTX_OFF["ref_idx"] + 1)
                                     if rid == 1 else cab.decode_bin_ep())
                                if not b:
                                    break
                                rid += 1
                    rids[lx] = rid
                    mvd = decode_mvd(cab, CTX_OFF["mvd"])
                    mvp_idx = cab.decode_bin(CTX_OFF["mvp_flag"])
                    amvp = amvp_candidates(pic.ic, pic.avail4, x0, y0, size,
                                           size, sps.width, sps.height,
                                           lx=lx, ref_idx=rid,
                                           cur_poc=pic.poc,
                                           ref_poc=pic.ref_poc,
                                           col=pic.col,
                                           col_from_l0=int(
                                               sh.collocated_from_l0),
                                           ctb_size=sps.ctb_size)
                    mvs[lx] = (amvp[mvp_idx][0] + mvd[0],
                               amvp[mvp_idx][1] + mvd[1])
                motion = (dir_, mvs[0], mvs[1], rids[0], rids[1])
                merge = False
            self._cu_kind = "merge" if merge else "amvp"
            res_pos0 = cab.pos
            root_cbf = 1
            if not merge:
                root_cbf = cab.decode_bin(CTX_OFF["rqt_root_cbf"])
            if log2_cb == 6 and root_cbf:
                # 64x64 CU: implicit transform split into 4 32x32 TUs
                # (log2TrafoSize > MaxTbLog2SizeY, no split flag bins);
                # hierarchical chroma cbfs, z-order leaves
                self._inter_cu64_tree(pic, x0, y0, depth, tqb, motion)
                self._cu_res, self._cu_cbf = cab.pos - res_pos0, True
                return
            if (root_cbf and self.sps.max_transform_hierarchy_depth_inter
                    > 0 and 3 <= log2_cb <= 5):
                # explicit RQT level (7.3.8.8 split_transform_flag,
                # ctxInc = 5 - log2TrafoSize)
                if cab.decode_bin(CTX_OFF["split_transform"]
                                  + (5 - log2_cb)):
                    if log2_cb == 3:
                        # 8x8 split leaves 4x4 luma + single 4x4 chroma
                        # at blk 3 — this encoder never emits it
                        raise NotImplementedError(
                            "8x8 inter TU split (chroma at blk 3)")
                    self._inter_split_tree(pic, x0, y0, log2_cb, depth,
                                           tqb, motion)
                    self._cu_res, self._cu_cbf = cab.pos - res_pos0, True
                    return
            if root_cbf:
                cbf_cb = cab.decode_bin(CTX_OFF["cbf_chroma"] + 0)
                cbf_cr = cab.decode_bin(CTX_OFF["cbf_chroma"] + 0)
                if cbf_cb or cbf_cr:
                    cbf_y = cab.decode_bin(CTX_OFF["cbf_luma"] + 1)
                else:
                    cbf_y = 1     # inferred for inter depth-0
            else:
                cbf_y = cbf_cb = cbf_cr = 0

        cu = _CuCtx(tqb=tqb, luma_modes=[0], chroma_mode=0, part_nxn=False,
                    cu_x=x0, cu_y=y0, log2_cb=log2_cb)
        self._maybe_parse_dqp(bool(cbf_y or cbf_cb or cbf_cr))
        pic.dbs.mark_block(x0, y0, size)
        pic.dbs.set_tu(x0, y0, size, bool(cbf_y), tqb)
        maxv = (1 << self.bd) - 1
        pred_y = self._mc_pred(pic, 0, x0, y0, size, motion)
        res_y = (self._decode_tb_residual_inter(cu, log2_cb, 0)
                 if cbf_y else 0)
        pic.y[y0:y0 + size, x0:x0 + size] = np.clip(pred_y + res_y, 0, maxv)
        hs = size >> 1
        pred_cb = self._mc_pred(pic, 1, x0 >> 1, y0 >> 1, hs, motion)
        res_cb = (self._decode_tb_residual_inter(cu, log2_cb - 1, 1)
                  if cbf_cb else 0)
        pic.cb[y0 >> 1:(y0 >> 1) + hs, x0 >> 1:(x0 >> 1) + hs] = \
            np.clip(pred_cb + res_cb, 0, maxv)
        pred_cr = self._mc_pred(pic, 2, x0 >> 1, y0 >> 1, hs, motion)
        res_cr = (self._decode_tb_residual_inter(cu, log2_cb - 1, 2)
                  if cbf_cr else 0)
        pic.cr[y0 >> 1:(y0 >> 1) + hs, x0 >> 1:(x0 >> 1) + hs] = \
            np.clip(pred_cr + res_cr, 0, maxv)

        pic.ic.set_block(x0, y0, size, size, motion, skip)
        if not skip:
            self._cu_res = self.cab.pos - res_pos0
            self._cu_cbf = bool(cbf_y or cbf_cb or cbf_cr)
        s4 = (slice(y0 >> 2, (y0 + size) >> 2),
              slice(x0 >> 2, (x0 + size) >> 2))
        pic.depth4[s4] = depth
        pic.avail4[s4] = True

    def _inter_cu64_tree(self, pic, x0, y0, depth, tqb, motion) -> None:
        """Transform tree of a 64x64 inter CU with coded residual: the
        implicit split yields 4 32x32 luma TUs (+16x16 chroma)."""
        self._inter_split_tree(pic, x0, y0, 6, depth, tqb, motion)

    def _inter_split_tree(self, pic, x0, y0, log2_cb, depth, tqb,
                          motion) -> None:
        """One split level of an inter CU's transform tree (implicit for
        64x64, explicit split_transform_flag for 16/32, 7.3.8.8): 4
        z-order luma TUs at half size (+quarter chroma); chroma cbfs are
        hierarchical (ctxInc = trafoDepth)."""
        cab, sh = self.cab, self.sh
        size = 1 << log2_cb
        tn = size >> 1
        tc = tn >> 1
        tnl2 = log2_cb - 1
        cu = _CuCtx(tqb=tqb, luma_modes=[0], chroma_mode=0, part_nxn=False,
                    cu_x=x0, cu_y=y0, log2_cb=log2_cb)
        maxv = (1 << self.bd) - 1
        acb = cab.decode_bin(CTX_OFF["cbf_chroma"] + 0)
        acr = cab.decode_bin(CTX_OFF["cbf_chroma"] + 0)
        pred_y = self._mc_pred(pic, 0, x0, y0, size, motion)
        pred_cb = self._mc_pred(pic, 1, x0 >> 1, y0 >> 1, tn, motion)
        pred_cr = self._mc_pred(pic, 2, x0 >> 1, y0 >> 1, tn, motion)
        pic.dbs.mark_block(x0, y0, size)
        for (dx, dy) in ((0, 0), (1, 0), (0, 1), (1, 1)):
            qcb = cab.decode_bin(CTX_OFF["cbf_chroma"] + 1) if acb else 0
            qcr = cab.decode_bin(CTX_OFF["cbf_chroma"] + 1) if acr else 0
            qy = cab.decode_bin(CTX_OFF["cbf_luma"] + 0)
            self._maybe_parse_dqp(bool(qy or qcb or qcr))
            qx0, qy0 = x0 + dx * tn, y0 + dy * tn
            pic.dbs.mark_block(qx0, qy0, tn)
            pic.dbs.set_tu(qx0, qy0, tn, bool(qy), tqb)
            res_y = (self._decode_tb_residual_inter(cu, tnl2, 0)
                     if qy else 0)
            pic.y[qy0:qy0 + tn, qx0:qx0 + tn] = np.clip(
                pred_y[dy * tn:dy * tn + tn, dx * tn:dx * tn + tn] + res_y,
                0, maxv)
            res_cb = (self._decode_tb_residual_inter(cu, tnl2 - 1, 1)
                      if qcb else 0)
            res_cr = (self._decode_tb_residual_inter(cu, tnl2 - 1, 2)
                      if qcr else 0)
            cx0, cy0 = (qx0 >> 1), (qy0 >> 1)
            pic.cb[cy0:cy0 + tc, cx0:cx0 + tc] = np.clip(
                pred_cb[dy * tc:dy * tc + tc, dx * tc:dx * tc + tc]
                + res_cb, 0, maxv)
            pic.cr[cy0:cy0 + tc, cx0:cx0 + tc] = np.clip(
                pred_cr[dy * tc:dy * tc + tc, dx * tc:dx * tc + tc]
                + res_cr, 0, maxv)
        pic.ic.set_block(x0, y0, size, size, motion, False)
        s4 = (slice(y0 >> 2, (y0 + size) >> 2),
              slice(x0 >> 2, (x0 + size) >> 2))
        pic.depth4[s4] = depth
        pic.avail4[s4] = True

    def _decode_tb_residual_inter(self, cu, log2, c_idx) -> np.ndarray:
        pps, cab = self.pps, self.cab
        if pps.transform_skip_enabled and not cu.tqb and log2 == 2:
            off = CTX_OFF["transform_skip_luma" if c_idx == 0 else
                          "transform_skip_chroma"]
            ts = cab.decode_bin(off)
        else:
            ts = 0
        coeff = decode_residual(cab, log2, c_idx, 0,
                                sign_hiding=pps.sign_data_hiding,
                                transquant_bypass=cu.tqb)
        if cu.tqb:
            return coeff
        if c_idx == 0:
            qp = self.qp_y + 6 * (self.bd - 8)      # Qp'Y (8.6.1)
        else:
            off = pps.cb_qp_offset if c_idx == 1 else pps.cr_qp_offset
            qp = chroma_qp(self.qp_y, off, self.bd)  # Qp'C incl. offset
        deq = dequantize(coeff, qp, log2, self.bd,
                         m=self._scaling_m(log2, False, c_idx))
        if ts:
            return transform_skip_residual(deq, self.bd)
        return inverse_transform(deq, False, self.bd)

    # ---- transform tree ----

    def _transform_tree(self, pic, cu, x0, y0, x_base, y_base, log2_tb,
                        depth, blk_idx, max_depth, cbf_cb_parent, cbf_cr_parent):
        sps, cab = self.sps, self.cab
        intra_split = cu.part_nxn
        max_tb = sps.log2_min_tb + sps.log2_diff_max_min_tb
        if (log2_tb <= max_tb and log2_tb > sps.log2_min_tb and
                depth < max_depth and not (intra_split and depth == 0)):
            split = cab.decode_bin(CTX_OFF["split_transform"] + (5 - log2_tb))
        else:
            split = 1 if (log2_tb > max_tb or (intra_split and depth == 0)) else 0

        cbf_cb = cbf_cb_parent
        cbf_cr = cbf_cr_parent
        if log2_tb > 2:
            if depth == 0 or cbf_cb_parent:
                cbf_cb = cab.decode_bin(CTX_OFF["cbf_chroma"] + depth)
            else:
                cbf_cb = 0
            if depth == 0 or cbf_cr_parent:
                cbf_cr = cab.decode_bin(CTX_OFF["cbf_chroma"] + depth)
            else:
                cbf_cr = 0

        if split:
            half = 1 << (log2_tb - 1)
            for i, (dx, dy) in enumerate(((0, 0), (half, 0), (0, half), (half, half))):
                self._transform_tree(pic, cu, x0 + dx, y0 + dy, x0, y0,
                                     log2_tb - 1, depth + 1, i, max_depth,
                                     cbf_cb, cbf_cr)
            return

        # leaf: cbf_luma (intra: always coded)
        cbf_luma = cab.decode_bin(CTX_OFF["cbf_luma"] + (1 if depth == 0 else 0))
        self._transform_unit(pic, cu, x0, y0, x_base, y_base, log2_tb,
                             depth, blk_idx, cbf_luma, cbf_cb, cbf_cr)

    def _transform_unit(self, pic, cu, x0, y0, x_base, y_base, log2_tb,
                        depth, blk_idx, cbf_luma, cbf_cb, cbf_cr):
        sps, pps, cab = self.sps, self.pps, self.cab
        nt = 1 << log2_tb
        pic.dbs.mark_block(x0, y0, nt)
        pic.dbs.set_tu(x0, y0, nt, bool(cbf_luma), cu.tqb)

        # luma intra mode for this TB
        if cu.part_nxn and (1 << cu.log2_cb) > nt * 2:
            raise ValueError("bad NxN geometry")
        if cu.part_nxn and log2_tb == cu.log2_cb - 1:
            mode = cu.luma_modes[blk_idx]
        else:
            mode = cu.luma_modes[0]

        self._maybe_parse_dqp(bool(cbf_luma or cbf_cb or cbf_cr))

        # ---- luma: predict, decode residual, reconstruct ----
        pred = predict_block(pic.y, pic.avail4, x0, y0, nt, mode, 0,
                             sps.strong_intra_smoothing, self.bd)
        if cbf_luma:
            resi = self._decode_tb_residual(cu, log2_tb, 0, mode)
        else:
            resi = 0
        maxv = (1 << self.bd) - 1
        pic.y[y0:y0 + nt, x0:x0 + nt] = np.clip(pred + resi, 0, maxv)
        pic.avail4[y0 >> 2:(y0 + nt) >> 2, x0 >> 2:(x0 + nt) >> 2] = True

        # ---- chroma ----
        if log2_tb > 2:
            self._reconstruct_chroma(pic, cu, x0, y0, log2_tb - 1,
                                     cbf_cb, cbf_cr)
        elif blk_idx == 3:
            self._reconstruct_chroma(pic, cu, x_base, y_base, 2,
                                     cbf_cb, cbf_cr)

    def _reconstruct_chroma(self, pic, cu, x0, y0, log2_c, cbf_cb, cbf_cr):
        nt = 1 << log2_c
        xc, yc = x0 >> 1, y0 >> 1
        cmode = cu.chroma_mode
        maxv = (1 << self.bd) - 1
        for plane, cbf, c_idx in ((pic.cb, cbf_cb, 1), (pic.cr, cbf_cr, 2)):
            pred = _predict_chroma(plane, pic.avail4, xc, yc, nt, cmode,
                                   self.bd)
            if cbf:
                resi = self._decode_tb_residual(cu, log2_c, c_idx, cmode)
            else:
                resi = 0
            plane[yc:yc + nt, xc:xc + nt] = np.clip(pred + resi, 0, maxv)

    def _decode_tb_residual(self, cu, log2, c_idx, mode) -> np.ndarray:
        pps = self.pps
        cab = self.cab
        ts = 0
        if (pps.transform_skip_enabled and not cu.tqb and log2 == 2):
            off = CTX_OFF["transform_skip_luma" if c_idx == 0 else
                          "transform_skip_chroma"]
            ts = cab.decode_bin(off)
        scan_idx = coeff_scan_index(log2, c_idx, mode, True)
        coeff = decode_residual(cab, log2, c_idx, scan_idx,
                                sign_hiding=pps.sign_data_hiding,
                                transquant_bypass=cu.tqb)
        if cu.tqb:
            return coeff
        if c_idx == 0:
            qp = self.qp_y + 6 * (self.bd - 8)      # Qp'Y (8.6.1)
        else:
            off = pps.cb_qp_offset if c_idx == 1 else pps.cr_qp_offset
            qp = chroma_qp(self.qp_y, off, self.bd)  # Qp'C incl. offset
        deq = dequantize(coeff, qp, log2, self.bd,
                         m=self._scaling_m(log2, True, c_idx))
        if ts:
            return transform_skip_residual(deq, self.bd)
        use_dst = (c_idx == 0 and log2 == 2)  # intra luma 4x4
        return inverse_transform(deq, use_dst, self.bd)


def _predict_chroma(plane, avail4_luma, xc, yc, nt, mode, bd):
    """Chroma intra prediction: same process, luma-coord availability."""
    from x265_tpu_torch.ops.ref.intra import get_ref_samples, predict

    # availability map in chroma coords at 4x4-chroma granularity is
    # derived by sampling the luma map at (2x, 2y)
    h, w = plane.shape
    h4, w4 = (h + 3) // 4, (w + 3) // 4
    avail_c = np.zeros((h4, w4), dtype=bool)
    ys = np.minimum(np.arange(h4) * 8 // 4, avail4_luma.shape[0] - 1)
    xs = np.minimum(np.arange(w4) * 8 // 4, avail4_luma.shape[1] - 1)
    avail_c[:, :] = avail4_luma[np.ix_(ys, xs)]
    ref = get_ref_samples(plane, avail_c, xc, yc, nt, bd)
    return predict(ref, nt, mode, 1, bd)


@dataclass
class _CuCtx:
    tqb: bool
    luma_modes: List[int]
    chroma_mode: int
    part_nxn: bool
    cu_x: int
    cu_y: int
    log2_cb: int


class HEVCDecoder:
    """Top-level decoder: Annex-B stream -> pictures in display order.

    Maintains a POC-keyed DPB, derives POC with MSB wrap (spec 8.3.1) and
    builds RefPicList0/1 from the slice RPS (8.3.2-8.3.4): L0 = stCurrBefore
    then stCurrAfter, L1 = stCurrAfter then stCurrBefore.
    """

    def __init__(self, collect_stats: bool = False) -> None:
        self.sps: Dict[int, SPS] = {}
        self.pps: Dict[int, PPS] = {}
        self.dpb: Dict[int, PictureDecodeState] = {}
        self.prev_poc_lsb = 0
        self.prev_poc_msb = 0
        self.seg_base = 0          # display-order base of the current CVS
        self.max_poc_seen = -1
        # per-picture CU statistics in decode order: (poc, slice_type,
        # [cu events]) — see SliceDecoder.stats. Enables bit-composition
        # analysis (tools/stream_stats.py), the x265 csv-log-level analog.
        self.collect_stats = collect_stats
        self.pic_stats: List[tuple] = []

    def _derive_poc(self, sh, sps, nal_type) -> int:
        if is_idr(nal_type):
            self.prev_poc_lsb = 0
            self.prev_poc_msb = 0
            return 0
        max_lsb = 1 << sps.log2_max_poc_lsb
        lsb = sh.pic_order_cnt_lsb
        if lsb < self.prev_poc_lsb and \
                (self.prev_poc_lsb - lsb) >= max_lsb // 2:
            msb = self.prev_poc_msb + max_lsb
        elif lsb > self.prev_poc_lsb and \
                (lsb - self.prev_poc_lsb) > max_lsb // 2:
            msb = self.prev_poc_msb - max_lsb
        else:
            msb = self.prev_poc_msb
        return msb + lsb

    def _build_ref_lists(self, pic, sh, poc) -> None:
        rps = sh.short_term_rps
        before = [poc + d for d, u in zip(rps.delta_poc_s0, rps.used_s0) if u]
        after = [poc + d for d, u in zip(rps.delta_poc_s1, rps.used_s1) if u]
        l0 = (before + after)[:sh.num_ref_idx_l0_active]
        l1 = (after + before)[:sh.num_ref_idx_l1_active] \
            if sh.slice_type == SLICE_B else []
        pic.ref_poc = (tuple(l0), tuple(l1))
        pic.ref_pads = ([], [])
        for lx, lst in ((0, l0), (1, l1)):
            for rpoc in lst:
                if rpoc not in self.dpb:
                    raise ValueError(f"reference POC {rpoc} not in DPB")
                ref = self.dpb[rpoc]
                pic.ref_pads[lx].append((
                    np.pad(ref.y, 80, mode="edge"),
                    np.pad(ref.cb, 40, mode="edge"),
                    np.pad(ref.cr, 40, mode="edge")))

    def decode(self, stream: bytes) -> List[DecodedPicture]:
        pictures: List[DecodedPicture] = []
        cur_pic: Optional[PictureDecodeState] = None

        def flush_current():
            nonlocal cur_pic
            if cur_pic is None:
                return
            self._finish(cur_pic)
            self.dpb[cur_pic.poc] = cur_pic
            pictures.append(self._emit(cur_pic, self.seg_base + cur_pic.poc))
            self.max_poc_seen = max(self.max_poc_seen, cur_pic.poc)
            cur_pic = None

        for nal in split_annexb(stream):
            if len(nal) < 2:
                continue
            nal_type = (nal[0] >> 1) & 0x3F
            rbsp = strip_emulation_prevention(nal[2:])
            if nal_type == NAL_VPS:
                parse_vps(rbsp)
            elif nal_type == NAL_SPS:
                s = parse_sps(rbsp)
                self.sps[s.sps_id] = s
            elif nal_type == NAL_PPS:
                p = parse_pps(rbsp)
                self.pps[p.pps_id] = p
            elif nal_type in (NAL_AUD, NAL_PREFIX_SEI, NAL_SUFFIX_SEI,
                              NAL_EOS, NAL_EOB, NAL_FD):
                continue
            elif nal_type < 32:
                # slice NAL — parse header with the (single) known PPS/SPS
                pps0 = next(iter(self.pps.values()))
                sps0 = self.sps[pps0.sps_id]
                sh, off = parse_slice_header(rbsp, nal_type, sps0, pps0)
                pps = self.pps[sh.pps_id]
                sps = self.sps[pps.sps_id]
                if sh.entry_point_offsets:
                    # entry points count escaped (EBSP) bytes (7.4.7.1);
                    # SliceDecoder indexes the stripped payload
                    from x265_tpu_torch.hevc.bitstream import \
                        ebsp_to_rbsp_offsets
                    cum = []
                    acc = 0
                    for o in sh.entry_point_offsets:
                        acc += o
                        cum.append(acc)
                    rb = ebsp_to_rbsp_offsets(rbsp[off:], cum)
                    sh.entry_point_offsets = [
                        rb[0]] + [rb[i] - rb[i - 1]
                                  for i in range(1, len(rb))]
                if sh.first_slice_in_pic:
                    flush_current()
                    poc = self._derive_poc(sh, sps, nal_type)
                    if is_idr(nal_type):
                        # new coded video sequence: reset DPB, bump the
                        # display-order base past everything emitted
                        self.dpb.clear()
                        self.seg_base += self.max_poc_seen + 1
                        self.max_poc_seen = -1
                    # prevTid0Poc (8.3.1): only TemporalId-0 pics that are
                    # not RASL/RADL/sub-layer-non-reference update the state
                    slnr_or_radl = nal_type in (0, 2, 4, 6, 7, 8, 9)
                    if not slnr_or_radl:
                        self.prev_poc_lsb = sh.pic_order_cnt_lsb
                        self.prev_poc_msb = poc - sh.pic_order_cnt_lsb
                    cur_pic = PictureDecodeState(sps)
                    cur_pic.poc = poc
                    if sh.slice_type != SLICE_I:
                        self._build_ref_lists(cur_pic, sh, poc)
                        if sh.temporal_mvp_enabled:
                            lst = cur_pic.ref_poc[
                                0 if sh.collocated_from_l0 else 1]
                            ci = sh.collocated_ref_idx
                            if ci < len(lst) and lst[ci] in self.dpb:
                                cur_pic.col = self.dpb[lst[ci]].colctx
                if self.collect_stats:
                    if sh.first_slice_in_pic:
                        self.pic_stats.append(
                            (cur_pic.poc, sh.slice_type, []))
                    sd = SliceDecoder(sps, pps, sh, rbsp[off:],
                                      stats=self.pic_stats[-1][2])
                else:
                    sd = SliceDecoder(sps, pps, sh, rbsp[off:])
                sd.decode(cur_pic)
        flush_current()
        pictures.sort(key=lambda p: p.poc)
        return pictures

    @staticmethod
    def _finish(pic: PictureDecodeState) -> None:
        """In-loop filters once the picture is complete (8.7: deblock then
        SAO; the filtered picture is both the output and the reference)."""
        if pic.filtered:
            return
        pic.colctx = _build_colctx(pic)
        if pic.deblock_params is not None:
            from x265_tpu_torch.hevc.deblock import NOPOC
            refpoc4 = np.full(pic.ic.ref4.shape, NOPOC, dtype=np.int64)
            for lx in (0, 1):
                for r, rpoc in enumerate(pic.ref_poc[lx]):
                    refpoc4[..., lx][pic.ic.ref4[..., lx] == r] = rpoc
            qp, boff, toff, cbo, cro = pic.deblock_params
            qp_arg = pic.qp4 if pic.qp4 is not None else qp
            pic.y, pic.cb, pic.cr = deblock_frame(
                pic.y, pic.cb, pic.cr, pic.dbs, pic.is_intra4,
                pic.ic.mv4, refpoc4, qp_arg, boff, toff, cbo, cro,
                pic.sps.bit_depth)
        if pic.sao_params is not None:
            from x265_tpu_torch.hevc.sao import apply_frame
            pic.y, pic.cb, pic.cr = apply_frame(
                (pic.y, pic.cb, pic.cr), pic.sao_params,
                pic.sps.ctb_log2, pic.sps.bit_depth)
        pic.filtered = True

    @staticmethod
    def _emit(pic: PictureDecodeState, poc: int) -> DecodedPicture:
        return DecodedPicture(poc=poc, y=pic.y.copy(), cb=pic.cb.copy(),
                              cr=pic.cr.copy())


def decode_file(path: str) -> List[DecodedPicture]:
    with open(path, "rb") as f:
        return HEVCDecoder().decode(f.read())


def _build_colctx(pic):
    """16x16-compressed motion field of a finished picture (the spec's MV
    storage compression for TMVP, 8.5.3.2.7)."""
    from x265_tpu_torch.hevc.inter_tools import ColCtx
    mv16 = pic.ic.mv4[::4, ::4].copy()
    ref16 = pic.ic.ref4[::4, ::4]
    dir16 = (((ref16[..., 0] >= 0).astype(np.int32))
             | ((ref16[..., 1] >= 0).astype(np.int32) << 1))
    refpoc16 = np.zeros(ref16.shape, np.int32)
    for lx in (0, 1):
        for r, rp in enumerate(pic.ref_poc[lx]):
            refpoc16[..., lx][ref16[..., lx] == r] = rp
    return ColCtx(pic.poc, dir16, mv16, refpoc16)
