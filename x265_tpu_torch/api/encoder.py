"""Top-level encoder API (x265_encoder_open/encode/close analog,
reference source/encoder/api.cpp:76,410 and encoder.cpp:1574).

Scope of the port so far: IDR/CRA, P and B pictures — mini-GOPs of up to
`bframes` B pictures between two anchors, fixed (b-adapt 0) or placed by
the lowres slice-type search (b-adapt 2), with the B-pyramid's referenced
middle B and open-GOP CRAs whose queued pictures become RASL leading
pictures — Annex-B output, under CQP, CRF or
ABR with VBV, with the lookahead (scenecut, cuTree), the in-loop filters
(deblock, SAO), adaptive quantization, weighted prediction (P anchors)
and the rd 3 decisions (rd 4 is the same path), RDOQ with psy-RDOQ, the
explicit inter RQT level (tu-inter-depth 2) and the dense integer search
(`--me star`/`full`/`sea`): the presets from `ultrafast` to `slow`, with
or without `zerolatency`. Lossless (transquant bypass: no deblock, no
SAO, no cu_qp_delta) and all-intra (keyint 1: a pipelined path whose
device analysis runs a chunk ahead of the host writer, every picture an
IDR) are encoded too. Per picture: the lowres lookahead costs, intra
analysis and motion search on the device (both anchors and their
bi-prediction for a B), merge adoption and CU promotion (batched RD
passes on the device under rd 3, host rules below it), inter
residual/recon on the device, CABAC in the native writer, then deblock +
SAO statistics and the SAO apply on the device; the filtered planes stay
there as the next pictures' reference. A P or I picture that would
underflow the VBV buffer is encoded again at a higher QP. Encodes that
something outside the encoder steers: two-pass ABR (--pass 1 writes the
stats file at close(), --pass 2 plans from it), --zones, --qpfile
(forced keyframes and QPs), ROI maps (set_ctu_info), analysis save/load
(--analysis-save/--analysis-load, --scale-factor 2,
set/get_analysis_data: a loaded picture skips its own analysis).
Stream structure and live robustness: WPP substreams with their entry
points (--wpp), multi-slice pictures as even CTU-row bands (--slices),
transform skip (--tskip), DCT-domain noise reduction (--nr-intra,
--nr-inter), dropped duplicates signalled by pic_struct (--frame-dup),
the luma-histogram scene cut (--hist-scenecut) and the intra-refresh
column sweep with its recovery point (--intra-refresh). The JAX
encoder's reference switches, attributes set after construction:
use_tpu_analysis (False: the numpy intra analysis, the CLI's --no-tpu),
use_native (False: the Python oracle writer) and use_tpu_residual
(False: the native walk quantizes every TB). Everything else (12-bit,
more than 4 references) raises NotImplementedError at construction.
"""
from __future__ import annotations

import copy
import os
from typing import Optional

import numpy as np

from x265_tpu_torch.api.params import Param, check_params
from x265_tpu_torch.engine.ctu_writer import FrameDecisions
from x265_tpu_torch.engine.planes import FramePlanes, MELuma, is_planes
from x265_tpu_torch.hevc.bitstream import (
    annexb, make_nal, NAL_IDR_W_RADL, NAL_TRAIL_N, NAL_TRAIL_R,
    NAL_VPS, NAL_SPS, NAL_PPS,
)
from x265_tpu_torch.hevc.headers import (
    PPS, SPS, VPS, ProfileTierLevel, ShortTermRPS, SliceHeader,
    SLICE_B, SLICE_I, SLICE_P,
    write_pps, write_sps, write_vps, write_slice_header,
)


def _level_for(width: int, height: int, fps: float) -> int:
    """Pick a general_level_idc (spec A.4 main-tier luma sample limits)."""
    ls = width * height
    rate = ls * fps
    table = [  # (level_idc, MaxLumaPs, MaxLumaSr)
        (30, 36864, 552960), (60, 122880, 3686400), (63, 245760, 7372800),
        (90, 552960, 16588800), (93, 983040, 33177600),
        (120, 2228224, 66846720), (123, 2228224, 133693440),
        (150, 8912896, 267386880), (153, 8912896, 534773760),
        (156, 8912896, 1069547520), (180, 35651584, 1069547520),
        (183, 35651584, 2139095040), (186, 35651584, 4278190080),
    ]
    for idc, max_ps, max_sr in table:
        if ls <= max_ps and rate <= max_sr:
            return idc
    return 186


# spec Table A.8/A.9 rate limits per level_idc:
# (MaxLumaPs, MaxLumaSr, MaxBR main kbps, MaxBR high kbps,
#  MaxCPB main kb, MaxCPB high kb); high == 0 => no high tier at level
_LEVEL_LIMITS = {
    30: (36864, 552960, 128, 0, 350, 0),
    60: (122880, 3686400, 1500, 0, 1500, 0),
    63: (245760, 7372800, 3000, 0, 3000, 0),
    90: (552960, 16588800, 6000, 0, 6000, 0),
    93: (983040, 33177600, 10000, 0, 10000, 0),
    120: (2228224, 66846720, 12000, 30000, 12000, 30000),
    123: (2228224, 133693440, 20000, 50000, 20000, 50000),
    150: (8912896, 267386880, 25000, 100000, 25000, 100000),
    153: (8912896, 534773760, 40000, 160000, 40000, 160000),
    156: (8912896, 1069547520, 60000, 240000, 60000, 240000),
    180: (35651584, 1069547520, 60000, 240000, 60000, 240000),
    183: (35651584, 2139095040, 120000, 480000, 120000, 480000),
    186: (35651584, 4278190080, 240000, 800000, 240000, 800000),
}


def _load_rpu_file(path: str):
    """Read a Dolby Vision RPU file -> list of per-frame NAL payloads
    (display order). Accepts the common interchange formats: Annex-B
    framed NAL_UNSPEC62 units (dovi_tool output / x265's input format)
    or 4-byte big-endian length-prefixed payloads."""
    with open(path, "rb") as f:
        data = f.read()
    out = []
    if b"\x00\x00\x01" in data[:8]:
        from x265_tpu_torch.hevc.bitstream import split_annexb
        for nal in split_annexb(data):
            out.append(nal)
    else:
        i = 0
        while i + 4 <= len(data):
            ln = int.from_bytes(data[i:i + 4], "big")
            i += 4
            if ln <= 0 or i + ln > len(data):
                break
            out.append(data[i:i + ln])
            i += ln
    return out


def _enforce_level(p, level_idc: int) -> None:
    """x265 enforceLevel analog (level.cpp:290): a user-requested
    --level-idc must fit the picture size/rate (hard error otherwise),
    and the rate-control knobs are clamped to the level's MaxBR/MaxCPB;
    ABR without an explicit VBV gets the level-mandated one."""
    from x265_tpu_torch.api.params import RC_ABR, _warn
    lim = _LEVEL_LIMITS.get(level_idc)
    if lim is None:
        raise ValueError(f"unknown level_idc {level_idc}")
    max_ps, max_sr, br_m, br_h, cpb_m, cpb_h = lim
    fps = p.fps_num / max(1, p.fps_den)
    if p.width * p.height > max_ps or p.width * p.height * fps > max_sr:
        raise ValueError(
            f"picture size/rate out of range for level {level_idc / 30:.1f}"
            f" ({p.width}x{p.height}@{fps:g})")
    if p.high_tier and not br_h:
        _warn(p, f"level {level_idc / 30:.1f} has no high tier — "
              "using main tier")
        p.high_tier = False
    max_br = br_h if p.high_tier else br_m
    max_cpb = cpb_h if p.high_tier else cpb_m
    if p.bitrate > max_br:
        _warn(p, f"bitrate {p.bitrate} exceeds level limit — "
              f"clamping to {max_br} kbps")
        p.bitrate = max_br
    if p.vbv_maxrate > max_br:
        _warn(p, f"vbv-maxrate clamped to level limit {max_br} kbps")
        p.vbv_maxrate = max_br
    if p.vbv_bufsize > max_cpb:
        _warn(p, f"vbv-bufsize clamped to level CPB limit {max_cpb} kb")
        p.vbv_bufsize = max_cpb
    if p.rc_mode == RC_ABR and not p.vbv_maxrate and not p.vbv_bufsize:
        # a level claim is an HRD promise: give ABR the level-mandated
        # buffer so the claim is enforceable (level.cpp:363)
        p.vbv_maxrate = max_br
        p.vbv_bufsize = max_cpb


def _check_supported(p) -> None:
    """Raise NotImplementedError, naming the option, for everything this
    port does not encode yet — never silently encode something else."""
    bad = []
    if p.ref > 4:
        # the native writer codes ref_idx against at most 4 references
        # a list while the slice header announces them all: the JAX
        # package's streams with ref 5 (the slower presets) desync a
        # decoder at the first ref_idx
        bad.append(f"ref {p.ref} (more than 4)")
    if p.bit_depth not in (8, 10):
        bad.append(f"bit_depth {p.bit_depth}")
    if bad:
        raise NotImplementedError(
            "x265_tpu_torch does not support yet: " + ", ".join(bad))


class Encoder:
    def __init__(self, param: Param, device=None):
        """device=None means the CUDA device (raises when there is none);
        the CPU tests pass device="cpu"."""
        from x265_tpu_torch.utils.device import resolve_device
        self.param = check_params(param.copy())
        p = self.param
        _check_supported(p)
        self.device = resolve_device(device)
        fps = p.fps_num / max(1, p.fps_den)
        if p.level_idc and not p.allow_non_conformance:
            _enforce_level(p, p.level_idc)
        ptl = ProfileTierLevel(
            profile_idc=2 if p.bit_depth == 10 else 1,
            tier_flag=1 if p.high_tier else 0,
            level_idc=p.level_idc or _level_for(p.width, p.height, fps),
        )
        # GOP structure: IDR + P anchors every bframes+1 pictures, B
        # pictures in between (RPS written inline per slice); keyint 1
        # is all-intra (every picture an IDR)
        self.ipp = p.keyint != 1
        self.bframes = p.bframes if self.ipp else 0
        self.pyramid = p.b_pyramid and self.bframes >= 3
        reorder = (2 if self.pyramid else 1) if self.bframes else 0
        # DPB size must cover every retained picture: up to p.ref anchors
        # + the pyramid's referenced B + the current picture (libde265
        # enforces sps_max_dec_pic_buffering strictly)
        if not self.ipp:
            dpb = 1
        else:
            refs_kept = max(1, p.ref) + (1 if self.pyramid else 0)
            dpb = min(8, refs_kept + 1 + (1 if self.bframes else 0))
        self.vps = VPS(max_dec_pic_buffering=dpb, num_reorder_pics=reorder,
                       ptl=ptl)
        self.sps = SPS(
            chroma_format_idc=1,
            width=p.width, height=p.height,
            bit_depth=p.bit_depth,
            log2_max_poc_lsb=max(4, min(16, p.log2_max_poc_lsb)),
            max_dec_pic_buffering=dpb,
            num_reorder_pics=reorder,
            short_term_rps=[],
            log2_min_cb=p.min_cb_log2,
            log2_diff_max_min_cb=p.ctb_log2 - p.min_cb_log2,
            log2_min_tb=2,
            log2_diff_max_min_tb=min(p.ctb_log2, 5) - 2,
            max_transform_hierarchy_depth_inter=p.tu_inter_depth - 1,
            max_transform_hierarchy_depth_intra=p.tu_intra_depth - 1,
            amp_enabled=p.amp,
            sao_enabled=p.sao,
            strong_intra_smoothing=p.intra_smoothing,
            vui_present=p.vui_timing_info,
            fps_num=p.fps_num, fps_den=p.fps_den,
            ptl=ptl,
            # --scaling-list default: enabled with no data present =>
            # the spec's default matrices (sps_infer_scaling_list;
            # scalinglist.cpp:417 setDefaultScalingList)
            scaling_list_enabled=bool(p.scaling_lists),
            # --frame-dup signals dropped duplicates via pic_struct
            frame_field_info=p.frame_dup,
        )
        # HDR10 / colour description (x265 Encoder::configure vui wiring)
        from x265_tpu_torch.api.params import (
            COLOUR_PRIMARIES, MATRIX_COEFFS, TRANSFER_CHARACTERISTICS)
        if p.hdr10 and not p.colorprim:
            p.colorprim, p.transfer, p.colormatrix = (
                "bt2020", "smpte2084", "bt2020nc")
        if p.colorprim:
            self.sps.colour_primaries = COLOUR_PRIMARIES[p.colorprim.lower()]
        if p.transfer:
            self.sps.transfer_characteristics = (
                TRANSFER_CHARACTERISTICS[p.transfer.lower()])
        if p.colormatrix:
            self.sps.matrix_coeffs = MATRIX_COEFFS[p.colormatrix.lower()]
        self.sps.video_full_range = p.video_full_range
        self.sps.chroma_loc = p.chromaloc
        if p.videoformat:
            from x265_tpu_torch.api.params import VIDEO_FORMATS
            self.sps.video_format = VIDEO_FORMATS[p.videoformat.lower()]
        if p.sar:
            from x265_tpu_torch.api.params import SAR_TABLE
            s_ = p.sar.strip().lower()
            if s_ in SAR_TABLE:
                self.sps.sar_idc = SAR_TABLE[s_]
            elif ":" in s_:
                ww, hh = (int(v) for v in s_.split(":"))
                self.sps.sar_idc, self.sps.sar_width, \
                    self.sps.sar_height = 255, ww, hh
            else:
                self.sps.sar_idc = int(s_)
        if (p.colorprim or p.transfer or p.colormatrix
                or p.video_full_range or p.chromaloc >= 0
                or p.sar or p.videoformat):
            self.sps.vui_present = True
        self.sps.temporal_mvp_enabled = p.tmvp
        if p.hrd and p.vbv_maxrate > 0 and p.vbv_bufsize > 0:
            # HRD signalling from the VBV config (x265 --hrd, hrd.cpp)
            self.sps.hrd_bitrate = p.vbv_maxrate * 1000
            self.sps.hrd_cpb_size = p.vbv_bufsize * 1000
            self.sps.vui_present = True
        self._poc_mask = (1 << self.sps.log2_max_poc_lsb) - 1
        self.pps = PPS(
            weighted_pred=p.weightp,
            sign_data_hiding=p.sign_hide and not p.lossless,
            init_qp=26,
            cb_qp_offset=p.cb_qp_offset,
            cr_qp_offset=p.cr_qp_offset,
            transquant_bypass_enabled=p.lossless,
            transform_skip_enabled=p.tskip,
            cu_qp_delta_enabled=bool((p.aq_mode > 0 or p.cu_tree)
                                     and not p.lossless),
            diff_cu_qp_delta_depth=0,          # QG == CTB
            deblocking_filter_control_present=(
                not p.deblock or p.deblock_beta_offset != 0
                or p.deblock_tc_offset != 0),
            deblocking_filter_disabled=not p.deblock,
            beta_offset_div2=p.deblock_beta_offset,
            tc_offset_div2=p.deblock_tc_offset,
            loop_filter_across_slices=True,
            entropy_coding_sync_enabled=bool(p.wpp),
        )
        self.poc = 0                 # POC of the next display-order frame
        self.frame_count = 0         # display-order intake counter
        self.frames_since_idr = 0
        self._gop_base = 0           # display index of POC 0 of current CVS
        # recon sink: called (display_index, (y, cb, cr)) per finished
        # picture in encode order
        self.recon_sink = None
        # x265_encoder_ctu_info analog: display-index -> [cty, cx] int QP
        # offset map, folded into that picture's qp_map (needs AQ/dqp on)
        self._ctu_info = {}
        # in-memory analysis reuse (x265_encoder_set_analysis_data /
        # x265_encoder_get_analysis_data, x265.h:2108-2170): a queue of
        # FrameDecisions consumed by intra frames, and the decisions the
        # most recent picture actually used
        self._analysis_queue = []
        self._last_analysis = None
        self._last_sao = None        # SaoParams of the most recent picture
        self._last_weights = None    # (luma, chroma) weights of the last P
        self._scenecut_frames = set()
        # --frame-dup: display-index -> pic_struct (7 doubling, 8
        # tripling) carried by that picture's pic_timing SEI; _emitted
        # tracks which display pictures already left the encoder (their
        # SEIs can no longer be amended)
        self._pic_struct = {}
        self._emitted = set()
        self._dup_prev = None        # luma of the previous input (frame-dup)
        self._hist_prev = None       # its luma histogram (hist-scenecut)
        # --intra-refresh: the next column to force intra, and the
        # recovery_point SEI count owed to the next P access unit
        self._ir_col = 0
        self._ir_recovery = None
        # display index of each queued POC (diverges from _gop_base + poc
        # once --frame-dup drops inputs)
        self._input_idx = {}
        # HDR10+ dynamic metadata (--dhdr10-info): per-display-frame ST
        # 2094-40 JSON entries -> one prefix SEI per AU (x265 dynamicHDR10)
        self._dhdr10 = None
        self._dhdr10_last = None
        if p.dhdr10_info:
            from x265_tpu_torch.hevc.dhdr10 import load_dhdr10_json
            self._dhdr10 = load_dhdr10_json(p.dhdr10_info)
        # Dolby Vision RPU passthrough: one NAL_UNSPEC62 unit per display
        # picture, appended at the end of its access unit
        self._dovi_rpus = None
        if p.dolby_vision_rpu:
            self._dovi_rpus = _load_rpu_file(p.dolby_vision_rpu)
            if p.dolby_vision_profile:
                from x265_tpu_torch.api.params import _warn
                _warn(p, "dolby-vision-profile accepted for signalling "
                      "intent only — RPUs are passed through unmodified")
        self.anchor = None           # (poc, (y, cb, cr)) last anchor recon
        self._colmv = {}             # poc -> ColCtx (TMVP source fields)
        # DCT-domain noise reduction accumulators (frameencoder.cpp:2098)
        self._nr = ({"sum": np.zeros((16, 1024), np.uint64),
                     "cnt": np.zeros(16, np.uint64)}
                    if (p.nr_intra or p.nr_inter) and not p.lossless
                    else None)
        self.anchors = []            # retained anchors, nearest first
        # queued (poc, frame, cost, lookahead record, lowres plane)
        self.pending = []
        self._bdec_cache = {}        # poc -> leaf-B decisions of a batch
        self._bref_recon = None      # recon of the last referenced B
        self._zero_ref = None        # (pad, all-zero padded planes)
        # differential-test hook: False routes the deblock through the
        # numpy reference (hevc/deblock.py) instead of the device
        self.use_tpu_loopfilter = True
        # the reference switches, read where the JAX package reads them:
        # False runs the numpy intra analysis (engine.mode_decision; the
        # CLI's --no-tpu), the Python writer (engine.ctu_writer, the
        # oracle the native writer is held against), or the native
        # walk's own quantization of every TB in place of the device's
        # inter residual. The last two give the same stream (the device
        # residual differs only under tu-inter-depth 2, as in the JAX
        # package); the first decides intra CUs by another analysis
        self.use_tpu_analysis = True
        self.use_native = True
        self.use_tpu_residual = True
        # optional device mesh: analysis shards over CTU-row bands
        # (attach_mesh)
        self.mesh = None
        from x265_tpu_torch.engine.lookahead import Lookahead
        from x265_tpu_torch.engine.ratecontrol import RateControl
        self.rc = RateControl(p)
        self.vbv_reencodes = 0       # pictures coded again under VBV
        self.la = Lookahead(p.width, p.height, p.bit_depth,
                            device=self.device)
        self._anchor_low = None      # lowres plane of the last anchor
        self._cutree = {}            # poc -> per-CTB cuTree QP offsets
        self.frame_stats = []        # per-frame records in encode order
        self._awriter = self._areader = None
        # --qpfile: "frameNumber frameType QP" per line (display order;
        # x265 CLIOptions::parseQPFile). Type I/K forces a keyframe; the
        # QP (when >= 0) overrides rate control for that picture.
        self._qpfile = {}
        if p.qpfile:
            warned_types = set()
            with open(p.qpfile) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) < 2 or parts[0].startswith("#"):
                        continue
                    try:
                        idx = int(parts[0])
                        typ = parts[1]       # case-significant: 'I' IDR,
                        #                      'i'/'K' keyframe (CRA ok)
                        qpv = int(parts[2]) if len(parts) > 2 else -1
                    except ValueError:
                        from x265_tpu_torch.api.params import _warn
                        _warn(p, f"qpfile: skipping unparsable line: "
                              f"{line.strip()!r}")
                        continue
                    if typ in ("P", "B", "b") and typ not in warned_types:
                        warned_types.add(typ)
                        from x265_tpu_torch.api.params import _warn
                        _warn(p, "qpfile: P/B/b slice-type forcing is not "
                              "supported (only I/i/K keyframes); the QP "
                              "override is still honored")
                    self._qpfile[idx] = (typ, qpv)
        if p.analysis_save:
            from x265_tpu_torch.api.analysis_io import AnalysisWriter
            self._awriter = AnalysisWriter(p.analysis_save)
        if p.analysis_load:
            from x265_tpu_torch.api.analysis_io import AnalysisReader
            self._areader = AnalysisReader(p.analysis_load)
            if p.scale_factor == 2:
                # --scale-factor 2: analysis saved at half resolution
                # seeds this 2x encode (cli.rst:942-980 save/load chain)
                from x265_tpu_torch.api.analysis_io import upscale_decisions
                rdr = self._areader

                class _Scaled:
                    def get(self, _r=rdr, _c=p.ctb_log2):
                        d = _r.get()
                        if d is None:
                            return None
                        d = upscale_decisions(d, 2, _c)
                        intra = (np.ones(d.cu_log2_map.shape, bool)
                                 if d.inter8 is None else d.inter8 == 0)
                        if (d.cu_log2_map[intra] > 5).any():
                            # the JAX package fails here too (its writer
                            # asserts): no intra TU split above 32x32
                            raise NotImplementedError(
                                "--scale-factor 2 made a 64x64 intra CU "
                                "of a saved 32x32 one; the writer codes "
                                "intra CUs up to 32x32 (use --ctu 32)")
                        return d

                    def close(self, _r=rdr):
                        _r.close()

                self._areader = _Scaled()

    # -- public API --

    def headers(self) -> bytes:
        """x265_encoder_headers analog: VPS/SPS/PPS as one Annex-B chunk."""
        p = self.param
        nals = [
            make_nal(NAL_VPS, write_vps(self.vps)),
            make_nal(NAL_SPS, write_sps(self.sps)),
            make_nal(NAL_PPS, write_pps(self.pps)),
        ]
        out = annexb(nals)
        # HDR10 static metadata rides prefix SEIs right after the
        # parameter sets (x265 Encoder::getStreamHeaders analog)
        from x265_tpu_torch.hevc import sei as sei_mod
        if p.info_sei:
            from x265_tpu_torch import __version__ as _ver
            # the text is the JAX package's, byte for byte: the two
            # packages' streams are compared whole
            out += annexb([sei_mod.user_data_unregistered_sei(
                f"x265-tpu {_ver} - TPU-native HEVC encoder - "
                f"options: {p.width}x{p.height} fps={p.fps_num}/"
                f"{p.fps_den} ctu={p.ctu_size} bframes={self.bframes} "
                f"ref={p.ref} rd={p.rd_level}")])
        if p.master_display:
            out += annexb([sei_mod.mastering_display_sei(p.master_display)])
        if p.max_cll:
            cll, fall = (int(v) for v in p.max_cll.split(","))
            out += annexb([sei_mod.content_light_level_sei(cll, fall)])
        return out


    def encode_frame(self, y: np.ndarray, cb: np.ndarray,
                     cr: np.ndarray,
                     decisions: Optional[FrameDecisions] = None) -> bytes:
        """Submit one display-order picture; returns any access units that
        completed (decode order) — possibly none while B frames queue, or
        several when an anchor closes a mini-GOP (x265_encoder_encode
        latency contract, api.cpp:410)."""
        p = self.param
        if np.shape(y) != (p.height, p.width):
            raise ValueError(f"luma plane is {np.shape(y)}, the encoder was "
                             f"opened for {(p.height, p.width)}")
        frame = (np.asarray(y), np.asarray(cb), np.asarray(cr))
        frame = self._clip_input(frame)
        out = b""
        is_idr = (self.frame_count == 0 or
                  (p.keyint > 0 and self.frames_since_idr >= p.keyint))
        qpf_entry = self._qpfile.get(self.frame_count)
        # --frame-dup (encoder.cpp:1602 analog): a picture whose luma
        # PSNR against the previous input reaches dup-threshold is
        # dropped, and the previous picture's pic_timing SEI signals
        # frame doubling (7) / tripling (8) so presentation timing is
        # unchanged. Only possible while the previous picture is still
        # queued (its SEIs are not yet written).
        if (p.frame_dup and not is_idr and qpf_entry is None
                and self._dup_prev is not None):
            prev_idx = self.frame_count - 1
            ps_now = self._pic_struct.get(prev_idx, 0)
            if prev_idx not in self._emitted and ps_now != 8:
                from x265_tpu_torch.utils.metrics import psnr
                if (psnr(np.asarray(y), self._dup_prev, p.bit_depth)
                        >= p.dup_threshold):
                    self._pic_struct[prev_idx] = 8 if ps_now == 7 else 7
                    self.frame_count += 1
                    return b""
        self._dup_prev = np.asarray(y).copy() if p.frame_dup else None
        qp_forced = None
        force_closed = False          # 'I' = IDR even with --open-gop
        if qpf_entry is not None:
            if qpf_entry[0] in ("I", "i", "K"):
                is_idr = True
                force_closed = qpf_entry[0] == "I"
            if qpf_entry[1] >= 0:
                qp_forced = qpf_entry[1]
        # lookahead: needed by rate control and/or scenecut detection
        from x265_tpu_torch.api.params import RC_CQP
        need_la = (self.rc.mode != RC_CQP or
                   (p.scenecut > 0 and p.keyint != 1 and not p.lossless))
        if need_la:
            from x265_tpu_torch.utils.profiling import scope
            with scope("lookahead"):
                cost, icost, pcost = self.la.frame_costs(frame[0], is_idr)
        else:
            cost, icost, pcost = 1.0, 1.0, 0.0
        # scenecut (slicetype.cpp:2186 analog): the inter path barely beats
        # intra => new scene; respect min-keyint
        min_ki = p.min_keyint or (self.bframes + 1)
        # --scenecut-bias scales the threshold (x265 scenecutBias is a
        # percentage, slicetype.cpp:2279; default 5.0 == our baseline)
        sc_thresh = (p.scenecut / 400.0) * (p.scenecut_bias / 5.0)
        if (not is_idr and p.scenecut > 0 and
                self.frames_since_idr >= min_ki and
                pcost >= (1.0 - sc_thresh) * icost):
            is_idr = True
            self._scenecut_frames.add(self.frame_count)
        if (not is_idr and p.hist_scenecut and
                self.frames_since_idr >= min_ki and
                self._hist_scenecut(frame[0])):
            # histogram-based detector (x265 --hist-scenecut,
            # encoder.cpp:1602 computeHistogramSAD): normalized luma
            # histogram distance against the previous frame
            is_idr = True
            self._scenecut_frames.add(self.frame_count)
        self._hist_prev = (self._luma_hist(frame[0])
                           if p.hist_scenecut else None)
        self.frame_count += 1
        if is_idr:
            if (p.open_gop and not force_closed and self.ipp
                    and self.anchor is not None and self.frame_count > 1):
                # open GOP (x265 default; dpb.cpp:229 getNalUnitType):
                # the keyframe is a CRA anchoring the open mini-GOP; the
                # queued pictures become RASL leading pictures (decode
                # after the CRA, display before it, reference across it)
                out += self._emit_minigop(cra=(frame, cost, qp_forced))
                self.frames_since_idr = 1
                self._anchor_low = self.la.last_low if need_la else None
                return out
            out += self.flush()               # close any open mini-GOP
            self.poc = 0
            # frame_count was already incremented for this intake, so the
            # IDR's display index (== new POC 0) is frame_count - 1
            self._gop_base = self.frame_count - 1
            self._input_idx = {0: self.frame_count - 1}
            self.frames_since_idr = 1
            qp = (self.rc.start_forced(SLICE_I, qp_forced, cost)
                  if qp_forced is not None
                  else self.rc.start(SLICE_I, cost))
            au = self._encode_intra_frame(*frame, decisions, qp=qp)
            au = self._vbv_reencode(au, lambda rq: self._encode_intra_frame(
                *frame, decisions, qp=rq))
            self.rc.end(len(au) * 8)
            out += au
            self.anchor = (0, self._last_recon)
            self.anchors = [self.anchor]
            self._anchor_low = self.la.last_low if need_la else None
            self.poc = 1
            return out
        self.frames_since_idr += 1
        rec = self.la.last_blocks if need_la else None
        low = self.la.last_low if need_la else None
        self._input_idx[self.poc] = self.frame_count - 1
        self.pending.append((self.poc, frame, cost, rec, low, qp_forced))
        self.poc += 1
        # queue depth: bframes+1 normally; with b-adapt the queue extends
        # to rc_lookahead frames so (a) anchor placement optimises over a
        # real window and (b) VBV/ABR see future complexity (x265
        # slicetypeAnalyse over the whole lookahead, slicetype.cpp:1867)
        depth = self.bframes + 1
        if self.bframes and p.b_adapt and p.rc_lookahead > depth:
            depth = min(p.rc_lookahead, 32)
        if p.frame_dup:
            # one extra queued picture so a duplicate's predecessor is
            # still unemitted when the duplicate arrives (its pic_timing
            # SEI can then signal the doubling)
            depth += 1
        if len(self.pending) >= depth:
            out += self._emit_minigop()
        return out

    def _clip_input(self, frame):
        """--min-luma/--max-luma: clip the source luma range (x265
        planeClipAndMax, applied at picture intake)."""
        p = self.param
        if p.min_luma < 0 and p.max_luma < 0:
            return frame
        lo = p.min_luma if p.min_luma >= 0 else 0
        hi = p.max_luma if p.max_luma >= 0 else (1 << p.bit_depth) - 1
        return (np.clip(frame[0], lo, hi), frame[1], frame[2])

    def flush(self) -> bytes:
        """Encode all queued frames (end of stream / before an IDR)."""
        out = b""
        while self.pending:
            out += self._emit_minigop()
        return out

    def flush_step(self) -> bytes:
        """Incremental flush: encode ONE queued mini-GOP and return its
        access units (the analog of x265_encoder_encode's pic_in=NULL
        drain contract, api.cpp:410 — each call returns a bounded chunk
        instead of the whole tail at once). Returns b"" when drained."""
        if not self.pending:
            return b""
        return self._emit_minigop()

    def reconfigure(self, **kwargs) -> None:
        """x265_encoder_reconfig analog (api.cpp:307): swap rate-control
        and analysis knobs mid-stream. Only settings that do not change
        the parameter sets are accepted (qp/crf/bitrate/aq/scenecut/...).
        """
        allowed = {"qp", "crf", "bitrate", "aq_mode", "aq_strength",
                   "scenecut", "me_range", "sub_me", "bframes",
                   "vbv_maxrate", "vbv_bufsize", "psnr_metrics"}
        bad = set(kwargs) - allowed
        if bad:
            raise ValueError(f"not reconfigurable mid-stream: {sorted(bad)}")
        for k, v in kwargs.items():
            setattr(self.param, k, v)
        if {"qp", "crf", "bitrate", "vbv_maxrate",
                "vbv_bufsize"} & set(kwargs):
            from x265_tpu_torch.engine.ratecontrol import RateControl
            self.rc = RateControl(self.param)
        if "bframes" in kwargs:
            self.bframes = kwargs["bframes"] if self.ipp else 0

    def close(self) -> None:
        """End of encode: write 2-pass stats / close analysis files
        (x265_encoder_close analog)."""
        self.rc.write_stats()
        if self._awriter is not None:
            self._awriter.close()
            self._awriter = None

    def _emit_minigop(self, cra=None) -> bytes:
        """One queued frame becomes the P anchor (coded first), earlier
        frames become B pictures between the two anchors. With --b-adapt
        the anchor position comes from a lowres cost search over the
        window (slicetypePath reduced to one mini-GOP); without it, the
        whole queue forms one GOP (fixed bframes).

        cra=(frame, cost, qp_forced): open-GOP keyframe — the given
        frame anchors this mini-GOP as a CRA intra picture and every
        queued picture is coded as a RASL_N leading picture."""
        from x265_tpu_torch.hevc.bitstream import NAL_CRA, NAL_RASL_N
        from x265_tpu_torch.utils.profiling import scope
        p = self.param
        queue = self.pending
        leftover = []
        if cra is not None:
            cra_frame, cra_cost, cra_qpf = cra
            cra_poc = self.poc
            self._input_idx[cra_poc] = self.frame_count - 1
            self.poc += 1
            bs = queue
            self.pending = []
            prev_anchor = self.anchor
            qp = (self.rc.start_forced(SLICE_I, cra_qpf, cra_cost)
                  if cra_qpf is not None
                  else self.rc.start(SLICE_I, cra_cost))
            # the CRA's RPS must KEEP the prior anchors alive (used=0):
            # its leading RASL pictures reference them, and an empty RPS
            # would evict them from a conformant decoder's DPB
            keep = sorted((a[0] for a in self.anchors), reverse=True)
            au = self._encode_intra_frame(*cra_frame, qp=qp, poc=cra_poc,
                                          nal_type=NAL_CRA,
                                          keep_pocs=keep)
            # VBV emergency re-encode: scene-cut CRAs are exactly the
            # pictures that blow a tight buffer (see the IDR/P paths)
            au = self._vbv_reencode(au, lambda rq: self._encode_intra_frame(
                *cra_frame, qp=rq, poc=cra_poc, nal_type=NAL_CRA,
                keep_pocs=keep))
            self.rc.end(len(au) * 8)
            out = au
            new_anchor = (cra_poc, self._last_recon)
            out += self._run_b_pipeline(
                [(frame_b, poc_b, prev_anchor, new_anchor, cost_b, qpf_b,
                  dict(nal_override=NAL_RASL_N))
                 for (poc_b, frame_b, cost_b, _rec, _low, qpf_b) in bs])
            # random-access point: nothing before the CRA may be
            # referenced afterwards
            self.anchor = new_anchor
            self.anchors = [new_anchor]
            return out
        if (p.b_adapt and len(queue) > 1 and self._anchor_low is not None
                and all(e[4] is not None for e in queue)):
            from x265_tpu_torch.engine.lookahead import slicetype_split
            # anchor placement optimises over the real lookahead window
            # (x265 slicetypeAnalyse spans the whole lookahead,
            # slicetype.cpp:1867); only the host-side DP is
            # O(window^2 * bframes)
            win = queue[:max(2 * (self.bframes + 1),
                             min(p.rc_lookahead, 32))]
            with scope("slicetype"):
                k = slicetype_split(self._anchor_low,
                                    [e[4] for e in win],
                                    max_bs=self.bframes,
                                    b_discount=0.9
                                    * (1.0 - p.bframe_bias / 100.0),
                                    device=self.device)
            leftover = queue[k + 1:]
            queue = queue[:k + 1]
        (anchor_poc, anchor_frame, anchor_cost, anchor_rec, anchor_low,
         anchor_qpf) = queue[-1]
        bs = queue[:-1]
        self.pending = leftover
        self._anchor_low = anchor_low
        prev_anchor = self.anchor
        # cuTree: credit the anchor for the mini-GOP frames that will
        # reference it (its B frames via L1). The lowres records hold
        # prev-frame MVs, so the propagation chain runs over the reversed
        # display order with mirrored MVs (slicetype.cpp:2479 analog).
        self._cutree = {}
        if (p.cu_tree and anchor_rec is not None and
                self.pps.cu_qp_delta_enabled and
                all(e[3] is not None for e in bs)):
            from x265_tpu_torch.engine.lookahead import cutree_propagate
            recs = [anchor_rec] + [
                {"icost": e[3]["icost"], "mcost": e[3]["mcost"],
                 "mv": -e[3]["mv"]} for e in reversed(bs)]
            off = cutree_propagate(recs, p.ctb_log2, self.rc.qcompress)
            if off is not None:
                self._cutree[anchor_poc] = off
                if self.rc.pass_num == 1:   # ride the stats file
                    self.rc.note_cutree(off)
        # VBV/ABR lookahead window: the mini-GOP's Bs + everything still
        # queued behind it (rateControlStart's updateVbvPlan analog)
        self.rc.set_lookahead(
            [(SLICE_B, e[2]) for e in bs]
            + [(SLICE_P if i % (self.bframes + 1) == self.bframes
                else SLICE_B, e[2]) for i, e in enumerate(leftover)])
        qp = (self.rc.start_forced(SLICE_P, anchor_qpf, anchor_cost)
              if anchor_qpf is not None
              else self.rc.start(SLICE_P, anchor_cost))
        if self.rc.pass_num == 2:     # reuse pass-1 cuTree offsets
            ct2 = self.rc.cutree_from_stats()
            if ct2 is not None:
                self._cutree[anchor_poc] = ct2
        out = self._encode_p_frame(anchor_frame, anchor_poc,
                                   list(self.anchors), qp)
        # VBV emergency: band-graded re-encode(s) when the coded frame
        # would underflow the CPB (the whole-frame analog of x265's row
        # re-encode, ratecontrol.cpp:2526)
        out = self._vbv_reencode(out, lambda rq: self._encode_p_frame(
            anchor_frame, anchor_poc, list(self.anchors), rq))
        self.rc.end(len(out) * 8)
        new_anchor = (anchor_poc, self._last_recon)
        self.anchors.insert(0, new_anchor)
        del self.anchors[max(1, p.ref):]
        bref = None
        rest = bs
        if self.pyramid and len(bs) >= 3 and prev_anchor is not None:
            # B-pyramid (x265 --b-pyramid): the middle B is coded first as
            # a REFERENCED B (TRAIL_R); the remaining Bs predict from the
            # nearest anchors around them
            mid = len(bs) // 2
            poc_m, frame_m, cost_m = bs[mid][:3]
            qpf_m = bs[mid][5]
            # referenced B sits between P and leaf-B on the QP ladder
            qp = (self.rc.start_forced(SLICE_B, qpf_m, cost_m)
                  if qpf_m is not None
                  else max(0, self.rc.start(SLICE_B, cost_m) - 2))
            au = self._encode_b_frame(frame_m, poc_m, prev_anchor,
                                      new_anchor, qp, as_ref=True)
            self.rc.end(len(au) * 8)
            out += au
            bref = (poc_m, self._bref_recon)
            rest = bs[:mid] + bs[mid + 1:]
        sched = []
        for (poc_b, frame_b, cost_b, _rec, _low, qpf_b) in rest:
            if bref is not None:
                a0 = bref if bref[0] < poc_b else prev_anchor
                a1 = bref if bref[0] > poc_b else new_anchor
                # keep everything later Bs still need (both RPS sides)
                keep = [x for x in (bref[0], new_anchor[0], prev_anchor[0])
                        if x not in (a0[0], a1[0])]
            else:
                a0, a1, keep = prev_anchor, new_anchor, []
            sched.append((poc_b, frame_b, cost_b, a0, a1, keep, qpf_b))
        # batch the leaf-B analyses: one intra + one motion-search pass
        # per shared anchor pair, decided at an estimated QP before the
        # pictures' own rate-control start. With --analysis-load every
        # B picture takes its decisions from the file (the JAX package
        # runs this batch there too and drops its result)
        self._bdec_cache = {}
        groups = {}
        for it in sched:
            groups.setdefault((it[3][0], it[4][0]), []).append(it)
        for items in groups.values():
            if (len(items) >= 2 and self.use_tpu_analysis
                    and self._areader is None):
                self._precompute_b_batch(items, items[0][3][1],
                                         items[0][4][1])
        out += self._run_b_pipeline(
            [(frame_b, poc_b, a0, a1, cost_b, qpf_b, dict(extra_keep=keep))
             for (poc_b, frame_b, cost_b, a0, a1, keep, qpf_b) in sched])
        self.anchor = new_anchor
        return out

    def _run_b_pipeline(self, items) -> bytes:
        """Encode independent B pictures with up to --frame-threads
        pictures in flight: picture N's loop filter on the device overlaps
        picture N+1's analysis and CPU entropy (x265 frame parallelism
        over one device queue; frameencoder.cpp:860-882). Rate-control
        starts and ends stay in picture order, ends lagging starts by the
        pipeline depth, exactly x265's frame-threads contract
        (ratecontrol.h:209-221).

        items: [(frame, poc, anchor0, anchor1, cost, qp_forced, kwargs)]
        """
        from collections import deque
        depth = max(1, int(self.param.frame_parallelism))

        class _Box:
            __slots__ = ("gen", "done", "value")

            def __init__(self, gen):
                self.gen, self.done, self.value = gen, False, None

            def advance(self):
                try:
                    next(self.gen)
                except StopIteration as e:
                    self.done, self.value = True, e.value

            def finish(self):
                while not self.done:
                    self.advance()
                return self.value

        out = []
        pipe = deque()

        def drain_one():
            au = pipe.popleft().finish()
            self.rc.end(len(au) * 8)
            out.append(au)

        for (frame_b, poc_b, a0, a1, cost_b, qpf_b, kw) in items:
            qp = (self.rc.start_forced(SLICE_B, qpf_b, cost_b)
                  if qpf_b is not None
                  else self.rc.start(SLICE_B, cost_b))
            box = _Box(self._encode_b_frame_gen(frame_b, poc_b, a0, a1,
                                                qp, **kw))
            box.advance()          # run to the in-flight yield point
            pipe.append(box)
            while len(pipe) >= depth:
                drain_one()
        while pipe:
            drain_one()
        return b"".join(out)

    def _vbv_reencode(self, au, rebuild):
        """Bounded VBV emergency loop: while the coded picture would
        underflow the CPB, re-encode at the RC's escalated QP (up to 3
        passes — one step rarely suffices on a scene-cut keyframe under
        a sub-second buffer). x265 analog: rowVbvRateControl's
        continuous mid-frame escalation, ratecontrol.cpp:2526. The new
        pass replaces the picture's stats record, recon, colocated
        motion and weights (each keyed or overwritten by the pass)."""
        for _ in range(3):
            rq = self.rc.reencode_qp(len(au) * 8)
            if rq is None:
                return au
            self.vbv_reencodes += 1
            self.frame_stats.pop()
            au = rebuild(rq)
        return au

    def _slice_qp(self, slice_type: int) -> int:
        """CQP per-type QP ladder (x265 ip/pb factor 1.4/1.3 analog,
        ratecontrol.cpp CQP path: I ~ qp-3, P = qp, non-ref B ~ qp+3)."""
        p = self.param
        if p.lossless:
            return p.qp
        zone = self.rc.zone_for()
        if zone is not None and "q" in zone:
            return max(0, min(51, zone["q"]))
        if slice_type == SLICE_I:
            return max(0, p.qp - 3)
        if slice_type == SLICE_B:
            return min(51, p.qp + 3)
        return p.qp

    def _frame_stats(self, frame, recon, slice_type, qp, bits, poc,
                     decisions=None):
        """Per-frame quality/bit accounting (x265 x265_frame_stats /
        csvlog_frame analog, api.cpp:1284)."""
        p = self.param
        st = {
            "poc": poc,
            "type": {SLICE_I: "I", SLICE_P: "P", SLICE_B: "B"}[slice_type],
            "qp": qp,
            "bits": bits,
            "psnr_y": 0.0, "psnr_u": 0.0, "psnr_v": 0.0, "ssim": 0.0,
        }
        if p.csv_log_level >= 2 and decisions is not None:
            # x265 csv-log-level 2: per-frame analysis breakdown
            # (api.cpp:1284 csvlog extended columns, re-imagined as CU
            # class statistics from the decision tensors)
            cl = decisions.cu_log2_map
            tot = cl.size
            if decisions.inter8 is not None:
                inter = float(decisions.inter8.astype(bool).mean())
            else:
                inter = 0.0
            st["cu_inter_pct"] = round(100.0 * inter, 2)
            st["cu_intra_pct"] = round(100.0 * (1.0 - inter), 2)
            st["avg_cu_size"] = round(float((1 << cl).mean()), 1)
            for lg in (3, 4, 5, 6):
                st[f"cu{1 << lg}_pct"] = round(
                    100.0 * float((cl == lg).mean()), 2)
        if p.psnr_metrics:            # x265 --psnr/--ssim (off by default:
            # host numpy over whole planes)
            from x265_tpu_torch.utils.metrics import psnr, ssim
            rec = tuple(np.asarray(x) for x in recon)
            st["psnr_y"] = psnr(frame[0], rec[0], p.bit_depth)
            st["psnr_u"] = psnr(frame[1], rec[1], p.bit_depth)
            st["psnr_v"] = psnr(frame[2], rec[2], p.bit_depth)
            st["ssim"] = ssim(frame[0], rec[0], p.bit_depth)
        self.frame_stats.append(st)
        self._emitted.add(self._disp_idx(poc))
        if self.recon_sink is not None:
            self.recon_sink(self._disp_idx(poc),
                            tuple(np.asarray(x) for x in recon))

    def _aud(self, slice_type: int) -> bytes:
        """Access unit delimiter NAL (--aud; 7.3.2.5)."""
        if not self.param.aud:
            return b""
        from x265_tpu_torch.hevc.bitstream import BitWriter, NAL_AUD
        bw = BitWriter()
        # pic_type: 0 = I only, 1 = I/P, 2 = I/P/B
        bw.write({SLICE_I: 0, SLICE_P: 1, SLICE_B: 2}[slice_type], 3)
        bw.byte_align_with_ones()
        return annexb([make_nal(NAL_AUD, bw.data())])

    def _hrd_sei(self, slice_type: int, poc: int = -1) -> bytes:
        """Per-AU HRD timing SEIs (D.3.2/D.3.3): buffering_period at each
        IDR, pic_timing on every picture. Delays use the simplified
        fixed-rate model (one CPB, delay unit = one AU tick); output
        delays are the reorder-depth bound, not an exact DPB schedule.
        With --frame-dup the pic_timing additionally carries pic_struct
        (doubling/tripling for pictures whose duplicates were dropped)."""
        ffi = self.sps.frame_field_info
        hrd = self.sps.hrd_bitrate > 0
        if not hrd and not ffi:
            return b""
        from x265_tpu_torch.hevc.sei import buffering_period_sei, pic_timing_sei
        out = b""
        if hrd and slice_type == SLICE_I:
            d = int(90000 * 0.9 * self.sps.hrd_cpb_size
                    / self.sps.hrd_bitrate)
            out += annexb([buffering_period_sei(d)])
            self._au_since_bp = 0
        n = getattr(self, "_au_since_bp", 0)
        reorder = self.sps.num_reorder_pics
        dpb_delay = 0 if slice_type == SLICE_B else reorder + 1
        ps = (self._pic_struct.pop(self._disp_idx(poc), 0)
              if (ffi and poc >= 0) else (0 if ffi else None))
        out += annexb([pic_timing_sei(max(0, n - 1) if n else 0,
                                      dpb_delay, pic_struct=ps,
                                      with_delays=hrd)])
        self._au_since_bp = n + 1
        return out

    def _dhdr10_sei(self, poc: int, slice_type: int) -> bytes:
        """HDR10+ (ST 2094-40) prefix SEI for this picture (x265
        --dhdr10-info, dynamicHDR10/hdr10plus.h). Metadata is indexed by
        display order; with --dhdr10-opt the SEI is emitted only on
        keyframes and when the tone-mapping payload changes (x265's
        hdr10plus-opt behavior)."""
        if not self._dhdr10:
            return b""
        idx = self._disp_idx(poc)
        if idx >= len(self._dhdr10):
            return b""
        from x265_tpu_torch.hevc.dhdr10 import dhdr10_sei, pack_st2094_40
        meta = self._dhdr10[idx]
        if self.param.dhdr10_opt and slice_type != SLICE_I:
            payload = pack_st2094_40(meta)
            if payload == self._dhdr10_last:
                return b""
            self._dhdr10_last = payload
        elif self.param.dhdr10_opt:
            self._dhdr10_last = pack_st2094_40(meta)
        return annexb([dhdr10_sei(meta)])

    def _dovi_rpu(self, poc: int) -> bytes:
        """The display picture's Dolby Vision RPU as a NAL_UNSPEC62 unit
        at the end of the AU (DV bitstream carriage)."""
        if not self._dovi_rpus:
            return b""
        idx = self._disp_idx(poc)
        if idx >= len(self._dovi_rpus):
            return b""
        unit = self._dovi_rpus[idx]
        if not (len(unit) >= 2 and (unit[0] >> 1) & 0x3F == 62):
            from x265_tpu_torch.hevc.bitstream import make_nal
            unit = make_nal(62, unit)
        return annexb([unit])

    def _hash_sei(self, recon) -> bytes:
        """Decoded-picture-hash suffix SEI (MD5) of the loop-filtered
        recon (x265 frameencoder.cpp:1167)."""
        if self.param.decoded_picture_hash != 1:
            return b""
        from x265_tpu_torch.hevc.sei import decoded_picture_hash_sei
        return annexb([decoded_picture_hash_sei(
            tuple(np.asarray(x) for x in recon), self.param.bit_depth)])

    def _disp_idx(self, poc: int) -> int:
        """Display (input) index of a POC — tracks --frame-dup drops."""
        return self._input_idx.get(poc, self._gop_base + poc)

    @staticmethod
    def _luma_hist(y) -> np.ndarray:
        """256-bin histogram of y >> 2 at every bit depth, as the
        reference bins it (a 10-bit picture's bins reach 255, an 8-bit
        picture's stop at 63)."""
        return np.bincount((np.asarray(y) >> 2).reshape(-1).astype(np.int64),
                           minlength=256).astype(np.float64)

    def _hist_scenecut(self, y) -> bool:
        """Normalized luma-histogram SAD vs the previous frame (x265
        --hist-scenecut, encoder.cpp computeHistogramSAD)."""
        h = self._luma_hist(y)
        prev = self._hist_prev
        if prev is None:
            return False
        sad = np.abs(h - prev).sum() / max(1.0, h.sum())
        thr = 0.35 * (self.param.hist_threshold / 0.03)
        return sad > thr     # --hist-threshold (rescaled to this metric)

    # -- encoder query/control API (x265.h:2108-2186 analogs) --

    def get_slicetype_poc_and_scenecut(self):
        """x265_encoder_get_slicetype_poc_and_scenecut: slice type, POC
        and scenecut state of the most recently output picture."""
        if not self.frame_stats:
            return None
        st = self.frame_stats[-1]
        return {"slice_type": st["type"], "poc": st["poc"],
                "scenecut": self._disp_idx(st["poc"])
                in self._scenecut_frames}

    def get_ref_frame_list(self):
        """x265_encoder_get_ref_frame_list: POCs of the pictures the
        next P anchor would reference (L0, nearest first), plus the
        B-pyramid mid reference when alive."""
        l0 = [poc for (poc, _rec) in self.anchors]
        l1 = []
        if self._bref_recon is not None:
            l1 = [max(l0) + 1] if l0 else []
        return {"l0": l0, "l1": l1}

    def set_analysis_data(self, decisions) -> None:
        """x265_encoder_set_analysis_data: queue FrameDecisions for the
        upcoming intra pictures (the in-memory twin of --analysis-load;
        inter analysis reuse remains file-based)."""
        if isinstance(decisions, FrameDecisions):
            decisions = [decisions]
        self._analysis_queue.extend(decisions)

    def get_analysis_data(self):
        """x265_encoder_get_analysis_data: the FrameDecisions the most
        recent picture was coded with."""
        return self._last_analysis

    def set_ctu_info(self, display_idx: int, qp_offsets) -> None:
        """x265_encoder_ctu_info analog: per-CTU QP offsets (an ROI map,
        [pic_height_in_ctbs, pic_width_in_ctbs] ints) folded into that
        display picture's qp_map. Requires AQ/cu_qp_delta signalling."""
        if not self.pps.cu_qp_delta_enabled:
            from x265_tpu_torch.api.params import _warn
            _warn(self.param, "set_ctu_info needs cu_qp_delta "
                  "(enable AQ); the offsets will be ignored")
        self._ctu_info[display_idx] = np.asarray(qp_offsets, np.int32)

    @staticmethod
    def calculate_vmaf(*_args, **_kw):
        """x265_calculate_vmaf analog — libvmaf is not available in this
        build (x265 requires -DENABLE_LIBVMAF too). Use PSNR/SSIM from
        get_stats instead."""
        raise NotImplementedError(
            "VMAF requires libvmaf, which this build does not bundle; "
            "PSNR/SSIM are available via --psnr/--ssim and get_stats()")

    def get_stats(self):
        """x265_encoder_get_stats analog: global summary."""
        n = len(self.frame_stats)
        if n == 0:
            return {"frames": 0}
        fps = self.param.fps_num / max(1, self.param.fps_den)
        tot_bits = sum(s["bits"] for s in self.frame_stats)
        by_type = {}
        for t in ("I", "P", "B"):
            sub = [s for s in self.frame_stats if s["type"] == t]
            if sub:
                by_type[t] = {
                    "count": len(sub),
                    "avg_qp": sum(s["qp"] for s in sub) / len(sub),
                    "avg_bits": sum(s["bits"] for s in sub) / len(sub),
                    "avg_psnr_y": sum(s["psnr_y"] for s in sub) / len(sub),
                }
        out = {
            "frames": n,
            "bitrate_kbps": tot_bits * fps / n / 1000.0,
            "by_type": by_type,
        }
        if self.param.psnr_metrics:
            out["global_psnr_y"] = sum(s["psnr_y"]
                                       for s in self.frame_stats) / n
            out["global_ssim"] = sum(s["ssim"] for s in self.frame_stats) / n
        return out

    def _encode_intra_frame(self, y, cb, cr, decisions=None, qp=None,
                            poc=0, nal_type=NAL_IDR_W_RADL,
                            keep_pocs=()) -> bytes:
        p = self.param
        if qp is None:
            qp = self._slice_qp(SLICE_I)
        sh = SliceHeader(first_slice_in_pic=True, slice_type=SLICE_I, qp=qp)
        if nal_type != NAL_IDR_W_RADL:       # CRA: POC + keep-alive RPS
            sh.pic_order_cnt_lsb = poc & self._poc_mask
            sh.rps_in_sps = False
            sh.short_term_rps = ShortTermRPS(
                num_negative=len(keep_pocs),
                delta_poc_s0=[k - poc for k in keep_pocs],
                used_s0=[False] * len(keep_pocs))
        if decisions is None:
            if self._analysis_queue:
                decisions = self._analysis_queue.pop(0)
            elif self._areader:
                decisions = self._areader.get()
            else:
                decisions = self._intra_decisions(y)
                if p.rd_level >= 3:
                    # intra quadtree depth-1 RDO (compressIntraCU
                    # analog): promote 16-CU groups to 32 intra CUs
                    # where full T/Q/recon RD wins (models/intra_rdo)
                    from x265_tpu_torch.models.intra_rdo import \
                        rd_intra_promote32
                    from x265_tpu_torch.utils.profiling import scope
                    with scope("rd_promote"):
                        rd_intra_promote32(
                            (np.asarray(y), np.asarray(cb), np.asarray(cr)),
                            decisions, qp, p, device=self.device)
        slice_data, recon = self._inter_slice_data(
            (y, cb, cr), sh, decisions, ([], []), ((), ()), poc, SLICE_I)
        self._record_colmv(decisions, ((), ()), poc)
        self._last_recon = recon
        rp = b""
        if p.idr_recovery_sei:
            # --idr-recovery-sei: recovery point at every keyframe
            from x265_tpu_torch.hevc.sei import recovery_point_sei
            rp = annexb([recovery_point_sei(0)])
        au = (self._aud(SLICE_I) + self._hrd_sei(SLICE_I, poc) + rp
              + self._dhdr10_sei(poc, SLICE_I)
              + self._assemble_slices(slice_data, sh, nal_type)
              + self._hash_sei(recon) + self._dovi_rpu(poc))
        self._frame_stats((y, cb, cr), recon, SLICE_I, sh.qp,
                          len(au) * 8, poc, decisions)
        return au


    def _assemble_slices(self, payload, sh, nal_type) -> bytes:
        """One or many slice NALs from _inter_slice_data's payload."""
        if isinstance(payload, (bytes, bytearray)):
            hdr = write_slice_header(sh, self.sps, self.pps, nal_type)
            return annexb([make_nal(nal_type, hdr.data() + payload)])
        out = b""
        for (sh_i, data) in payload:
            hdr = write_slice_header(sh_i, self.sps, self.pps, nal_type)
            out += annexb([make_nal(nal_type, hdr.data() + data)])
        return out

    @staticmethod
    def _set_wpp_entry_points(sh, data, raw_sizes) -> None:
        """entry_point_offset values for a WPP payload: per-substream
        sizes measured in the escaped (EBSP) domain (spec 7.4.7.1; x265
        serializeSubstreams analog, frameencoder.cpp:1033). raw_sizes
        are the pre-escape substream byte sizes; the escaper's zero-run
        state carries across boundaries exactly as make_nal will."""
        from x265_tpu_torch.hevc.bitstream import escaped_sizes
        parts = []
        pos = 0
        for s in raw_sizes[:-1]:
            parts.append(data[pos:pos + s])
            pos += s
        sh.entry_point_offsets = escaped_sizes(parts)

    def _intra_decisions(self, y) -> FrameDecisions:
        p = self.param
        cu_log2 = 4 if p.ctb_log2 >= 4 else p.ctb_log2
        if self.mesh is not None:
            from x265_tpu_torch.parallel.tiles import mesh_intra_decisions
            return mesh_intra_decisions(self.mesh, y, p.width, p.height,
                                        cu_log2, p.fast_intra,
                                        psy=float(p.psy_rd))[0]
        if self.use_tpu_analysis:
            from x265_tpu_torch.models.intra_frame import (
                decide_intra_frame_tpu)
            return decide_intra_frame_tpu(
                np.asarray(y), p.width, p.height, cu_log2=cu_log2,
                fast=p.fast_intra, psy=float(p.psy_rd), device=self.device)
        from x265_tpu_torch.engine.mode_decision import decide_intra_frame
        return decide_intra_frame(
            np.asarray(y), p.width, p.height, p.ctb_log2, cu_log2=cu_log2,
            strong_smoothing=p.intra_smoothing, bit_depth=p.bit_depth)

    def _encode_p_frame(self, frame, poc, anchors, qp=None) -> bytes:
        """anchors: retained reference anchors, nearest first (the L0
        list; DPB::prepareEncode + computeRPS analog, dpb.cpp:126)."""
        p = self.param
        y, cb, cr = frame
        if qp is None:
            qp = self._slice_qp(SLICE_P)
        sh = SliceHeader(
            first_slice_in_pic=True,
            slice_type=SLICE_P,
            qp=qp,
            pic_order_cnt_lsb=poc & self._poc_mask,
            rps_in_sps=False,
            short_term_rps=ShortTermRPS(
                num_negative=len(anchors),
                delta_poc_s0=[a[0] - poc for a in anchors],
                used_s0=[True] * len(anchors)),
            num_ref_idx_l0_active=len(anchors),
            max_num_merge_cand=max(1, min(5, p.max_merge)),
        )
        refs_l0 = [a[1] for a in anchors]
        pocs_l0 = tuple(a[0] for a in anchors)
        me_refs = refs_l0
        if self.pps.weighted_pred:
            # fade analysis vs the nearest ref (weightAnalyse analog,
            # weightPrediction.cpp:480); weights ride the slice header
            from x265_tpu_torch.engine.weightp import (
                DENOM, analyze_slice_weights, weight_luma_me_handle)
            wl, wc = analyze_slice_weights((y, cb, cr), refs_l0[0],
                                           p.bit_depth)
            self._last_weights = (wl, wc)
            n0 = len(anchors)
            if wl is not None:
                sh.luma_log2_weight_denom = DENOM
                sh.luma_weights_l0 = [wl] + [None] * (n0 - 1)
                me_refs = ([weight_luma_me_handle(refs_l0[0], wl[0],
                                                  wl[1], p.bit_depth)]
                           + list(refs_l0[1:]))
            if wc is not None:
                sh.chroma_log2_weight_denom = DENOM
                sh.chroma_weights_l0 = [wc] + [None] * (n0 - 1)
        decisions = (self._areader.get() if self._areader
                     else self._p_decisions(y, me_refs, qp,
                                            frame=(y, cb, cr)))
        slice_data, recon = self._inter_slice_data(
            (y, cb, cr), sh, decisions, (refs_l0, []),
            (pocs_l0, ()), poc, SLICE_P)
        self._record_colmv(decisions, (pocs_l0, ()), poc)
        self._last_recon = recon
        rp = b""
        if self._ir_recovery is not None:
            # --intra-refresh: a refresh cycle started in this picture
            from x265_tpu_torch.hevc.sei import recovery_point_sei
            rp = annexb([recovery_point_sei(self._ir_recovery)])
            self._ir_recovery = None
        au = (self._aud(SLICE_P) + self._hrd_sei(SLICE_P, poc) + rp
              + self._dhdr10_sei(poc, SLICE_P)
              + self._assemble_slices(slice_data, sh, NAL_TRAIL_R)
              + self._hash_sei(recon) + self._dovi_rpu(poc))
        self._frame_stats((y, cb, cr), recon, SLICE_P, sh.qp,
                          len(au) * 8, poc, decisions)
        return au

    def _nr_offsets(self) -> np.ndarray:
        """Adaptive-deadzone offsets from the running residual sums
        (x265 FrameEncoder::noiseReductionUpdate, frameencoder.cpp:2098).
        Host numpy on the uint64 accumulators, as the reference computes
        them; a category whose count passes its block limit has its sums
        halved in place first."""
        p = self.param
        maxblk = (1 << 18, 1 << 16, 1 << 14, 1 << 12)
        off = np.zeros((16, 1024), np.uint16)
        for cat in range(16):
            tr = cat & 3
            nc = 1 << ((tr + 2) * 2)
            if self._nr["cnt"][cat] > maxblk[tr]:
                self._nr["sum"][cat] >>= 1
                self._nr["cnt"][cat] >>= 1
            strength = p.nr_intra if cat < 8 else p.nr_inter
            sc = int(strength) * int(self._nr["cnt"][cat])
            ss = self._nr["sum"][cat][:nc]
            off[cat, :nc] = np.minimum((sc + ss // 2) // (ss + 1), 65535)
            off[cat, 0] = 0              # DC is never denoised
        return off

    def _encode_b_frame(self, frame, poc, anchor0, anchor1, qp=None,
                        as_ref=False, extra_keep=(),
                        nal_override=None) -> bytes:
        """Synchronous wrapper around _encode_b_frame_gen."""
        g = self._encode_b_frame_gen(frame, poc, anchor0, anchor1, qp,
                                     as_ref, extra_keep, nal_override)
        while True:
            try:
                next(g)
            except StopIteration as e:
                return e.value

    def _encode_b_frame_gen(self, frame, poc, anchor0, anchor1, qp=None,
                            as_ref=False, extra_keep=(),
                            nal_override=None):
        """B picture between two anchors: TRAIL_N when unreferenced,
        TRAIL_R for the pyramid's middle B (--b-pyramid), nal_override
        (RASL_N) for the leading pictures of a CRA.

        Generator (returns the AU bytes): yields while this picture's
        loop filter is in flight on the device."""
        p = self.param
        y, cb, cr = frame
        p0, rec0 = anchor0
        p1, rec1 = anchor1
        if qp is None:
            qp = self._slice_qp(SLICE_B)
        # negatives: the L0 ref (used) + pictures kept alive for later
        # frames (used_by_curr = 0) — dropping them from the RPS would
        # evict them from a conformant decoder's DPB
        older = sorted({a[0] for a in self.anchors[1:] if a[0] < p0} |
                       {k for k in extra_keep if k < poc and k != p0},
                       reverse=True)
        negs = [p0 - poc] + [op - poc for op in older]
        pos_keep = sorted(k for k in extra_keep if k > poc and k != p1)
        sh = SliceHeader(
            first_slice_in_pic=True,
            slice_type=SLICE_B,
            qp=qp,
            pic_order_cnt_lsb=poc & self._poc_mask,
            rps_in_sps=False,
            short_term_rps=ShortTermRPS(
                num_negative=len(negs), delta_poc_s0=negs,
                used_s0=[True] + [False] * len(older),
                num_positive=1 + len(pos_keep),
                delta_poc_s1=[p1 - poc] + [k - poc for k in pos_keep],
                used_s1=[True] + [False] * len(pos_keep)),
            max_num_merge_cand=max(1, min(5, p.max_merge)),
        )
        decisions = (self._areader.get() if self._areader
                     else self._bdec_cache.pop(poc, None)
                     or self._b_decisions(y, rec0, rec1, qp,
                                          frame=(y, cb, cr),
                                          ref_tuples=(rec0, rec1)))
        slice_data, recon = yield from self._inter_slice_gen(
            (y, cb, cr), sh, decisions, ([rec0], [rec1]),
            ((p0,), (p1,)), poc, SLICE_B)
        if as_ref:
            self._record_colmv(decisions, ((p0,), (p1,)), poc)
            self._bref_recon = recon
        nal_type = (nal_override if nal_override is not None
                    else (NAL_TRAIL_R if as_ref else NAL_TRAIL_N))
        au = (self._aud(SLICE_B) + self._hrd_sei(SLICE_B, poc)
              + self._dhdr10_sei(poc, SLICE_B)
              + self._assemble_slices(slice_data, sh, nal_type)
              + self._hash_sei(recon) + self._dovi_rpu(poc))
        self._frame_stats((y, cb, cr), recon, SLICE_B, sh.qp,
                          len(au) * 8, poc, decisions)
        return au

    def _record_colmv(self, decisions, ref_poc, poc) -> None:
        """Store this picture's 16x16-compressed motion field for later
        TMVP use (spec MV storage compression, 8.5.3.2.7)."""
        from x265_tpu_torch.hevc.inter_tools import ColCtx
        p = self.param
        h16 = (p.height + 15) // 16
        w16 = (p.width + 15) // 16
        if decisions.inter8 is None or decisions.dir8 is None:
            self._colmv[poc] = ColCtx(
                poc, np.zeros((h16, w16), np.int32),
                np.zeros((h16, w16, 2, 2), np.int32),
                np.zeros((h16, w16, 2), np.int32))
            return
        inter16 = decisions.inter8[::2, ::2].astype(np.int32)
        dir16 = np.where(inter16 > 0, decisions.dir8[::2, ::2], 0)
        mv16 = np.asarray(decisions.mv8)[::2, ::2].copy()
        refpoc16 = np.zeros((dir16.shape[0], dir16.shape[1], 2), np.int32)
        if ref_poc[0]:
            pocs0 = np.asarray(ref_poc[0], dtype=np.int32)
            r16 = (np.asarray(decisions.ref8)[::2, ::2]
                   if decisions.ref8 is not None
                   else np.zeros(dir16.shape, np.int32))
            refpoc16[..., 0] = pocs0[np.clip(r16, 0, len(pocs0) - 1)]
        if ref_poc[1]:
            refpoc16[..., 1] = ref_poc[1][0]
        self._colmv[poc] = ColCtx(poc, dir16[:h16, :w16],
                                  mv16[:h16, :w16],
                                  refpoc16[:h16, :w16])
        if len(self._colmv) > 12:      # bound the store (DPB-ish size)
            for k in sorted(self._colmv)[:len(self._colmv) - 12]:
                if k != poc:
                    del self._colmv[k]






    def _inter_slice_data(self, frame, sh, decisions, refs, ref_poc, poc,
                          slice_type):
        """Synchronous wrapper around _inter_slice_gen (drives the
        generator to completion)."""
        g = self._inter_slice_gen(frame, sh, decisions, refs, ref_poc,
                                  poc, slice_type)
        while True:
            try:
                next(g)
            except StopIteration as e:
                return e.value

    def _inter_slice_gen(self, frame, sh, decisions, refs, ref_poc, poc,
                         slice_type):
        """Encode slice data (I/P/B) with the native C++ finalizer; for P
        and B slices the inter CUs' MC/transform/quant/recon come precomputed
        from the device (models/inter_residual.build_inter_pre) and the
        writer only emits their bins. Two-phase when SAO is on (x265
        FrameFilter pipeline analog): phase 1 reconstructs, then deblock
        + SAO analysis on the deblocked picture, then phase 2 re-emits
        the syntax with the per-CTU sao() parameters.

        GENERATOR returning (bytes, fully loop-filtered recon
        FramePlanes): it yields once while the deblock(+SAO statistics)
        work is in flight on the device, so a caller may run another
        picture's host work before resuming."""
        from x265_tpu_torch import native
        from x265_tpu_torch.utils.profiling import scope
        p = self.param
        y, cb, cr = frame
        # TMVP (8.5.3.2.7): collocated picture is L0[0] for P, L1[0] for
        # B (x265 colFromL0 = low-delay rule); IDR clears the store
        col = None
        if slice_type == SLICE_I:
            self._colmv.clear()
        elif p.tmvp:
            sh.collocated_from_l0 = slice_type != SLICE_B
            lst = ref_poc[0] if sh.collocated_from_l0 else ref_poc[1]
            if lst:
                col = self._colmv.get(lst[0])
        sh.temporal_mvp_enabled = col is not None
        if self.pps.cu_qp_delta_enabled and decisions.qp_map is None:
            if p.aq_mode > 0:
                # float offsets, chroma-inclusive energies (acEnergyCu);
                # rounded ONCE (x265 keeps qpAqOffset as double until
                # calcQpForCu)
                from x265_tpu_torch.engine.aq import aq_qp_offsets
                off = aq_qp_offsets(y, p.ctb_log2, p.aq_mode,
                                    p.aq_strength, cb=cb, cr=cr,
                                    bit_depth=p.bit_depth,
                                    hdr10_opt=bool(p.hdr10_opt),
                                    device=self.device)
            else:
                cy = -(-p.height // p.ctu_size)
                cx = -(-p.width // p.ctu_size)
                off = np.zeros((cy, cx), dtype=np.float64)
            ct = self._cutree.pop(poc, None)
            if ct is not None and ct.shape == off.shape:
                off = off + ct
            # x265_encoder_ctu_info analog: externally supplied per-CTU
            # QP offsets (ROI maps) for this display picture
            ci = self._ctu_info.pop(self._gop_base + poc, None)
            if ci is not None and np.shape(ci) == off.shape:
                off = off + np.asarray(ci, dtype=np.float64)
            grad = self.rc.band_grad_pending
            if grad:
                # band-graded VBV emergency re-encode (rowVbvRateControl
                # shape, ratecontrol.cpp:2526): sh.qp already carries the
                # uniform +grad emergency; re-spread it so early CTB rows
                # keep ~half the delta and late rows absorb ~1.5x
                self.rc.band_grad_pending = 0
                rows = off.shape[0]
                ramp = (np.round(np.linspace(-grad / 2.0, grad / 2.0,
                                             max(rows, 2)))
                        .astype(np.int32)[:rows])
                off = off + ramp[:, None]
            # one rounding at the end; +-12 keeps cu_qp_delta well inside
            # the spec's +-(26+QpBdOffsetY/2) coding range (7.4.9.10)
            off = np.clip(np.rint(off), -12, 12)
            decisions.qp_map = np.clip(sh.qp + off, 0, 51).astype(np.int32)
        if decisions.qp_map is not None and decisions.qp_map.shape != (
                -(-p.height // p.ctu_size), -(-p.width // p.ctu_size)):
            # a loaded map of another CTB grid (--scale-factor 2 keeps
            # the saved one): the writer would read past its end
            raise ValueError(
                f"qp_map {decisions.qp_map.shape} does not cover the "
                "picture's CTBs; load the analysis with AQ and cuTree "
                "off, or at the resolution it was saved at")
        self._last_analysis = decisions
        if self._awriter is not None:
            self._awriter.put(decisions)
        sao_on = bool(p.sao and not p.lossless)
        # DCT-domain noise reduction: this picture's offsets from the sums
        # so far, and fresh sums for the native walks to fill
        nr_arrs = None
        if self._nr is not None:
            nr_arrs = (self._nr_offsets(),
                       np.zeros((16, 1024), np.uint32),
                       np.zeros(16, np.uint32))
        wp_native = None
        if (sh.luma_weights_l0 is not None
                or sh.chroma_weights_l0 is not None):
            wp = np.zeros((4, 3, 3), np.int32)
            for r, e in enumerate((sh.luma_weights_l0 or [])[:4]):
                if e is not None:
                    wp[r, 0] = (1, e[0], e[1])
            for r, e in enumerate((sh.chroma_weights_l0 or [])[:4]):
                if e is not None:
                    wp[r, 1] = (1, e[0][0], e[0][1])
                    wp[r, 2] = (1, e[1][0], e[1][1])
            wp_native = (wp, sh.luma_log2_weight_denom,
                         sh.chroma_log2_weight_denom)
        if not self.use_native:
            return self._run_py(frame, sh, decisions, refs, ref_poc, poc,
                                col, nr_arrs, sao_on)
        pad = 80
        refs_padded = tuple(
            [self._pad_ref(planes, pad) for planes in lst]
            for lst in refs)   # up to 4 refs per list
        pre = None
        # under noise reduction the native walk quantizes every TB itself
        # (the deadzone offsets apply there), so no device residual runs;
        # without use_tpu_residual it quantizes every TB too (the same
        # bytes but under tu-inter-depth 2: test_torch_finalizer_split.py
        # and test_torch_oracle_writer.py)
        if (self.use_tpu_residual and slice_type != SLICE_I
                and nr_arrs is None):
            from x265_tpu_torch.models.inter_residual import build_inter_pre
            with scope("tpu_residual"):
                pre = build_inter_pre(
                    (np.asarray(y), np.asarray(cb), np.asarray(cr)),
                    decisions, refs_padded, sh.qp, p, wp_native,
                    self.pps.sign_data_hiding, p.rdoq_level,
                    mesh=self.mesh, slice_type=slice_type,
                    device=self.device)
            if pre is not None:
                # the writer and the deblock edge maps consume the
                # device's RQT choice (one source of truth)
                decisions.tusplit8 = pre.get("tusplit8")
        # the native walk reads reference PIXELS only for inter CUs
        # not covered by the device residual tensors (has8 == 0);
        # when coverage is total the host never materializes the
        # padded references at all
        need_host_refs = slice_type != SLICE_I and (
            pre is None
            or (decisions.inter8 is not None
                and bool((decisions.inter8.astype(bool)
                          & (pre["has8"] == 0)).any())))
        if need_host_refs:
            with scope("host_refs"):
                refs_native = tuple(
                    [self._host_padded_ref(r, pad) for r in lst]
                    for lst in refs_padded)
        else:
            zp = self._zero_padded_ref(pad)
            refs_native = tuple([zp] * len(lst) for lst in refs_padded)
        # "pre": the precomputed TBs the next walk emits; "nr_reset": the
        # next walk quantizes, so the NR sums start again from zero
        state = {"pre": pre, "nr_reset": True}

        def run_native_range(sp, begin, count, collect_arg=None):
            return native.encode_slice_px(
                np.asarray(y), np.asarray(cb), np.asarray(cr),
                decisions.cu_log2_map, decisions.luma_mode8,
                decisions.chroma_mode8, decisions.inter8, decisions.dir8,
                decisions.mv8, slice_type, sh.max_num_merge_cand,
                refs_native, ref_poc, poc, pad,
                p.ctb_log2, p.min_cb_log2, sh.qp, p.lossless,
                self.pps.sign_data_hiding, p.intra_smoothing,
                p.cb_qp_offset, p.cr_qp_offset,
                sao_params=sp, sao_luma=sp is not None,
                sao_chroma=sp is not None, qp_map=decisions.qp_map,
                bit_depth=p.bit_depth, ref8=decisions.ref8,
                rdoq_level=p.rdoq_level, weights=wp_native, col=col,
                col_from_l0=int(sh.collocated_from_l0), nr=nr_arrs,
                pre=state["pre"], ctb_begin=begin, ctb_count=count,
                collect=collect_arg,
                scaling_lists=bool(p.scaling_lists),
                tskip=p.tskip, wpp=bool(p.wpp),
                psy_rdoq_fx=(int(round(p.psy_rdoq * 256))
                             if p.rdoq_level >= 2 else 0),
                tu_inter_depth=p.tu_inter_depth)

        wc = p.pic_width_in_ctbs
        hc = p.pic_height_in_ctbs
        n_slices = max(1, min(p.slices, hc))

        def run_native(sp=None, collect_arg=None):
            if nr_arrs is not None and state["nr_reset"]:
                # fresh sums once per quantizing pass — NOT per band
                # (multi-slice would keep only the last band's DCT
                # statistics), and NOT in the emit-only replay pass
                # (no quantization happens there)
                nr_arrs[1][:] = 0
                nr_arrs[2][:] = 0
            if n_slices == 1:
                r = run_native_range(sp, 0, -1, collect_arg)
                if p.wpp:
                    # raw per-row substream sizes (entry points are set
                    # from the FINAL cabac pass's payload)
                    state["ss_sizes"] = r[4]
                    r = r[:4]
                return r
            # multi-slice picture (x265 --slices, frameencoder.cpp:820-876):
            # even CTU-row bands, each an independent slice segment with
            # its own CABAC state
            bounds = [round(i * hc / n_slices) for i in range(n_slices + 1)]
            jobs = [(bounds[i], bounds[i + 1]) for i in range(n_slices)
                    if bounds[i] != bounds[i + 1]]
            # the band calls are independent, release the GIL and write
            # their own output buffers, so they run on a thread pool; the
            # noise-reduction sums accumulate unsynchronized in the
            # writer, so that configuration stays serial
            nthreads = min(len(jobs), os.cpu_count() or 1)
            if nthreads > 1 and nr_arrs is None:
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(nthreads) as ex:
                    results = list(ex.map(
                        lambda j: run_native_range(
                            sp, j[0] * wc, (j[1] - j[0]) * wc, collect_arg),
                        jobs))
            else:
                results = [run_native_range(sp, r0 * wc, (r1 - r0) * wc,
                                            collect_arg)
                           for (r0, r1) in jobs]
            ctu = p.ctu_size
            payload = []
            rec = cbf = qpa = None
            for (r0, r1), (data_i, rec_i, cbf_i, qp_i) in zip(jobs, results):
                sh_i = copy.copy(sh)
                sh_i.first_slice_in_pic = r0 == 0
                sh_i.segment_address = r0 * wc
                payload.append((sh_i, data_i))
                if rec is None:
                    rec = [np.array(pl) for pl in rec_i]
                    cbf = np.array(cbf_i)
                    qpa = np.array(qp_i)
                    continue
                # stitch the band's rows: luma by pels, chroma by half
                # pels, the cbf and QP planes by 4x4 units
                y0p = r0 * ctu
                y1p = min(p.height, r1 * ctu)
                rec[0][y0p:y1p] = rec_i[0][y0p:y1p]
                c0, c1 = y0p >> 1, (y1p + 1) >> 1
                rec[1][c0:c1] = rec_i[1][c0:c1]
                rec[2][c0:c1] = rec_i[2][c0:c1]
                q0, q1 = y0p >> 2, (y1p + 3) >> 2
                cbf[q0:q1] = cbf_i[q0:q1]
                qpa[q0:q1] = qp_i[q0:q1]
            return payload, tuple(rec), cbf, qpa

        # with SAO on, the first walk is collect-only (CABAC disabled):
        # it gathers every TB's levels/cbf + the recon, the loop filter
        # + SAO decision run on those, and ONE real CABAC pass replays
        # them emit-only (x265 derives SAO from stats without
        # re-encoding, sao.cpp:1225)
        collect_bufs = None
        # --tskip: the collected level planes cannot carry the per-TB
        # transform_skip_flag, so the emit-only replay would drop it;
        # the second pass recomputes in full instead (decisions are
        # deterministic, so the streams still match)
        if sao_on and not p.tskip:
            h8n, w8n = p.height >> 3, p.width >> 3
            collect_bufs = {
                "lvl_y": np.zeros((p.height, p.width), np.int16),
                "lvl_cb": np.zeros((p.height // 2, p.width // 2), np.int16),
                "lvl_cr": np.zeros((p.height // 2, p.width // 2), np.int16),
                "cbf8": np.zeros((h8n, w8n), np.uint8),
                "has8": np.zeros((h8n, w8n), np.uint8),
                # the replay pass re-walks the same RQT choices
                "tusplit8": (pre["tusplit8"] if pre is not None
                             and pre.get("tusplit8") is not None
                             else np.zeros((h8n, w8n), np.uint8))}
        with scope("finalize"):
            slice_data, recon, cbf4, qp_actual = run_native(
                collect_arg=collect_bufs)
        # the emit-only replay pass needs the PRE-loop-filter recon
        # (native pre-fills its working planes with it)
        pre_lf_recon = recon
        qp_arg = qp_actual if decisions.qp_map is not None else sh.qp
        # deblock on the device; with SAO on, the EO/BO statistics of
        # the deblocked recon come with it. The filtered planes STAY on
        # the device (keep_device): they are the next pictures'
        # references.
        keep_dev = bool(self.use_tpu_loopfilter and p.deblock
                        and not p.lossless)
        sao_src = (y, cb, cr) if sao_on else None
        if slice_type == SLICE_I:
            fin_lf = self._deblock_intra_recon(
                recon, decisions, qp_arg, sao_src=sao_src, sync=False,
                keep_device=keep_dev)
        else:
            fin_lf = self._deblock_inter_recon(
                recon, decisions, cbf4, ref_poc, qp_arg, sao_src=sao_src,
                sync=False, keep_device=keep_dev)
        # device filter in flight: the caller may overlap host work
        yield
        out_lf = fin_lf()
        if sao_on:
            from x265_tpu_torch.hevc import sao as sao_mod
            recon, stats = out_lf
            with scope("sao_analyze"):
                sp = sao_mod.analyze_frame((y, cb, cr), recon, p.ctb_log2,
                                           sh.qp, p.bit_depth, stats=stats,
                                           device=self.device)
            self._last_sao = sp
            sh.sao_luma = sh.sao_chroma = True
            if collect_bufs is not None:
                # emit-only replay: no quantization, the sums stay
                state["pre"] = {
                    **collect_bufs,
                    "rec_y": pre_lf_recon[0].astype(np.int16),
                    "rec_cb": pre_lf_recon[1].astype(np.int16),
                    "rec_cr": pre_lf_recon[2].astype(np.int16)}
                state["nr_reset"] = False
            with scope("finalize"):
                slice_data = run_native(sp)[0]
            with scope("loopfilter"):
                if keep_dev:
                    from x265_tpu_torch.models.loopfilter import (
                        sao_apply_device)
                    recon = FramePlanes(
                        dev=sao_apply_device(recon, sp, p.ctb_log2,
                                             p.bit_depth),
                        bd=p.bit_depth)
                else:
                    recon = sao_mod.apply_frame(recon, sp, p.ctb_log2,
                                                p.bit_depth)
        else:
            recon = out_lf
            if keep_dev:
                recon = FramePlanes(dev=recon, bd=p.bit_depth)
        if nr_arrs is not None:
            self._nr["sum"] += nr_arrs[1]
            self._nr["cnt"] += nr_arrs[2]
        if p.wpp and state.get("ss_sizes"):
            self._set_wpp_entry_points(sh, slice_data, state["ss_sizes"])
        if not isinstance(recon, FramePlanes):
            # host planes (no device filter ran): one upload, then the
            # search and MC layouts are derived and cached on the device
            recon = FramePlanes(host=recon, bd=p.bit_depth,
                                device=self.device)
        return slice_data, recon

    def _run_py(self, frame, sh, decisions, refs, ref_poc, poc, col,
                nr_arrs, sao_on):
        """Slice data and loop-filtered recon through the Python writer
        (engine.ctu_writer.FrameSyntaxWriter): the oracle the native
        writer is held against, and the only writer that codes PART_NxN
        intra CUs (FrameDecisions.nxn8). It quantizes every TB itself,
        deblocks on the host, and under SAO codes the picture twice, the
        second time with the parameters the first recon chose. It writes
        one slice a picture whatever --slices says, as the JAX package's
        run_py does; that stream decodes all the same.

        The JAX package also falls back to this writer when the native
        one returns None. The port's native writer raises instead: its
        one failure, an intra CU above 32x32 (native/slice_writer.cpp),
        fails this writer's assertion too, so a fallback would hide the
        fault rather than encode the picture."""
        from x265_tpu_torch.engine.ctu_writer import FrameSyntaxWriter
        from x265_tpu_torch.hevc import sao as sao_mod
        p = self.param
        y, cb, cr = frame

        def run_py(sp=None):
            if nr_arrs is not None:
                nr_arrs[1][:] = 0
                nr_arrs[2][:] = 0
            writer = FrameSyntaxWriter(self.sps, self.pps, sh, p.lossless,
                                       refs=refs, ref_poc=ref_poc,
                                       cur_poc=poc, col=col)
            writer.nr = nr_arrs
            writer.rdoq_level = 0 if p.lossless else p.rdoq_level
            writer.psy_fx = (int(round(p.psy_rdoq * 256))
                             if writer.rdoq_level >= 2 else 0)
            data = writer.encode_slice_data(
                np.asarray(y), np.asarray(cb), np.asarray(cr), decisions,
                sao_params=sp)
            if getattr(writer, "substream_parts", None):
                self._set_wpp_entry_points(
                    sh, data, [len(b) for b in writer.substream_parts])
            writer.apply_loop_filters()
            return data, (writer.y, writer.cb, writer.cr)

        slice_data, recon = run_py()
        if sao_on:
            sp = sao_mod.analyze_frame((y, cb, cr), recon, p.ctb_log2,
                                       sh.qp, p.bit_depth,
                                       device=self.device)
            self._last_sao = sp
            sh.sao_luma = sh.sao_chroma = True
            slice_data, _ = run_py(sp)
            recon = sao_mod.apply_frame(recon, sp, p.ctb_log2, p.bit_depth)
        if nr_arrs is not None:
            self._nr["sum"] += nr_arrs[1]
            self._nr["cnt"] += nr_arrs[2]
        return slice_data, FramePlanes(host=recon, bd=p.bit_depth,
                                       device=self.device)

    def _deblock_intra_recon(self, recon, decisions, qp, sao_src=None,
                             sync=True, keep_device=False):
        """Deblock the recon returned by the native intra finalizer.

        All-intra => bS=2 at every CU(==TU/PU) boundary on the 8-grid
        regardless of cbf (spec 8.7.2.4), so the edge maps derive from the
        CU-size map alone. Runs on the device (models/loopfilter.py);
        with sao_src the SAO statistics come with it and (recon, stats)
        is returned."""
        p = self.param
        if not p.deblock or p.lossless:
            res = recon if sao_src is None else (recon, None)
            return res if sync else (lambda: res)
        from x265_tpu_torch.hevc.deblock import NOPOC, DeblockState
        h, w = p.height, p.width
        h4, w4 = (h + 3) // 4, (w + 3) // 4
        cl4 = np.repeat(np.repeat(decisions.cu_log2_map, 2, 0),
                        2, 1)[:h4, :w4]
        st = DeblockState(h, w)
        xs = (np.arange(w4) * 4)[None, :]
        ys = (np.arange(h4) * 4)[:, None]
        st.edge_v = (xs % (1 << cl4)) == 0
        st.edge_h = (ys % (1 << cl4)) == 0
        is_intra4 = np.ones((h4, w4), dtype=bool)
        mv4 = np.zeros((h4, w4, 2, 2), dtype=np.int32)
        refpoc4 = np.full((h4, w4, 2), NOPOC, dtype=np.int64)
        return self._run_loopfilter(recon, st, is_intra4, mv4, refpoc4,
                                    qp, sao_src, sync=sync,
                                    keep_device=keep_device)

    def _run_loopfilter(self, recon, st, is_intra4, mv4, refpoc4, qp,
                        sao_src, sync=True, keep_device=False):
        """Run the deblock (+SAO statistics) on the device, or the numpy
        reference when use_tpu_loopfilter is off (differential testing).
        sync=False returns a finisher. keep_device: the filtered planes
        stay on the device (only the SAO statistics are downloaded); the
        caller wraps them in FramePlanes."""
        p = self.param
        if self.use_tpu_loopfilter:
            from x265_tpu_torch.models.loopfilter import deblock_frame_device
            from x265_tpu_torch.utils.profiling import scope

            with scope("loopfilter"):
                fin = deblock_frame_device(
                    recon, st, is_intra4, mv4, refpoc4, qp,
                    p.deblock_beta_offset, p.deblock_tc_offset,
                    p.cb_qp_offset, p.cr_qp_offset, p.bit_depth,
                    sao_src=sao_src, ctb_log2=p.ctb_log2, sync=False,
                    keep_device=keep_device, device=self.device)

            def finish():
                with scope("loopfilter"):
                    out = fin()
                if sao_src is None or keep_device:
                    # keep_device already returns ((y,cb,cr), stats) or
                    # the bare device planes
                    return out
                return out[:3], out[3]
            return finish if not sync else finish()
        from x265_tpu_torch.hevc.deblock import deblock_frame
        yy, cbb, crr = deblock_frame(
            np.asarray(recon[0]).astype(np.int32),
            np.asarray(recon[1]).astype(np.int32),
            np.asarray(recon[2]).astype(np.int32), st, is_intra4, mv4,
            refpoc4, qp, p.deblock_beta_offset, p.deblock_tc_offset,
            p.cb_qp_offset, p.cr_qp_offset, p.bit_depth)
        res = (yy, cbb, crr) if sao_src is None else ((yy, cbb, crr), None)
        # the numpy route computes eagerly; async just wraps the value
        return (lambda: res) if not sync else res

    def _deblock_inter_recon(self, recon, decisions, cbf4, ref_poc, qp,
                             sao_src=None, sync=True, keep_device=False):
        """Deblock a native-finalizer recon using the decision maps (CU ==
        TU == PU boundaries) + the native cbf map, on the device; with
        sao_src the SAO statistics come with it and (recon, stats)
        returns."""
        p = self.param
        if not p.deblock or p.lossless:
            res = recon if sao_src is None else (recon, None)
            return res if sync else (lambda: res)
        from x265_tpu_torch.hevc.deblock import DeblockState, NOPOC
        h, w = p.height, p.width
        h4, w4 = (h + 3) // 4, (w + 3) // 4

        def to4(m):
            return np.repeat(np.repeat(m, 2, 0), 2, 1)[:h4, :w4]

        # TU grid: a 64 CU transforms as 4x32 TUs (implicit RQT split),
        # so TU edges cap at 32; explicitly split 16/32 CUs
        # (decisions.tusplit8) halve again; BS stays 0 on the internal
        # TU edges unless cbf is set
        cl4 = to4(decisions.cu_log2_map)
        if decisions.tusplit8 is not None:
            cl4 = cl4 - to4(decisions.tusplit8.astype(np.int32))
        cl4 = np.minimum(cl4, 5)
        st = DeblockState(h, w)
        xs = (np.arange(w4) * 4)[None, :]
        ys = (np.arange(h4) * 4)[:, None]
        st.edge_v = (xs % (1 << cl4)) == 0
        st.edge_h = (ys % (1 << cl4)) == 0
        st.cbf4 = np.asarray(cbf4, dtype=bool)
        inter4 = to4(decisions.inter8.astype(bool))
        is_intra4 = ~inter4
        dir4 = to4(decisions.dir8)
        mv4 = np.zeros((h4, w4, 2, 2), dtype=np.int32)
        mv4[..., 0, :] = np.where(((dir4 & 1) > 0)[..., None],
                                  to4(decisions.mv8[:, :, 0]), 0)
        mv4[..., 1, :] = np.where(((dir4 & 2) > 0)[..., None],
                                  to4(decisions.mv8[:, :, 1]), 0)
        mv4[is_intra4] = 0
        refpoc4 = np.full((h4, w4, 2), NOPOC, dtype=np.int64)
        if ref_poc[0]:
            pocs0 = np.asarray(ref_poc[0], dtype=np.int64)
            r4 = (to4(decisions.ref8) if decisions.ref8 is not None
                  else np.zeros((h4, w4), np.int32))
            r4 = np.clip(r4, 0, len(pocs0) - 1)
            refpoc4[..., 0] = np.where(inter4 & ((dir4 & 1) > 0),
                                       pocs0[r4], NOPOC)
        if ref_poc[1]:
            refpoc4[..., 1] = np.where(inter4 & ((dir4 & 2) > 0),
                                       ref_poc[1][0], NOPOC)
        return self._run_loopfilter(recon, st, is_intra4, mv4, refpoc4,
                                    qp, sao_src, sync=sync,
                                    keep_device=keep_device)

    def _adopt_coherent(self, y, refs0, refs1, dir_blk, mv_blk, ref_blk,
                        inter_blk, satd_now, bits_now, lam, qp):
        """Decision-stage merge/skip emulation (x265 checkMerge2Nx2N,
        analysis.cpp:1914, recast as one batched dispatch): evaluate the
        frame-dominant motion tuples for every block and adopt one where
        the AMVP->merge/skip rate saving beats the SATD loss. Uniform
        regions then share EXACT motion, so the writer's merge detection
        chains across them and the 32/64 promotions fire.

        All arrays are at the 16x16 block grid. Returns possibly-updated
        (dir_blk, mv_blk, ref_blk, satd_blk)."""
        from x265_tpu_torch.engine.me import dominant_tuples, tuple_satd
        p = self.param
        cands = dominant_tuples(dir_blk, mv_blk, ref_blk, inter_blk)
        if not cands:
            return dir_blk, mv_blk, ref_blk, satd_now
        sc = tuple_satd(y, refs0, refs1, cands, p.width, p.height,
                        R=p.me_range, bit_depth=p.bit_depth,
                        mesh=self.mesh, device=self.device)
        k = np.argmin(sc, axis=0)
        s_c = np.take_along_axis(sc, k[None], 0)[0].astype(np.float32)
        lam = max(float(lam), 1e-3)
        # rate rule: candidate codes as skip/merge (~3 bits) vs the
        # current choice's AMVP syntax; +8 bits of slack for the CU-merge
        # cascade the coherent region enables (promotion to 32/64 saves
        # the neighbours' syntax too)
        adopt = inter_blk & (
            s_c <= satd_now + lam * (np.maximum(bits_now - 3.0, 0.0) + 8.0))
        if not adopt.any():
            return dir_blk, mv_blk, ref_blk, satd_now
        carr = np.array([[c[0], c[1], c[3][0], c[3][1], c[4][0], c[4][1]]
                         for c in cands], np.int32)
        ck = carr[k]                                   # [nby,nbx,6]
        dir_out = np.where(adopt, ck[..., 0], dir_blk).astype(np.int32)
        ref_out = np.where(adopt, ck[..., 1], ref_blk).astype(np.int32)
        mv_out = mv_blk.copy()
        mv_out[adopt, 0, 0] = ck[adopt, 2]
        mv_out[adopt, 0, 1] = ck[adopt, 3]
        mv_out[adopt, 1, 0] = ck[adopt, 4]
        mv_out[adopt, 1, 1] = ck[adopt, 5]
        satd_out = np.where(adopt, s_c, satd_now).astype(np.float32)
        return dir_out, mv_out, ref_out, satd_out


    @staticmethod
    def _dominant_mv(dec):
        """(mv [2,2], dir) of the most common inter motion tuple, or
        (None, None) — the unification bias shared by both promotion
        levels so merge chains span group boundaries."""
        if dec.inter8 is None or not dec.inter8.any():
            return None, None
        sel = dec.inter8.astype(bool)
        rows = np.concatenate(
            [dec.mv8[sel].reshape(int(sel.sum()), -1),
             dec.dir8[sel].reshape(-1, 1)], axis=1)
        vals, counts = np.unique(rows, axis=0, return_counts=True)
        best = vals[counts.argmax()]
        return best[:4].reshape(2, 2).astype(np.int32), int(best[4])

    def _merge_cu32(self, dec, satd16=None, qp=None, rd_ctx=None) -> None:
        """Bottom-up CU merging: promote 2x2 groups of 16x16 blocks to one
        32x32 CU when they carry identical decisions — one skip/merge per
        32 instead of four (the quadtree dial of Analysis::compressCTU;
        decisions-only, the finalizer already walks any CU size). Under
        rd 3 (rd_ctx = (frame, padded L0 refs, padded L1 refs)) the inter
        groups and then the intra groups are decided by recon-in-the-loop
        RD on the device (models/rdo.py, models/intra_rdo.py)."""
        p = self.param
        if p.ctb_log2 < 5:
            return
        h8, w8 = dec.cu_log2_map.shape
        h32, w32 = h8 // 4, w8 // 4
        if h32 == 0 or w32 == 0:
            return

        def grp(m):
            """[h8,w8]->[h32,w32,16] group view (trailing dims kept)."""
            t = m[:h32 * 4, :w32 * 4]
            t = t.reshape(h32, 4, w32, 4, *m.shape[2:])
            return np.moveaxis(t, 1, 2).reshape(h32, w32, 16, *m.shape[2:])

        all16 = (grp(dec.cu_log2_map) == 4).all(axis=2)
        if dec.inter8 is not None:
            inter = grp(dec.inter8.astype(bool)).all(axis=2)
            d = grp(dec.dir8)
            same_dir = (d == d[:, :, :1]).all(axis=2)
            mv = grp(dec.mv8)
            same_mv = (mv == mv[:, :, :1]).all(axis=(2, 3, 4))
            r = (grp(dec.ref8) if dec.ref8 is not None
                 else np.zeros_like(d))
            same_ref = (r == r[:, :, :1]).all(axis=2)
            ok_inter = all16 & inter & same_dir & same_mv & same_ref
            if p.rd_level >= 3 and rd_ctx is not None and qp is not None:
                # recon-in-the-loop promotion WITH motion unification (x265
                # compressInterCU_rd0_4 + checkMerge2Nx2N): candidates only
                # need uniform dir/ref — the 32 CU is coded at the group's
                # modal MV and both trees are costed on the device
                elig = all16 & inter & same_dir & same_ref
                if elig.any():
                    from x265_tpu_torch.models.rdo import rd_promote32
                    ys, xs = np.nonzero(elig)
                    cand = np.stack([ys, xs], 1)
                    # the 4 z-order 16x16 sub-blocks' motions: group
                    # member (2*dy)*4 + 2*dx of the 4x4 8-block view
                    sub = np.array([0, 2, 8, 10])
                    mv4 = mv[ys, xs][:, sub]          # [G,4,2,2]
                    bias_mv, bias_dir = self._dominant_mv(dec)
                    promote, mv_uni = rd_promote32(
                        rd_ctx[0], rd_ctx[1], rd_ctx[2], cand, mv4,
                        d[ys, xs, 0], r[ys, xs, 0], int(qp), p,
                        mv_bias=bias_mv, bias_dir=bias_dir,
                        mesh=self.mesh, device=self.device)
                    keep = np.zeros_like(elig)
                    keep[ys, xs] = promote
                    ok_inter = keep
                    # promoted groups adopt the unified motion
                    for (gy, gx, m_) in zip(ys[promote], xs[promote],
                                            mv_uni[promote]):
                        dec.mv8[gy * 4:gy * 4 + 4,
                                gx * 4:gx * 4 + 4] = m_
                else:
                    ok_inter = elig
            elif satd16 is not None and qp is not None:
                # promote only skip-likely groups: a 32x32 TU re-quantizes
                # the residual differently, so uniform motion alone is
                # bit-neutral; low energy => the 32 CU skips and the
                # saved per-CU syntax is a strict win
                g16 = satd16[:h32 * 2, :w32 * 2].reshape(
                    h32, 2, w32, 2).sum(axis=(1, 3))
                qstep = 2.0 ** ((qp - 4) / 6.0)
                # loose gate: a merged 32 CU saves 3 CUs' syntax even
                # when it carries coefficients; only clearly textured
                # groups keep the finer tree
                ok_inter &= g16 < 192.0 * qstep
        else:
            ok_inter = np.zeros((h32, w32), dtype=bool)
        rd_intra = (p.rd_level >= 3 and rd_ctx is not None
                    and qp is not None)
        if rd_intra:
            # recon-in-loop intra promotion runs below (after the inter
            # map update) — it needs cu_log2_map still at 4 here
            ok_intra = np.zeros((h32, w32), dtype=bool)
        else:
            # heuristic: merge only uniform planar/DC (32x32 prediction
            # of flat areas is near-identical to four 16s)
            modes = grp(dec.luma_mode8)
            same_mode = (modes == modes[:, :, :1]).all(axis=2)
            flat = modes[:, :, 0] <= 1
            if dec.inter8 is not None:
                not_inter = ~grp(dec.inter8.astype(bool)).any(axis=2)
            else:
                not_inter = np.ones((h32, w32), dtype=bool)
            ok_intra = all16 & same_mode & flat & not_inter
        ok = ok_inter | ok_intra
        if ok.any():
            up = np.repeat(np.repeat(ok, 4, 0), 4, 1)
            dec.cu_log2_map[:h32 * 4, :w32 * 4][up] = 5
        if rd_intra:
            # intra quadtree depth-1 RDO on the remaining intra groups
            # (compressIntraCU analog, analysis.cpp:514)
            from x265_tpu_torch.models.intra_rdo import rd_intra_promote32
            rd_intra_promote32(rd_ctx[0], dec, int(qp), p,
                               device=self.device)

    def _merge_cu64(self, dec, satd16=None, qp=None, rd_ctx=None) -> None:
        """Promote 2x2 groups of 32x32 inter CUs to one 64x64 CU when
        they carry identical motion — one skip/merge per CTB instead of
        four (x265 codes these as depth-0 skip CUs, analysis.cpp:1146).
        Residual coding still works (implicit RQT split to 4x32 TUs),
        but the energy gate keeps textured regions on the finer tree."""
        p = self.param
        if p.ctb_log2 < 6 or dec.inter8 is None:
            return
        h8, w8 = dec.cu_log2_map.shape
        h64, w64 = h8 // 8, w8 // 8
        if h64 == 0 or w64 == 0:
            return

        def grp(m):
            t = m[:h64 * 8, :w64 * 8]
            t = t.reshape(h64, 8, w64, 8, *m.shape[2:])
            return np.moveaxis(t, 1, 2).reshape(h64, w64, 64, *m.shape[2:])

        all32 = (grp(dec.cu_log2_map) == 5).all(axis=2)
        inter = grp(dec.inter8.astype(bool)).all(axis=2)
        d = grp(dec.dir8)
        same_dir = (d == d[:, :, :1]).all(axis=2)
        mv = grp(dec.mv8)
        same_mv = (mv == mv[:, :, :1]).all(axis=(2, 3, 4))
        r = (grp(dec.ref8) if dec.ref8 is not None else np.zeros_like(d))
        same_ref = (r == r[:, :, :1]).all(axis=2)
        ok = all32 & inter & same_dir & same_mv & same_ref
        if p.rd_level >= 3 and rd_ctx is not None and qp is not None:
            # same-motion groups promote unconditionally (the implicit
            # 4x32 TU split makes the residual coding identical — the
            # merge strictly saves three CU headers); groups of 32s with
            # only dir/ref in common additionally try a UNIFIED motion
            # via the recon-in-loop RD pass (see _merge_cu32)
            elig = all32 & inter & same_dir & same_ref & ~ok
            if elig.any():
                from x265_tpu_torch.models.rdo import rd_promote
                ys, xs = np.nonzero(elig)
                cand = np.stack([ys, xs], 1)
                # quadrant (dy,dx) representative member of the 8x8
                # 8-block group view: (4*dy)*8 + 4*dx
                sub = np.array([0, 4, 32, 36])
                mv4 = mv[ys, xs][:, sub]
                bias_mv, bias_dir = self._dominant_mv(dec)
                promote, mv_uni = rd_promote(
                    rd_ctx[0], rd_ctx[1], rd_ctx[2], cand, mv4,
                    d[ys, xs, 0], r[ys, xs, 0], int(qp), p, n=64,
                    mv_bias=bias_mv, bias_dir=bias_dir, mesh=self.mesh,
                    device=self.device)
                pys, pxs = ys[promote], xs[promote]
                for (gy, gx, m_) in zip(pys, pxs, mv_uni[promote]):
                    dec.mv8[gy * 8:gy * 8 + 8, gx * 8:gx * 8 + 8] = m_
                ok = ok.copy()
                ok[pys, pxs] = True
        elif satd16 is not None and qp is not None:
            g16 = satd16[:h64 * 4, :w64 * 4].reshape(
                h64, 4, w64, 4).sum(axis=(1, 3))
            qstep = 2.0 ** ((qp - 4) / 6.0)
            ok &= g16 < 640.0 * qstep
        if not ok.any():
            return
        up = np.repeat(np.repeat(ok, 8, 0), 8, 1)
        dec.cu_log2_map[:h64 * 8, :w64 * 8][up] = 6


    def attach_mesh(self, mesh) -> None:
        """Shard the frame analysis over a parallel.mesh.Mesh's `tile`
        axis: the intra analysis (parallel/tiles.mesh_intra_decisions) and
        the motion search's per-block stages (engine/me.motion_fused,
        tuple_satd) run in CTU-row bands on the tiles; the rest of the
        encode stays on the encoder's device, which must be the mesh's
        first. Streams are byte-identical to the single-device encoder's.
        As in the JAX package, the leaf-B batch and the RD passes run
        unsharded, the pipelined keyint-1 path of encode() does not read
        the mesh, and the device residual raises under a mesh
        (models/inter_residual.build_inter_pre): set use_tpu_residual =
        False (or encode under noise reduction) to encode P and B
        pictures."""
        from x265_tpu_torch.parallel.mesh import device_key
        first = mesh.devices.flat[0]
        if device_key(first) != device_key(self.device):
            raise ValueError(f"the mesh's first device {first} is not the "
                             f"encoder's device {self.device}")
        self.mesh = mesh

    @staticmethod
    def _to8(grid, h8, w8, rep):
        return np.ascontiguousarray(
            np.repeat(np.repeat(grid, rep, 0), rep, 1)[:h8, :w8])


    def _pad_ref(self, planes, pad=80):
        """A reference as the device-resident FramePlanes every consumer
        takes: the residual pipeline and the motion search derive their
        padded layouts ON DEVICE (FramePlanes.dev_padded, dev_luma_me),
        the native writer's host layout is materialized lazily
        (_host_padded_ref). The encoder's own anchors already are
        FramePlanes; a plain (y, cb, cr) host picture is wrapped."""
        if isinstance(planes, FramePlanes):
            return planes
        return FramePlanes(host=planes, bd=self.param.bit_depth,
                           device=self.device)

    @staticmethod
    def _host_padded_ref(r, pad=80):
        """Host int16 edge-padded planes of a reference, for the inter
        CUs the native writer predicts itself; cached on the reference,
        so the copy lives exactly as long as the anchor does."""
        return r.host_padded(pad)

    def _zero_padded_ref(self, pad=80):
        """Shared all-zero padded planes: stand-in for references the
        native walk provably never reads (every inter CU is covered by
        the device-precomputed residual tensors, has8 == 1)."""
        if self._zero_ref is None or self._zero_ref[0] != pad:
            p = self.param
            hc, wc = p.height // 2 + pad, p.width // 2 + pad
            self._zero_ref = (pad, (
                np.zeros((p.height + 2 * pad, p.width + 2 * pad), np.int16),
                np.zeros((hc, wc), np.int16), np.zeros((hc, wc), np.int16)))
        return self._zero_ref[1]

    def _intra_cost_grid(self, y, S=16):
        """The device bank's per-SxS intra cost grid (host float32) of the
        edge-padded luma: the intra side of the inter/intra choice when
        the decisions come from the numpy analysis."""
        import torch
        from x265_tpu_torch.models.intra_frame import frame_intra_analysis
        p = self.param
        ph = -(-p.height // S) * S
        pw = -(-p.width // S) * S
        yp = np.pad(np.asarray(y, dtype=np.int32),
                    ((0, ph - p.height), (0, pw - p.width)), mode="edge")
        _, icost = frame_intra_analysis(
            torch.from_numpy(yp).to(self.device), S=S)
        return icost.cpu().numpy().reshape(ph // S, pw // S)

    def _intra_analysis_with_cost(self, y):
        p = self.param
        cu_log2 = 4 if p.ctb_log2 >= 4 else p.ctb_log2
        if self.mesh is not None:
            from x265_tpu_torch.parallel.tiles import mesh_intra_decisions
            return mesh_intra_decisions(self.mesh, y, p.width, p.height,
                                        cu_log2, p.fast_intra,
                                        psy=float(p.psy_rd))
        if not self.use_tpu_analysis:
            return self._intra_decisions(y), self._intra_cost_grid(y)
        from x265_tpu_torch.models.intra_frame import (
            decide_intra_frame_tpu_with_cost)
        return decide_intra_frame_tpu_with_cost(
            np.asarray(y), p.width, p.height, cu_log2=cu_log2,
            fast=p.fast_intra, psy=float(p.psy_rd), device=self.device)

    @staticmethod
    def _me_entry(r):
        """Normalize a reference entry for the motion search: device
        handles (FramePlanes/MELuma) pass through (padded on device);
        host pictures reduce to their luma plane."""
        if isinstance(r, (FramePlanes, MELuma)):
            return r
        if isinstance(r, (tuple, list)) and len(r) == 3:
            return np.asarray(r[0])
        return np.asarray(r)

    def _p_decisions(self, y, refs, qp=None, frame=None) -> FrameDecisions:
        """Inter/intra split + MVs + ref choice for a P frame: one fused
        device pass covers all refs' integer search + subpel +
        MVP-relative re-cost + smoothing (the pme bonded group becomes an
        argmin over the ref axis; x265 motion.cpp:739 per-PU loop)."""
        from x265_tpu_torch.engine.me import motion_fused
        from x265_tpu_torch.utils.profiling import scope

        p = self.param
        S = 16
        qpv = qp if qp is not None else self._slice_qp(SLICE_P)
        lam = float(np.sqrt(0.85 * 2.0 ** ((qpv - 12) / 3.0)))
        with scope("analysis"):
            dec, icost = self._intra_analysis_with_cost(y)
        ref_ys = [self._me_entry(r) for r in refs]
        with scope("motion"):
            mv, cost, satd, _ = motion_fused(
                np.asarray(y), ref_ys, p.width, p.height, S=S,
                R=p.me_range, qp=qpv, subme=max(1, p.sub_me),
                bit_depth=p.bit_depth,
                slack=48.0 if p.early_skip else 24.0,
                force_dense=p.me_method in ("full", "star", "sea"),
                mesh=self.mesh, device=self.device)
        cost = cost + lam * 2.0 * np.arange(len(ref_ys),
                                            dtype=np.float32)[:, None, None]
        best_ref = np.argmin(cost, axis=0).astype(np.int32)
        best_cost = np.take_along_axis(cost, best_ref[None], 0)[0]
        best_mv = np.take_along_axis(
            mv, best_ref[None, ..., None], 0)[0]
        satd16 = np.take_along_axis(satd, best_ref[None], 0)[0]
        # intra pays mode bits AND its SATD is optimistic (analysis
        # neighbors are source pixels, the coded prediction's are recon) —
        # without a penalty half a panning frame goes intra
        # (x265 analog: checkIntraInInter's mode-bit cost, search.cpp:1291)
        icost_adj = icost * 1.125 + lam * 12.0
        inter_blk = best_cost < icost_adj
        h8, w8 = p.height >> 3, p.width >> 3
        rep = S >> 3
        nby, nbx = best_mv.shape[:2]
        mv2 = np.zeros((nby, nbx, 2, 2), dtype=np.int32)
        mv2[:, :, 0] = best_mv
        dir_blk = np.ones((nby, nbx), np.int32)
        # full-plane RD context: current frame + padded refs, all three
        # planes (a weighted luma-only search reference leaves it out)
        rd_refs = None
        if (p.rd_level >= 3 and frame is not None
                and all(is_planes(r) for r in refs)):
            rd_refs = [self._pad_ref(r) for r in refs]
        if rd_refs is not None:
            # recon-in-the-loop merge adoption (rdo.rd_adopt16): every
            # block is coded under its own motion and each dominant
            # tuple; real SSE+rate replaces the SATD slack heuristic
            from x265_tpu_torch.engine.me import dominant_tuples
            from x265_tpu_torch.models.rdo import rd_adopt16
            cands = dominant_tuples(dir_blk, mv2, best_ref, inter_blk)
            if cands:
                with scope("rd_adopt"):
                    dir_blk, mv2, best_ref, _ad = rd_adopt16(
                        frame, rd_refs, [], inter_blk, mv2, dir_blk,
                        best_ref, cands, qpv, p, mesh=self.mesh,
                        device=self.device)
        elif p.rd_level >= 2:
            bits_now = ((best_cost - satd16) / max(lam, 1e-3) + 4.0)
            dir_blk, mv2, best_ref, satd16 = self._adopt_coherent(
                np.asarray(y), ref_ys, [], dir_blk, mv2, best_ref,
                inter_blk, satd16.astype(np.float32), bits_now, lam, qpv)
        dec.inter8 = self._to8(inter_blk, h8, w8, rep)
        dec.dir8 = self._to8(dir_blk, h8, w8, rep)
        dec.mv8 = self._to8(mv2, h8, w8, rep)
        dec.ref8 = self._to8(best_ref, h8, w8, rep)
        if p.rd_level >= 2:      # the quadtree dial (x265 --rd)
            rd_ctx = (None if rd_refs is None
                      else (frame, rd_refs, []))
            with scope("rd_promote"):
                self._merge_cu32(dec, satd16, qpv, rd_ctx)
                self._merge_cu64(dec, satd16, qpv, rd_ctx)
        self._apply_intra_refresh(dec)
        return dec

    def _apply_intra_refresh(self, dec) -> None:
        """Periodic intra refresh (x265 --intra-refresh /
        x265_encoder_intra_refresh, x265.h:2108): a CTU column per P
        frame is forced intra, sweeping the frame every pic-width-in-CTUs
        frames — packet-loss recovery without IDR bitrate spikes. Runs
        after the RD passes: the forced CUs keep the analysis's intra
        modes."""
        p = self.param
        if not p.intra_refresh or dec.inter8 is None:
            return
        ncols = p.pic_width_in_ctbs
        col = self._ir_col % ncols
        self._ir_col = col + 1
        if col == 0:
            # refresh cycle starts: recovery point after ncols pictures
            self._ir_recovery = ncols - 1
        x0 = col * p.ctu_size
        x1 = min(p.width, x0 + p.ctu_size)
        dec.inter8[:, x0 >> 3:x1 >> 3] = False
        # a CU forced intra cannot stay 64x64: the intra transform tree
        # is TU==CU (max TB 32, ctu_writer._transform_tree_leaf), so
        # demote promoted 64-CUs in the refresh column to four 32s (the
        # column is whole CTUs wide, so the demotion never splits a CU)
        colmap = dec.cu_log2_map[:, x0 >> 3:x1 >> 3]
        colmap[colmap == 6] = 5

    def _b_decisions(self, y, ref0_y, ref1_y, qp=None, frame=None,
                     ref_tuples=None) -> FrameDecisions:
        """B-frame analysis: ME vs both anchors + bi-prediction trial
        (x265 checkBidir2Nx2N analog) + intra fallback, as batched argmin."""
        from x265_tpu_torch.engine.me import motion_fused
        from x265_tpu_torch.utils.profiling import scope
        p = self.param
        S = 16
        R = p.me_range
        qpv = qp if qp is not None else self._slice_qp(SLICE_B)
        lam = float(np.sqrt(0.85 * 2.0 ** ((qpv - 12) / 3.0)))
        with scope("analysis"):
            dec, icost = self._intra_analysis_with_cost(y)
        r0e, r1e = self._me_entry(ref0_y), self._me_entry(ref1_y)
        with scope("motion"):
            mv, cost, satd, bi_satd = motion_fused(
                np.asarray(y), [r0e, r1e],
                p.width, p.height, S=S, R=R, qp=qpv, subme=max(1, p.sub_me),
                bit_depth=p.bit_depth, do_bi=True,
                slack=48.0 if p.early_skip else 24.0,
                force_dense=p.me_method in ("full", "star", "sea"),
                mesh=self.mesh, device=self.device)
        return self._b_select(dec, icost, mv, cost, bi_satd, lam,
                              satd=satd, y=np.asarray(y),
                              refs=(r0e, r1e),
                              qp=qpv, frame=frame, ref_tuples=ref_tuples)

    def _b_select(self, dec, icost, mv, cost, bi_satd, lam, satd=None,
                  y=None, refs=None, qp=None, frame=None,
                  ref_tuples=None):
        """Per-block B choice (intra/L0/L1/bi) from batched ME results.
        The costs are host numpy in the reference's dtypes (float32 costs,
        int32 mvs and SATDs), so the argmin is the reference's."""
        from x265_tpu_torch.engine.me import _mv_bits, mv_field_median3
        from x265_tpu_torch.utils.profiling import scope
        p = self.param
        S = 16
        mv0, mv1 = mv[0], mv[1]
        c0, c1 = cost[0], cost[1]
        if not p.b_intra:      # --no-b-intra: inter-only B CUs
            icost = np.full_like(icost, np.inf)
        d0 = mv0 - mv_field_median3(mv0)
        d1 = mv1 - mv_field_median3(mv1)
        bi_bits = (_mv_bits(d0).sum(-1) + _mv_bits(d1).sum(-1))
        cbi = bi_satd.astype(np.float32) + lam * bi_bits
        icost = icost * 1.125 + lam * 12.0   # see _p_decisions

        costs = np.stack([icost, c0, c1, cbi])      # choice 0..3
        choice = np.argmin(costs, axis=0)
        inter_blk = choice > 0
        dir_blk = np.where(choice == 1, 1, np.where(choice == 2, 2, 3))
        nby, nbx = mv0.shape[:2]
        mv2 = np.zeros((nby, nbx, 2, 2), dtype=np.int32)
        use0 = (choice == 1) | (choice == 3)
        use1 = (choice == 2) | (choice == 3)
        mv2[:, :, 0] = np.where(use0[..., None], mv0, 0)
        mv2[:, :, 1] = np.where(use1[..., None], mv1, 0)
        satd16 = None
        pads = None
        if (p.rd_level >= 3 and frame is not None
                and ref_tuples is not None):
            from x265_tpu_torch.engine.me import dominant_tuples
            from x265_tpu_torch.models.rdo import rd_adopt16
            ref_blk = np.zeros((nby, nbx), np.int32)
            dir_blk = dir_blk.astype(np.int32)
            cands = dominant_tuples(dir_blk, mv2, ref_blk, inter_blk)
            pads = ([self._pad_ref(ref_tuples[0])],
                    [self._pad_ref(ref_tuples[1])])
            if cands:
                with scope("rd_adopt"):
                    dir_blk, mv2, _rb, _ad = rd_adopt16(
                        frame, pads[0], pads[1], inter_blk, mv2, dir_blk,
                        ref_blk, cands, qp if qp is not None else 32, p,
                        mesh=self.mesh, device=self.device)
        elif (p.rd_level >= 2 and satd is not None and y is not None
                and refs is not None):
            satd_now = np.where(
                choice == 1, satd[0],
                np.where(choice == 2, satd[1], bi_satd)).astype(np.float32)
            chosen_cost = np.take_along_axis(costs, choice[None], 0)[0]
            bits_now = ((chosen_cost - satd_now) / max(lam, 1e-3)
                        + np.where(choice == 3, 8.0, 6.0))
            ref_blk = np.zeros((nby, nbx), np.int32)
            dir_blk, mv2, _, satd16 = self._adopt_coherent(
                y, [refs[0]], [refs[1]], dir_blk.astype(np.int32), mv2,
                ref_blk, inter_blk, satd_now, bits_now, lam,
                qp if qp is not None else 32)
        h8, w8 = p.height >> 3, p.width >> 3
        rep = S >> 3
        dec.inter8 = self._to8(inter_blk, h8, w8, rep)
        dec.dir8 = self._to8(dir_blk.astype(np.int32), h8, w8, rep)
        dec.mv8 = self._to8(mv2, h8, w8, rep)
        if p.rd_level >= 2:
            rd_ctx = None
            if pads is not None and frame is not None:
                rd_ctx = (frame, pads[0], pads[1])
            with scope("rd_promote"):
                self._merge_cu32(dec, satd16, qp, rd_ctx)
                self._merge_cu64(dec, satd16, qp, rd_ctx)
        return dec

    def _precompute_b_batch(self, items, rec0, rec1):
        """Batched leaf-B analysis: the intra analysis and the motion
        search of ALL Bs sharing an anchor pair, decided at an estimated
        QP (the last rate-control qscale + 3) because the pictures' own
        QPs are known only when their rate-control start runs.
        items: [(poc, frame, cost, a0, a1, keep)]."""
        from x265_tpu_torch.engine.me import motion_fused_frames
        from x265_tpu_torch.engine.ratecontrol import qscale2qp
        from x265_tpu_torch.models.intra_frame import (
            finish_intra_analysis, submit_intra_analysis_batch)
        from x265_tpu_torch.utils.profiling import scope
        p = self.param
        cu_log2 = 4 if p.ctb_log2 >= 4 else p.ctb_log2
        ys = [it[1][0] for it in items]
        qp_est = int(round(qscale2qp(self.rc.last_qscale)))
        qp_est = max(0, min(51, qp_est + 3))
        lam = float(np.sqrt(0.85 * 2.0 ** ((qp_est - 12) / 3.0)))
        with scope("analysis"):
            handles = submit_intra_analysis_batch(
                ys, p.width, p.height, cu_log2, fast=p.fast_intra,
                psy=float(p.psy_rd), device=self.device)
        r0e, r1e = self._me_entry(rec0), self._me_entry(rec1)
        with scope("motion"):
            res = motion_fused_frames(
                ys, [r0e, r1e],
                p.width, p.height, R=p.me_range, qps=[qp_est] * len(ys),
                subme=max(1, p.sub_me), bit_depth=p.bit_depth, do_bi=True,
                slack=48.0 if p.early_skip else 24.0,
                force_dense=p.me_method in ("full", "star", "sea"),
                device=self.device)
        S = 1 << cu_log2
        ph = -(-p.height // S) * S
        pw = -(-p.width // S) * S
        for it, h, (mv, cost, satd, bi) in zip(items, handles, res):
            dec = finish_intra_analysis(h)
            icost = h[1].cpu().numpy().reshape(ph // S, pw // S)
            self._bdec_cache[it[0]] = self._b_select(
                dec, icost, mv, cost, bi, lam, satd=satd,
                y=np.asarray(it[1][0]),
                refs=(r0e, r1e),
                qp=qp_est, frame=tuple(np.asarray(x) for x in it[1]),
                ref_tuples=(rec0, rec1))

    def encode(self, frames) -> bytes:
        """Encode an iterable of (y, cb, cr) frames; returns full stream."""
        p = self.param
        if p.keyint == 1:
            return self._encode_all_intra_pipelined(frames)
        out = [self.headers()]
        for (y, cb, cr) in frames:
            out.append(self.encode_frame(y, cb, cr))
        out.append(self.flush())
        self.close()
        return b"".join(out)

    def _encode_all_intra_pipelined(self, frames) -> bytes:
        """All-intra path: the intra analysis of a chunk of frames is
        enqueued on the device before the host writer codes the chunk
        ahead of it (x265's frame threads as one device queue). Every
        access unit is an IDR at POC 0."""
        from collections import deque

        from x265_tpu_torch.models.intra_frame import (
            finish_intra_analysis, submit_intra_analysis_batch)
        from x265_tpu_torch.utils.profiling import scope
        p = self.param
        cu_log2 = 4 if p.ctb_log2 >= 4 else p.ctb_log2
        out = [self.headers()]
        frames = [self._clip_input(tuple(np.asarray(pl) for pl in f))
                  for f in frames]
        BATCH = 8        # frames per chunk
        INFLIGHT = 2     # chunks enqueued ahead of the writer
        pending = deque()
        idx = 0
        while idx < len(frames) or pending:
            # keep the device queue full: the analysis of the next chunks
            # runs while the host codes this one
            while idx < len(frames) and len(pending) < INFLIGHT:
                chunk = frames[idx:idx + BATCH]
                with scope("analysis"):
                    handles = submit_intra_analysis_batch(
                        [f[0] for f in chunk], p.width, p.height, cu_log2,
                        fast=p.fast_intra, psy=float(p.psy_rd),
                        device=self.device)
                pending.append((chunk, handles))
                idx += len(chunk)
            chunk, handles = pending.popleft()
            for f, h in zip(chunk, handles):
                with scope("analysis"):
                    dec = finish_intra_analysis(h)
                    # frame complexity for CRF/ABR: the analysis's
                    # per-block intra costs, summed on the host in the
                    # reference's dtype (float32) and order (numpy)
                    satd_cost = float(h[1].cpu().numpy().sum())
                qp = self.rc.start(SLICE_I, max(1.0, satd_cost))
                if p.rd_level >= 3:
                    from x265_tpu_torch.models.intra_rdo import \
                        rd_intra_promote32
                    with scope("rd_promote"):
                        rd_intra_promote32(f, dec, qp, p,
                                           device=self.device)
                self._gop_base = self.frame_count   # every AU is POC 0
                au = self._encode_intra_frame(*f, dec, qp=qp)
                self.rc.end(len(au) * 8)
                self.frame_count += 1
                out.append(au)
        self.close()
        return b"".join(out)

