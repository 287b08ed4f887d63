"""Encoder parameters: the x265_param analog.

Mirrors the *product surface* of x265's parameter system
(reference source/x265.h:744-1912 ``x265_param``; source/common/param.cpp:112
``x265_param_default``; preset tables param.cpp:375-630) as a typed Python
dataclass with the same layered resolution order:

    defaults -> preset -> tune -> explicit options -> profile/level -> fixups

Only options that the TPU engine currently honors are listed; unknown names
passed to :func:`param_parse` raise ``KeyError`` (matching
x265_param_parse's X265_PARAM_BAD_NAME behavior, param.cpp:778).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# --- enums (x265.h values kept where they are part of the product surface) ---

I_SLICE, P_SLICE, B_SLICE = 2, 1, 0  # slice_type syntax values (HEVC spec 7.4.7.1)

CSP_I400, CSP_I420, CSP_I422, CSP_I444 = 0, 1, 2, 3

# Rate-control modes (x265.h X265_RC_METHOD)
RC_ABR, RC_CQP, RC_CRF = 0, 1, 2

PRESETS = (
    "ultrafast", "superfast", "veryfast", "faster", "fast",
    "medium", "slow", "slower", "veryslow", "placebo",
)

TUNES = ("psnr", "ssim", "grain", "zerolatency", "fastdecode", "animation")


@dataclass
class Param:
    """Encoder configuration. Field groups follow x265_param's sections."""

    # --- source description ---
    width: int = 0
    height: int = 0
    fps_num: int = 25
    fps_den: int = 1
    csp: int = CSP_I420
    bit_depth: int = 8           # internal depth (Main=8, Main10=10)
    input_depth: int = 8

    # --- coding tree / quad-tree ---
    ctu_size: int = 64           # maxCUSize (16/32/64)
    min_cu_size: int = 8
    max_tu_size: int = 32
    tu_intra_depth: int = 1      # max_transform_hierarchy_depth_intra + 1
    tu_inter_depth: int = 1

    # --- GOP structure ---
    keyint: int = 250            # max keyframe interval
    min_keyint: int = 0          # 0 = auto (bframes+1)
    scenecut: int = 40           # 0 = off (x265 --scenecut)
    weightp: bool = True         # explicit weighted pred for P (--weightp)
    # HDR10 / colour signalling (x265 --master-display, --max-cll,
    # --colorprim/--transfer/--colormatrix/--range/--chromaloc, x265.h:611)
    master_display: str = ""     # "G(..)B(..)R(..)WP(..)L(..)"
    max_cll: str = ""            # "maxCLL,maxFALL"
    colorprim: str = ""
    transfer: str = ""
    colormatrix: str = ""
    video_full_range: bool = False
    chromaloc: int = -1
    hdr10: bool = False          # force-signal BT.2020/PQ even if unset
    hdr10_opt: bool = False      # luma-banded AQ bias for PQ content
    dhdr10_info: str = ""        # HDR10+ per-frame JSON (--dhdr10-info)
    dhdr10_opt: bool = False     # emit HDR10+ SEI only on IDR/changes
    dolby_vision_rpu: str = ""   # per-frame RPU file (--dolby-vision-rpu)
    dolby_vision_profile: str = ""  # 5 / 8.1 / 8.2 (signalling note only)
    zones: str = ""              # "start,end,q=QP/start,end,b=MULT" ranges
    tmvp: bool = True            # temporal MVP (x265 sps always-on analog)
    nr_intra: int = 0            # DCT-domain noise reduction 0-2000
    nr_inter: int = 0
    hrd: bool = False            # signal HRD (needs VBV; x265 --hrd)
    max_merge: int = 5           # merge candidates 1-5 (--max-merge)
    qp_min: int = 0              # RC clamp (--qpmin)
    qp_max: int = 51             # RC clamp (--qpmax)
    ip_factor: float = 1.4       # I/P qscale ratio (--ipratio)
    pb_factor: float = 1.3       # P/B qscale ratio (--pbratio)
    qcompress: float = 0.6       # complexity curve compression (--qcomp)
    bframe_bias: int = 0         # b-adapt bias toward Bs (--bframe-bias)
    sar: str = ""                # sample aspect ratio (--sar W:H or idc)
    videoformat: str = ""        # --videoformat component/pal/ntsc/...
    intra_refresh: bool = False  # periodic intra column (x265 --intra-refresh)
    frame_dup: bool = False      # drop duplicate frames + pic_struct
    #                              doubling/tripling (x265 --frame-dup)
    dup_threshold: int = 70      # luma PSNR (dB) to call a frame duplicate
    hist_scenecut: bool = False  # histogram-based scenecut (--hist-scenecut)
    bframes: int = 4
    b_adapt: int = 2
    b_pyramid: bool = True
    open_gop: bool = True
    rc_lookahead: int = 20
    ref: int = 3                 # max L0 references

    # --- analysis / RDO ---
    rd_level: int = 3
    intra_smoothing: bool = True  # strong_intra_smoothing_enabled_flag
    early_skip: bool = False
    fast_intra: bool = False
    sub_me: int = 2
    me_method: str = "hex"       # dia/hex/umh/star/sea/full
    me_range: int = 57
    rect: bool = False
    amp: bool = False
    b_intra: bool = True         # allow intra modes in B frames (--b-intra)
    weightb: bool = False        # weighted B pred — coerced off (no impl)
    constrained_intra: bool = False   # coerced off (no impl)
    cu_lossless: bool = False    # per-CU lossless trial — coerced off
    hme: bool = False            # hierarchical ME — the fused ME always
    #   runs the 2-level hierarchy (engine/me.py), flag is a hint
    hme_search: str = ""         # per-level method (hint; dense sweep)
    hme_range: str = ""          # per-level range (hint)
    rdpenalty: int = 0           # 32x32-TU intra penalty 0-2 (hint)
    ssim_rd: bool = False        # SSIM-RD cost — coerced off (no impl)
    lowpass_dct: bool = False    # coerced off (no impl)
    dynamic_rd: float = 0.0      # coerced off (no impl)
    # serial-CPU pruning dials: the batched analysis evaluates all
    # candidates in one dispatch, so these save nothing on TPU —
    # accepted for CLI compatibility, intentionally inert (_NOOP_HINTS)
    limit_refs: int = 3
    limit_modes: bool = False
    limit_tu: int = 0
    limit_sao: bool = False
    rskip: int = 1
    rskip_edge_threshold: int = 5
    tskip_fast: bool = False
    splitrd_skip: bool = False
    rd_refine: bool = False
    analyze_src_pics: bool = False   # ours always analyses source pics
    radl: int = 0                    # RADL leading-picture hint
    multi_pass_opt_analysis: bool = False   # 2-pass reuse dials — the
    multi_pass_opt_distortion: bool = False  # stats file always carries
    multi_pass_opt_rps: bool = False         # full records (hints)

    # --- quantization / rate control ---
    rc_mode: int = RC_CRF
    qp: int = 32
    crf: float = 28.0
    bitrate: int = 0             # kbps (ABR)
    vbv_bufsize: int = 0
    vbv_maxrate: int = 0
    aq_mode: int = 2
    aq_strength: float = 1.0
    cu_tree: bool = True
    rdoq_level: int = 0
    psy_rdoq: float = 0.0        # psy strength inside RDOQ level choice
    crf_min: float = 0.0         # CRF qscale clamps (--crf-min/max;
    crf_max: float = 0.0         #   0 = unset)
    qpstep: int = 4              # max inter-frame QP step (--qpstep)
    vbv_init: float = 0.9        # initial VBV fullness fraction
    vbv_end: float = 0.0         # final fullness target — coerced off
    vbv_end_fr_adj: float = 0.0
    strict_cbr: bool = False     # tighter ABR tracking (--strict-cbr)
    rc_grain: bool = False       # grain-preserving RC — hint
    qblur: float = 0.5           # 2-pass curve blur — hint (pass 2
    cplxblur: float = 20.0       #   re-plans exactly instead)
    aq_motion: bool = False      # coerced off (no impl)
    hevc_aq: bool = False        # coerced off (no impl)
    qp_adaptation_range: float = 1.0
    qg_size: int = 0             # QP group size (0/ctu = per-CTU dqp;
    #                              sub-CTU granularity coerced to CTU)
    scenecut_bias: float = 5.0   # scenecut threshold bias % (--scenecut-bias)
    gop_lookahead: int = 0       # keyframe placement lookahead — hint
    hist_threshold: float = 0.03  # --hist-threshold (scaled to our metric)
    psy_rd: float = 2.0          # psychovisual RD strength: weights
    #   |AC-energy(src)-AC-energy(recon)| into the recon-in-loop RD
    #   dispatches (models/rdo.py; x265 rdcost.h calcPsyRdCost).
    #   Active where those dispatches run (rd_level >= 3 presets).
    lossless: bool = False
    scaling_lists: str = ""      # ""/off | "default" (--scaling-list)
    tskip: bool = False          # transform skip on 4x4 TBs (--tskip)
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    sign_hide: bool = True

    # --- loop filters ---
    deblock: bool = True
    deblock_tc_offset: int = 0
    deblock_beta_offset: int = 0
    sao: bool = True

    # --- slices / parallelism (TPU: mesh axes) ---
    frame_parallelism: int = 2   # frames in flight (dispatch pipeline)
    wpp: bool = False            # emit WPP entry-point substreams
    #   (entropy_coding_sync). Analysis stays wave-free batched; WPP
    #   here is a bitstream/parallel-entropy feature: per-CTU-row
    #   substreams with the col-2 context handoff + entry points
    #   (entropy.cpp:724, frameencoder.cpp:1033 analog)
    slices: int = 1
    tiles: Tuple[int, int] = (1, 1)
    # thread-scheduling knobs from the reference's pool model: the TPU
    # runtime has no worker threads to steer — accepted, inert
    pools: str = ""
    lookahead_slices: int = 8
    lookahead_threads: int = 0
    pmode: bool = False
    pme: bool = False
    asm_opt: str = ""            # --asm (SIMD dispatch: no analog)
    force_flush: int = 0
    copy_pic: bool = True
    slow_firstpass: bool = False

    # --- bitstream / SEI ---
    annexb: bool = True
    aud: bool = False
    repeat_headers: bool = False
    decoded_picture_hash: int = 0  # 0=off 1=MD5 2=CRC 3=checksum
    temporal_id_nesting: bool = True
    vui_timing_info: bool = True
    log2_max_poc_lsb: int = 8    # SPS poc lsb bits (--log2-max-poc-lsb)
    info_sei: bool = True        # encoder-info user-data SEI (--info)
    idr_recovery_sei: bool = False   # recovery point SEI at keyframes
    single_sei: bool = False     # coerced off (one SEI per NAL)
    opt_qp_pps: bool = False     # coerced off
    temporal_layers: int = 0     # coerced off (no temporal scalability)
    pic_struct: int = -1         # forced pic_struct — hint
    uhd_bd: bool = False         # coerced off (UHD-BD constraints)
    allow_non_conformance: bool = False  # skip level clamps (--allow-non-conformance)
    interlace: int = 0           # coerced off (progressive only)
    min_luma: int = -1           # input clip range (--min-luma/--max-luma)
    max_luma: int = -1
    chunk_start: int = 0         # frame-range chunking — hint (CLI trims)
    chunk_end: int = 0
    sao_non_deblock: bool = False    # coerced off
    selective_sao: int = 4       # coerced to full-frame SAO

    # --- profile/level ---
    profile: str = ""            # "", "main", "main10", "main444-8" ...
    level_idc: int = 0           # 0 = auto
    high_tier: bool = False

    # --- analysis reuse (x265 --analysis-save/load) ---
    analysis_save: str = ""
    analysis_load: str = ""
    analysis_reuse_level: int = 10   # stored reuse always carries the
    #   full decision tensors (level-10 semantics); lower levels are
    #   accepted and coerced up
    analysis_reuse_mode: str = ""    # legacy save/load selector
    analysis_reuse_file: str = ""    # legacy file name
    scale_factor: int = 0        # cross-res analysis reuse (analysis_io
    #                              rescale path; 0 = same resolution)
    refine_intra: int = 0        # load-side refinement dials — coerced
    refine_inter: int = 0        #   (loaded decisions are reused as-is)
    refine_mv: int = 0

    # --- per-frame QP/type forcing (x265 --qpfile; x265cli.h qpfile) ---
    qpfile: str = ""

    # --- multi-pass rate control (x265 --pass/--stats) ---
    pass_num: int = 0            # 0=single pass, 1=analysis, 2=final
    stats_file: str = "x265_tpu_2pass.log"

    # --- logging / metrics (x265 --psnr/--ssim: off by default) ---
    psnr_metrics: bool = False
    log_level: int = 2
    csv: str = ""
    csv_log_level: int = 0

    # --- resolved (derived) values, filled by check_params ---
    total_frames: int = 0

    # ---- derived helpers ----
    @property
    def ctb_log2(self) -> int:
        return self.ctu_size.bit_length() - 1

    @property
    def min_cb_log2(self) -> int:
        return self.min_cu_size.bit_length() - 1

    @property
    def pic_width_in_ctbs(self) -> int:
        return (self.width + self.ctu_size - 1) // self.ctu_size

    @property
    def pic_height_in_ctbs(self) -> int:
        return (self.height + self.ctu_size - 1) // self.ctu_size

    def copy(self) -> "Param":
        return dataclasses.replace(self)


def param_default() -> Param:
    """Defaults equivalent in intent to x265_param_default (param.cpp:112)."""
    return Param()


# Preset table: the speed/quality dial of x265 (param.cpp:390-560,
# doc/reST/presets.rst:35-104). Values are the knobs the TPU engine honors.
_PRESET_TABLE = {
    #              ctu  bframes b_adapt rc_la ref rd  subme me      rect  amp   early rdoq aq
    "ultrafast":  dict(ctu_size=32, bframes=3, b_adapt=0, rc_lookahead=5,  ref=1, rd_level=2, sub_me=0, me_method="dia", rect=False, amp=False, early_skip=True,  rdoq_level=0, aq_mode=0, cu_tree=False, sao=False, deblock=False, tu_intra_depth=1, fast_intra=True, weightp=False),
    "superfast":  dict(ctu_size=32, bframes=3, b_adapt=0, rc_lookahead=10, ref=1, rd_level=2, sub_me=1, me_method="hex", rect=False, amp=False, early_skip=True,  rdoq_level=0, aq_mode=0, cu_tree=False, sao=False, deblock=True,  tu_intra_depth=1, fast_intra=True, weightp=False),
    "veryfast":   dict(ctu_size=64, bframes=4, b_adapt=0, rc_lookahead=15, ref=2, rd_level=2, sub_me=1, me_method="hex", rect=False, amp=False, early_skip=True,  rdoq_level=0, aq_mode=2, cu_tree=True,  sao=True,  deblock=True,  tu_intra_depth=1, fast_intra=True),
    "faster":     dict(ctu_size=64, bframes=4, b_adapt=0, rc_lookahead=15, ref=2, rd_level=2, sub_me=2, me_method="hex", rect=False, amp=False, early_skip=True,  rdoq_level=0, aq_mode=2, cu_tree=True,  sao=True,  deblock=True,  tu_intra_depth=1, fast_intra=True),
    "fast":       dict(ctu_size=64, bframes=4, b_adapt=0, rc_lookahead=15, ref=3, rd_level=2, sub_me=2, me_method="hex", rect=False, amp=False, early_skip=False, rdoq_level=0, aq_mode=2, cu_tree=True,  sao=True,  deblock=True,  tu_intra_depth=1, fast_intra=True),
    "medium":     dict(ctu_size=64, bframes=4, b_adapt=2, rc_lookahead=20, ref=3, rd_level=3, sub_me=2, me_method="hex", rect=False, amp=False, early_skip=False, rdoq_level=0, aq_mode=2, cu_tree=True,  sao=True,  deblock=True,  tu_intra_depth=1, fast_intra=False),
    "slow":       dict(tu_inter_depth=2, ctu_size=64, bframes=4, b_adapt=2, rc_lookahead=25, ref=4, rd_level=4, sub_me=3, me_method="star", rect=True, amp=False, early_skip=False, rdoq_level=2, aq_mode=2, cu_tree=True,  sao=True,  deblock=True,  tu_intra_depth=1, fast_intra=False),
    "slower":     dict(tu_inter_depth=2, ctu_size=64, bframes=8, b_adapt=2, rc_lookahead=40, ref=5, rd_level=6, sub_me=4, me_method="star", rect=True, amp=True,  early_skip=False, rdoq_level=2, aq_mode=2, cu_tree=True,  sao=True,  deblock=True,  tu_intra_depth=3, fast_intra=False),
    "veryslow":   dict(tu_inter_depth=2, ctu_size=64, bframes=8, b_adapt=2, rc_lookahead=40, ref=5, rd_level=6, sub_me=4, me_method="star", rect=True, amp=True,  early_skip=False, rdoq_level=2, aq_mode=2, cu_tree=True,  sao=True,  deblock=True,  tu_intra_depth=3, fast_intra=False),
    "placebo":    dict(tu_inter_depth=2, ctu_size=64, bframes=8, b_adapt=2, rc_lookahead=60, ref=5, rd_level=6, sub_me=5, me_method="star", rect=True, amp=True,  early_skip=False, rdoq_level=2, aq_mode=2, cu_tree=True,  sao=True,  deblock=True,  tu_intra_depth=3, fast_intra=False),
}


def param_default_preset(preset: str = "medium", tune: Optional[str] = None) -> Param:
    """x265_param_default_preset analog (param.cpp:375)."""
    p = param_default()
    if preset:
        if preset not in _PRESET_TABLE:
            raise ValueError(f"unknown preset: {preset}")
        for k, v in _PRESET_TABLE[preset].items():
            setattr(p, k, v)
    if tune:
        if tune not in TUNES:
            raise ValueError(f"unknown tune: {tune}")
        if tune == "psnr":
            p.aq_strength = 0.0
            p.psy_rd = 0.0
        elif tune == "ssim":
            p.aq_mode = 2
            p.psy_rd = 0.0
        elif tune == "grain":
            p.aq_mode = 0
            p.psy_rd = 4.0
            p.rdoq_level = 2
        elif tune == "zerolatency":
            p.bframes = 0
            p.rc_lookahead = 0
            p.frame_parallelism = 1
            p.b_adapt = 0
        elif tune == "fastdecode":
            p.deblock = False
            p.sao = False
            p.sign_hide = False
    return p


# String option names (the x265 CLI/API names we support so far) -> setter.
_OPT_ALIASES = {
    "input-res": None,  # handled by CLI
    "ctu": "ctu_size",
    "min-cu-size": "min_cu_size",
    "max-tu-size": "max_tu_size",
    "tu-intra-depth": "tu_intra_depth",
    "tu-inter-depth": "tu_inter_depth",
    "keyint": "keyint",
    "min-keyint": "min_keyint",
    "scenecut": "scenecut",
    "weightp": "weightp",
    "w": "weightp",
    "master-display": "master_display",
    "max-cll": "max_cll",
    "colorprim": "colorprim",
    "transfer": "transfer",
    "colormatrix": "colormatrix",
    "range": "video_full_range",
    "chromaloc": "chromaloc",
    "hdr10": "hdr10",
    "hdr": "hdr10",
    "dhdr10-info": "dhdr10_info",
    "dhdr10-opt": "dhdr10_opt",
    "dolby-vision-rpu": "dolby_vision_rpu",
    "dolby-vision-profile": "dolby_vision_profile",
    "zones": "zones",
    "tmvp": "tmvp",
    "temporal-mvp": "tmvp",
    "nr-intra": "nr_intra",
    "nr-inter": "nr_inter",
    "hrd": "hrd",
    "b-pyramid": "b_pyramid",
    "input-depth": "input_depth",
    "output-depth": "bit_depth",
    "vui-timing-info": "vui_timing_info",
    "max-merge": "max_merge",
    "qpmin": "qp_min",
    "qpmax": "qp_max",
    "ipratio": "ip_factor",
    "pbratio": "pb_factor",
    "qcomp": "qcompress",
    "bframe-bias": "bframe_bias",
    "sar": "sar",
    "videoformat": "videoformat",
    "intra-refresh": "intra_refresh",
    "frame-dup": "frame_dup",
    "dup-threshold": "dup_threshold",
    "hist-scenecut": "hist_scenecut",
    "bframes": "bframes",
    "b-adapt": "b_adapt",
    "open-gop": "open_gop",
    "rc-lookahead": "rc_lookahead",
    "ref": "ref",
    "rd": "rd_level",
    "subme": "sub_me",
    "me": "me_method",
    "merange": "me_range",
    "rect": "rect",
    "amp": "amp",
    "early-skip": "early_skip",
    "fast-intra": "fast_intra",
    "strong-intra-smoothing": "intra_smoothing",
    "qp": "qp",
    "crf": "crf",
    "bitrate": "bitrate",
    "vbv-bufsize": "vbv_bufsize",
    "vbv-maxrate": "vbv_maxrate",
    "aq-mode": "aq_mode",
    "aq-strength": "aq_strength",
    "cutree": "cu_tree",
    "rdoq-level": "rdoq_level",
    "psy-rd": "psy_rd",
    "lossless": "lossless",
    "scaling-list": "scaling_lists",
    "tskip": "tskip",
    "cbqpoffs": "cb_qp_offset",
    "crqpoffs": "cr_qp_offset",
    "signhide": "sign_hide",
    "deblock": "deblock",
    "sao": "sao",
    "frame-threads": "frame_parallelism",
    "wpp": "wpp",
    "slices": "slices",
    "annexb": "annexb",
    "aud": "aud",
    "repeat-headers": "repeat_headers",
    "hash": "decoded_picture_hash",
    "profile": "profile",
    "level-idc": "level_idc",
    "high-tier": "high_tier",
    "log-level": "log_level",
    "csv": "csv",
    "csv-log-level": "csv_log_level",
    "psnr": "psnr_metrics",
    "ssim": "psnr_metrics",
    "analysis-save": "analysis_save",
    "analysis-load": "analysis_load",
    "qpfile": "qpfile",
    "pass": "pass_num",
    "stats": "stats_file",
    "fps": None,  # handled specially
    "frames": "total_frames",
    "total-frames": "total_frames",
    # --- analysis / RDO surface (param.cpp:778 names) ---
    "b-intra": "b_intra",
    "weightb": "weightb",
    "constrained-intra": "constrained_intra",
    "cip": "constrained_intra",
    "cu-lossless": "cu_lossless",
    "hme": "hme",
    "hme-search": "hme_search",
    "hme-range": "hme_range",
    "rdpenalty": "rdpenalty",
    "ssim-rd": "ssim_rd",
    "lowpass-dct": "lowpass_dct",
    "dynamic-rd": "dynamic_rd",
    "limit-refs": "limit_refs",
    "limit-modes": "limit_modes",
    "limit-tu": "limit_tu",
    "limit-sao": "limit_sao",
    "rskip": "rskip",
    "rskip-edge-threshold": "rskip_edge_threshold",
    "tskip-fast": "tskip_fast",
    "splitrd-skip": "splitrd_skip",
    "rd-refine": "rd_refine",
    "analyze-src-pics": "analyze_src_pics",
    "radl": "radl",
    "multi-pass-opt-analysis": "multi_pass_opt_analysis",
    "multi-pass-opt-distortion": "multi_pass_opt_distortion",
    "multi-pass-opt-rps": "multi_pass_opt_rps",
    "rdoq": "rdoq_level",
    # --- rate control surface ---
    "psy-rdoq": "psy_rdoq",
    "crf-min": "crf_min",
    "crf-max": "crf_max",
    "qpstep": "qpstep",
    "vbv-init": "vbv_init",
    "vbv-end": "vbv_end",
    "vbv-end-fr-adj": "vbv_end_fr_adj",
    "strict-cbr": "strict_cbr",
    "const-vbv": "strict_cbr",
    "rc-grain": "rc_grain",
    "qblur": "qblur",
    "cplxblur": "cplxblur",
    "aq-motion": "aq_motion",
    "hevc-aq": "hevc_aq",
    "qp-adaptation-range": "qp_adaptation_range",
    "qg-size": "qg_size",
    "scenecut-bias": "scenecut_bias",
    "gop-lookahead": "gop_lookahead",
    "hist-threshold": "hist_threshold",
    # --- threading-model hints (inert on TPU by design) ---
    "pools": "pools",
    "numa-pools": "pools",
    "lookahead-slices": "lookahead_slices",
    "lookahead-threads": "lookahead_threads",
    "pmode": "pmode",
    "pme": "pme",
    "asm": "asm_opt",
    "force-flush": "force_flush",
    "copy-pic": "copy_pic",
    "slow-firstpass": "slow_firstpass",
    # --- bitstream / VUI / SEI surface ---
    "log2-max-poc-lsb": "log2_max_poc_lsb",
    "info": "info_sei",
    "idr-recovery-sei": "idr_recovery_sei",
    "single-sei": "single_sei",
    "opt-qp-pps": "opt_qp_pps",
    "temporal-layers": "temporal_layers",
    "pic-struct": "pic_struct",
    "uhd-bd": "uhd_bd",
    "allow-non-conformance": "allow_non_conformance",
    "interlace": "interlace",
    "field": "interlace",
    "min-luma": "min_luma",
    "max-luma": "max_luma",
    "chunk-start": "chunk_start",
    "chunk-end": "chunk_end",
    "sao-non-deblock": "sao_non_deblock",
    "selective-sao": "selective_sao",
    "cll": "max_cll",
    "hdr-opt": "hdr10_opt",
    "hdr10-opt": "hdr10_opt",
    "vui-hrd-info": "hrd",
    # --- analysis reuse surface ---
    "analysis-save-reuse-level": "analysis_reuse_level",
    "analysis-load-reuse-level": "analysis_reuse_level",
    "analysis-reuse-level": "analysis_reuse_level",
    "analysis-reuse-mode": "analysis_reuse_mode",
    "analysis-reuse-file": "analysis_reuse_file",
    "scale-factor": "scale_factor",
    "refine-intra": "refine_intra",
    "refine-inter": "refine_inter",
    "refine-mv": "refine_mv",
}

_BOOL_TRUE = {"1", "true", "yes", "on"}
_BOOL_FALSE = {"0", "false", "no", "off"}


def param_parse(p: Param, name: str, value: str = "1") -> None:
    """x265_param_parse analog (param.cpp:778): set one option by CLI name.

    Supports the ``no-`` prefix for booleans.
    """
    name = name.strip().lower()
    if name.startswith("no-"):
        name = name[3:]
        value = "0"
    if name == "fps":
        if "/" in value:
            n, d = value.split("/")
            p.fps_num, p.fps_den = int(n), int(d)
        else:
            f = float(value)
            if f == int(f):
                p.fps_num, p.fps_den = int(f), 1
            else:
                p.fps_num, p.fps_den = int(round(f * 1000)), 1000
        return
    if name == "preset":
        newp = param_default_preset(value)
        for f_ in dataclasses.fields(Param):
            setattr(p, f_.name, getattr(newp, f_.name))
        return
    if name == "range":
        # x265cli accepts full/limited names
        v = value.strip().lower()
        p.video_full_range = v in ("full", "1", "true", "yes", "on")
        return
    if name in ("interlace", "field"):
        # accepts false/true/tff/bff (x265cli); progressive-only engine
        # coerces non-zero in check_params
        v = value.strip().lower()
        p.interlace = {"0": 0, "false": 0, "prog": 0, "1": 1,
                       "true": 1, "tff": 1, "bff": 2}.get(v, 1)
        return
    if name == "input-csp":
        v = value.strip().lower()
        m = {"i400": CSP_I400, "400": CSP_I400, "i420": CSP_I420,
             "420": CSP_I420, "i422": CSP_I422, "422": CSP_I422,
             "i444": CSP_I444, "444": CSP_I444}
        if v not in m:
            raise ValueError(f"bad input-csp: {value}")
        p.csp = m[v]
        return
    if name.startswith("svt"):
        raise KeyError("SVT-HEVC passthrough is not built into this "
                       "encoder (x265 without ENABLE_SVT_HEVC rejects "
                       "these the same way)")
    if name not in _OPT_ALIASES or _OPT_ALIASES[name] is None:
        raise KeyError(f"unknown option: {name}")
    # rate-control selectors switch the RC mode, exactly like
    # x265_param_parse (param.cpp:778 "qp"/"crf"/"bitrate" cases)
    if name == "qp":
        p.rc_mode = RC_CQP
    elif name == "crf":
        p.rc_mode = RC_CRF
    elif name == "bitrate":
        p.rc_mode = RC_ABR
    attr = _OPT_ALIASES[name]
    cur = getattr(p, attr)
    if isinstance(cur, bool):
        v = value.strip().lower()
        if v in _BOOL_TRUE:
            setattr(p, attr, True)
        elif v in _BOOL_FALSE:
            setattr(p, attr, False)
        else:
            raise ValueError(f"bad boolean for {name}: {value}")
    elif isinstance(cur, int):
        setattr(p, attr, int(value))
    elif isinstance(cur, float):
        setattr(p, attr, float(value))
    else:
        setattr(p, attr, value)


# Option-surface bookkeeping (VERDICT r1 "honor or reject"): every Param
# field is either read by engine code ("honored"), coerced to a supported
# value with a logged warning ("coerced"), or structural/informational.
# tests/test_api_misc.py asserts the coerce list stays in sync.
COERCED_OPTIONS = {
    # (field, unsupported-when, forced-to, why)
    "rect": "rectangular PUs not implemented (quadtree is square-only)",
    "amp": "asymmetric PUs not implemented",
    "tu_intra_depth": "RQT depth >1 not implemented (TU == CU)",
    "tiles": "tiles not implemented (use --slices for picture splitting)",
    "weightb": "weighted B prediction not implemented",
    "constrained_intra": "constrained intra prediction not implemented",
    "cu_lossless": "per-CU lossless trial not implemented",
    "ssim_rd": "SSIM-RD cost function not implemented",
    "lowpass_dct": "lowpass DCT approximation not implemented",
    "dynamic_rd": "dynamic RD levels not implemented",
    "aq_motion": "motion-adaptive AQ not implemented",
    "hevc_aq": "hevc-aq (qp-adaptation-range) mode not implemented",
    "interlace": "interlace/field coding not implemented (progressive)",
    "single_sei": "single-NAL SEI packing not implemented",
    "opt_qp_pps": "PPS init-QP optimization not implemented",
    "temporal_layers": "temporal scalability not implemented",
    "uhd_bd": "UHD-BD constraint set not implemented",
    "sao_non_deblock": "SAO on pre-deblock pixels not implemented",
    "selective_sao": "selective SAO levels not implemented (full frame)",
    "vbv_end": "end-of-stream VBV fullness target not implemented",
    "refine_intra": "analysis-load refinement reuses decisions as-is",
    "refine_inter": "analysis-load refinement reuses decisions as-is",
    "refine_mv": "analysis-load refinement reuses decisions as-is",
    "qg_size": "sub-CTU QP groups not implemented (QG == CTU)",
}

# serial-CPU scheduling/pruning knobs: the batched TPU analysis
# evaluates all candidates in one dispatch and has no worker threads to
# steer, so these have nothing to act on — parsed for CLI compatibility
# and intentionally inert (the "re-imagined" class, SURVEY §2.4).
NOOP_HINTS = (
    "limit_refs", "limit_modes", "limit_tu", "limit_sao", "rskip",
    "rskip_edge_threshold", "tskip_fast", "splitrd_skip", "rd_refine",
    "rdpenalty", "hme", "hme_search", "hme_range", "pools",
    "lookahead_slices", "lookahead_threads", "pmode", "pme", "asm_opt",
    "force_flush", "copy_pic", "slow_firstpass", "analyze_src_pics",
    "rc_grain", "qblur", "cplxblur", "qp_adaptation_range",
    "gop_lookahead", "pic_struct", "chunk_start", "chunk_end",
    "vbv_end_fr_adj", "radl", "multi_pass_opt_analysis",
    "multi_pass_opt_distortion", "multi_pass_opt_rps",
)

# (field, is-unsupported predicate, forced value) for the simple rows
_COERCE_SIMPLE = (
    ("weightb", lambda v: bool(v), False),
    ("constrained_intra", lambda v: bool(v), False),
    ("cu_lossless", lambda v: bool(v), False),
    ("ssim_rd", lambda v: bool(v), False),
    ("lowpass_dct", lambda v: bool(v), False),
    ("dynamic_rd", lambda v: v != 0.0, 0.0),
    ("aq_motion", lambda v: bool(v), False),
    ("hevc_aq", lambda v: bool(v), False),
    ("interlace", lambda v: v != 0, 0),
    ("single_sei", lambda v: bool(v), False),
    ("opt_qp_pps", lambda v: bool(v), False),
    ("temporal_layers", lambda v: v != 0, 0),
    ("uhd_bd", lambda v: bool(v), False),
    ("sao_non_deblock", lambda v: bool(v), False),
    ("selective_sao", lambda v: v != 4, 4),
    ("vbv_end", lambda v: v != 0.0, 0.0),
    ("refine_intra", lambda v: v != 0, 0),
    ("refine_inter", lambda v: v != 0, 0),
    ("refine_mv", lambda v: v != 0, 0),
)


_warned = set()


def _warn(p: Param, msg: str) -> None:
    if p.log_level >= 2 and msg not in _warned:
        _warned.add(msg)
        import sys
        print(f"x265_tpu_torch [warning]: {msg}", file=sys.stderr)


def check_params(p: Param) -> Param:
    """Validate + apply implication fixups (x265_check_params param.cpp:1519
    + Encoder::configure encoder.cpp:3484 equivalents)."""
    if p.width <= 0 or p.height <= 0:
        raise ValueError("width/height must be set")
    # honor-or-coerce: unimplemented tools are forced off loudly instead
    # of being silently ignored
    if p.rect:
        _warn(p, COERCED_OPTIONS["rect"] + " — forcing --no-rect")
        p.rect = False
    if p.amp:
        _warn(p, COERCED_OPTIONS["amp"] + " — forcing --no-amp")
        p.amp = False
    if p.tu_inter_depth > 2:
        # one explicit split level is implemented (x265 tuQTMaxInterDepth
        # 1..4, x265.h:1079); deeper trees clamp with a warning
        _warn(p, "tu-inter-depth > 2 not implemented"
              + " — forcing --tu-inter-depth 2")
        p.tu_inter_depth = 2
    if p.tu_inter_depth > 1 and p.tskip:
        _warn(p, "tu-inter-depth 2 with --tskip not implemented"
              + " — forcing --tu-inter-depth 1")
        p.tu_inter_depth = 1
    if p.tu_intra_depth > 1:
        _warn(p, COERCED_OPTIONS["tu_intra_depth"]
              + " — forcing --tu-intra-depth 1")
        p.tu_intra_depth = 1
    if p.wpp and p.slices > 1:
        # WPP substreams and multi-slice entropy sharding are both
        # emitted per picture in x265 but our finalizer picks one
        # payload-splitting axis per stream; rows win when asked for
        _warn(p, "--wpp replaces --slices as the entropy split "
              "— forcing --slices 1")
        p.slices = 1
    if p.tiles != (1, 1):
        _warn(p, COERCED_OPTIONS["tiles"] + " — forcing 1x1")
        p.tiles = (1, 1)
    for (fld, bad, forced) in _COERCE_SIMPLE:
        if bad(getattr(p, fld)):
            _warn(p, COERCED_OPTIONS[fld] + f" — forcing {fld}={forced}")
            setattr(p, fld, forced)
    if p.qg_size not in (0, p.ctu_size):
        _warn(p, COERCED_OPTIONS["qg_size"] + f" — forcing {p.ctu_size}")
        p.qg_size = p.ctu_size
    if p.analysis_reuse_level not in (0, 10):
        _warn(p, "analysis reuse always stores/loads the full decision "
              "tensors — treating reuse level as 10")
        p.analysis_reuse_level = 10
    # legacy --analysis-reuse-mode/file pair maps onto save/load
    if p.analysis_reuse_mode:
        m = p.analysis_reuse_mode.strip().lower()
        fname = p.analysis_reuse_file or "x265_analysis.dat"
        if m == "save" and not p.analysis_save:
            p.analysis_save = fname
        elif m == "load" and not p.analysis_load:
            p.analysis_load = fname
    # --scale-factor rides the analysis_io cross-resolution rescale on
    # load; only 0/1/2 are meaningful (x265 supports 2 only)
    if p.scale_factor not in (0, 1, 2):
        _warn(p, "scale-factor supports 2 only — clamping")
        p.scale_factor = 2 if p.scale_factor > 2 else 0
    # --scaling-list: "0"/"off" => flat (no lists); "default" => spec
    # default matrices (scalinglist.cpp:417 setDefaultScalingList).
    # Custom list files (HM-format cfg) are not parsed yet.
    if p.scaling_lists in ("0", "off", "none"):
        p.scaling_lists = ""
    elif p.scaling_lists and p.scaling_lists != "default":
        _warn(p, f"custom scaling list file {p.scaling_lists!r} not "
              "supported — using the default matrices")
        p.scaling_lists = "default"
    if p.rc_lookahead > 32:
        _warn(p, "rc-lookahead clamped to 32 (queue and b-adapt window "
              "cap; x265 allows 250)")
        p.rc_lookahead = 32
    # rd-level implications (presets.rst: rdoq engages at rd >= 5; our
    # dial additionally gates the 32x32 promotion pass at rd >= 2)
    if p.rd_level >= 5 and p.rdoq_level == 0:
        p.rdoq_level = 2
    if p.ctu_size not in (16, 32, 64):
        raise ValueError("ctu_size must be 16/32/64")
    if p.min_cu_size not in (8, 16, 32) or p.min_cu_size > p.ctu_size:
        raise ValueError("bad min_cu_size")
    if p.width % p.min_cu_size or p.height % p.min_cu_size:
        # HEVC requires pic dims to be multiples of minCbSize; x265 pads via
        # the conformance window. We support exact multiples of 8 for now.
        if p.width % 8 or p.height % 8:
            raise ValueError("width/height must be multiples of 8 (conformance window TODO)")
    if p.bit_depth not in (8, 10):
        raise ValueError("bit_depth must be 8 or 10")
    if p.lossless:
        p.rc_mode = RC_CQP
        p.qp = 4              # lambda source for RDO (doc/reST/lossless.rst:43-45)
        p.rdoq_level = 0
        p.scaling_lists = ""  # no transform, no matrices
        p.tskip = False       # no transform to skip
        p.sao = False
        p.deblock = False
        p.sign_hide = False
        p.aq_mode = 0
        p.cu_tree = False
    if p.csp != CSP_I420:
        raise ValueError("only 4:2:0 supported so far")
    if not p.profile:
        p.profile = "main" if p.bit_depth == 8 else "main10"
    return p


# H.273 colour description name -> code tables (x265 x265.h:vui strings)
COLOUR_PRIMARIES = {
    "bt709": 1, "unknown": 2, "bt470m": 4, "bt470bg": 5, "smpte170m": 6,
    "smpte240m": 7, "film": 8, "bt2020": 9, "smpte428": 10,
    "smpte431": 11, "smpte432": 12,
}
TRANSFER_CHARACTERISTICS = {
    "bt709": 1, "unknown": 2, "bt470m": 4, "bt470bg": 5, "smpte170m": 6,
    "smpte240m": 7, "linear": 8, "log100": 9, "log316": 10,
    "iec61966-2-4": 11, "bt1361e": 12, "iec61966-2-1": 13, "srgb": 13,
    "bt2020-10": 14, "bt2020-12": 15, "smpte2084": 16, "smpte428": 17,
    "arib-std-b67": 18,
}
MATRIX_COEFFS = {
    "gbr": 0, "bt709": 1, "unknown": 2, "fcc": 4, "bt470bg": 5,
    "smpte170m": 6, "smpte240m": 7, "ycgco": 8, "bt2020nc": 9,
    "bt2020c": 10, "smpte2085": 11,
}


# E.2.1 tables (x265 x265cli.h strings)
SAR_TABLE = {  # idc -> (w, h); --sar accepts the idc, a name, or W:H
    "1:1": 1, "12:11": 2, "10:11": 3, "16:11": 4, "40:33": 5, "24:11": 6,
    "20:11": 7, "32:11": 8, "80:33": 9, "18:11": 10, "15:11": 11,
    "64:33": 12, "160:99": 13, "4:3": 14, "3:2": 15, "2:1": 16,
}
VIDEO_FORMATS = {"component": 0, "pal": 1, "ntsc": 2, "secam": 3,
                 "mac": 4, "unknown": 5, "undef": 5}
