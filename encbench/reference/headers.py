"""Parameter-set and slice-header syntax (HEVC spec 7.3.2, 7.3.6).

Writer + parser pairs over the same dataclasses, used by both the encoder
and the in-repo reference decoder. Functional analog of x265's
Entropy::codeVPS/codeSPS/codePPS/codeSliceHeader
(reference source/encoder/entropy.cpp:238-724) and the Slice/SPS/PPS types
(source/common/slice.h).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from encbench.reference.bitstream import (
    BitReader, BitWriter, NAL_IDR_N_LP, NAL_IDR_W_RADL, NAL_CRA,
    NAL_BLA_W_LP,
)

# Slice types (spec 7.4.7.1)
SLICE_B, SLICE_P, SLICE_I = 0, 1, 2


@dataclass
class ProfileTierLevel:
    profile_idc: int = 1            # 1=Main, 2=Main10
    tier_flag: int = 0
    level_idc: int = 120            # level 4.0 => 120; CIF ~ level 2.0 => 60
    progressive_source: bool = True
    interlaced_source: bool = False
    non_packed: bool = True
    frame_only: bool = True


@dataclass
class ShortTermRPS:
    num_negative: int = 0
    num_positive: int = 0
    delta_poc_s0: List[int] = field(default_factory=list)   # negative deltas
    used_s0: List[bool] = field(default_factory=list)
    delta_poc_s1: List[int] = field(default_factory=list)
    used_s1: List[bool] = field(default_factory=list)


@dataclass
class VPS:
    max_sub_layers: int = 1
    max_dec_pic_buffering: int = 1
    num_reorder_pics: int = 0
    ptl: ProfileTierLevel = field(default_factory=ProfileTierLevel)


@dataclass
class SPS:
    sps_id: int = 0
    vps_id: int = 0
    chroma_format_idc: int = 1
    width: int = 0
    height: int = 0
    conf_win: tuple = (0, 0, 0, 0)      # left, right, top, bottom (in chroma units)
    bit_depth: int = 8
    log2_max_poc_lsb: int = 8
    max_dec_pic_buffering: int = 1
    num_reorder_pics: int = 0
    log2_min_cb: int = 3
    log2_diff_max_min_cb: int = 3
    log2_min_tb: int = 2
    log2_diff_max_min_tb: int = 3
    max_transform_hierarchy_depth_inter: int = 0
    max_transform_hierarchy_depth_intra: int = 0
    scaling_list_enabled: bool = False
    # None = default matrices (sps_scaling_list_data_present_flag=0);
    # else {(sizeId, matrixId): (vals_diag_order ndarray, dc int)}
    scaling_list_data: Optional[dict] = None
    amp_enabled: bool = False
    sao_enabled: bool = False
    pcm_enabled: bool = False
    short_term_rps: List[ShortTermRPS] = field(default_factory=list)
    long_term_ref_pics_present: bool = False
    temporal_mvp_enabled: bool = False
    strong_intra_smoothing: bool = True
    vui_present: bool = False
    frame_field_info: bool = False   # VUI flag: pic_timing carries
    #                                  pic_struct (frame-dup signalling)
    # VUI colour description (H.273); 0/unset = not signalled
    colour_primaries: int = 0
    transfer_characteristics: int = 0
    matrix_coeffs: int = -1          # -1 unset (0 is a valid value: GBR)
    video_full_range: bool = False
    chroma_loc: int = -1             # -1 = not signalled
    # HRD (E.2.2): signalled when hrd_bitrate > 0 (x265 --hrd; values
    # from the VBV config, hrd.cpp analog)
    hrd_bitrate: int = 0             # bits/second
    hrd_cpb_size: int = 0            # bits
    sar_idc: int = 0                 # aspect_ratio_idc (0 = unspecified)
    sar_width: int = 0               # for sar_idc 255 (Extended_SAR)
    sar_height: int = 0
    video_format: int = 5            # E.2.1 video_format (5 = unspecified)
    fps_num: int = 0
    fps_den: int = 0
    ptl: ProfileTierLevel = field(default_factory=ProfileTierLevel)

    # derived
    @property
    def ctb_log2(self) -> int:
        return self.log2_min_cb + self.log2_diff_max_min_cb

    @property
    def ctb_size(self) -> int:
        return 1 << self.ctb_log2

    @property
    def pic_width_in_ctbs(self) -> int:
        return -(-self.width // self.ctb_size)

    @property
    def pic_height_in_ctbs(self) -> int:
        return -(-self.height // self.ctb_size)


@dataclass
class PPS:
    pps_id: int = 0
    sps_id: int = 0
    sign_data_hiding: bool = False
    cabac_init_present: bool = False
    num_ref_idx_l0_default: int = 1
    num_ref_idx_l1_default: int = 1
    init_qp: int = 26
    constrained_intra_pred: bool = False
    transform_skip_enabled: bool = False
    scaling_list_data: Optional[dict] = None   # pps-level override (parse only)
    cu_qp_delta_enabled: bool = False
    diff_cu_qp_delta_depth: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    slice_chroma_qp_offsets_present: bool = False
    weighted_pred: bool = False
    weighted_bipred: bool = False
    transquant_bypass_enabled: bool = False
    tiles_enabled: bool = False
    entropy_coding_sync_enabled: bool = False
    loop_filter_across_slices: bool = True
    deblocking_filter_control_present: bool = False
    deblocking_filter_override_enabled: bool = False
    deblocking_filter_disabled: bool = False
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    lists_modification_present: bool = False
    log2_parallel_merge_level: int = 2


@dataclass
class SliceHeader:
    first_slice_in_pic: bool = True
    no_output_of_prior_pics: bool = False
    pps_id: int = 0
    segment_address: int = 0
    slice_type: int = SLICE_I
    pic_order_cnt_lsb: int = 0
    short_term_rps: Optional[ShortTermRPS] = None
    short_term_rps_idx: int = 0
    rps_in_sps: bool = False
    num_ref_idx_active_override: bool = False
    num_ref_idx_l0_active: int = 1
    num_ref_idx_l1_active: int = 1
    cabac_init_flag: bool = False
    max_num_merge_cand: int = 5
    qp: int = 26
    sao_luma: bool = False
    sao_chroma: bool = False
    temporal_mvp_enabled: bool = False
    collocated_from_l0: bool = True
    collocated_ref_idx: int = 0
    mvd_l1_zero: bool = False
    deblocking_filter_disabled: bool = False
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    loop_filter_across_slices: bool = True
    num_entry_points: int = 0
    entry_point_offsets: List[int] = field(default_factory=list)
    # explicit weighted prediction (pred_weight_table, 7.3.6.3):
    # per-L0-ref (w, off) luma and [(wcb, ocb), (wcr, ocr)] chroma; None
    # entries mean default (unweighted)
    luma_log2_weight_denom: int = 0
    chroma_log2_weight_denom: int = 0
    luma_weights_l0: Optional[List] = None    # [(w, off) or None, ...]
    chroma_weights_l0: Optional[List] = None  # [((w,o),(w,o)) or None, ...]


# ---------------------------------------------------------------------------
# profile_tier_level
# ---------------------------------------------------------------------------

def write_ptl(bw: BitWriter, ptl: ProfileTierLevel, max_sub_layers: int = 1) -> None:
    bw.write(0, 2)                       # general_profile_space
    bw.write_flag(ptl.tier_flag)
    bw.write(ptl.profile_idc, 5)
    compat = 0
    compat |= 1 << (31 - ptl.profile_idc)
    if ptl.profile_idc == 1:
        compat |= 1 << (31 - 2)          # Main streams also conform to Main10
    bw.write(compat, 32)
    bw.write_flag(ptl.progressive_source)
    bw.write_flag(ptl.interlaced_source)
    bw.write_flag(ptl.non_packed)
    bw.write_flag(ptl.frame_only)
    bw.write(0, 32)                      # general_reserved_zero_44bits
    bw.write(0, 12)
    bw.write(ptl.level_idc, 8)
    for _ in range(max_sub_layers - 1):
        bw.write_flag(0)                 # sub_layer_profile_present
        bw.write_flag(0)                 # sub_layer_level_present
    if max_sub_layers > 1:
        for _ in range(max_sub_layers - 1, 8):
            bw.write(0, 2)


def parse_ptl(br: BitReader, max_sub_layers: int = 1) -> ProfileTierLevel:
    ptl = ProfileTierLevel()
    br.read(2)
    ptl.tier_flag = br.read_flag()
    ptl.profile_idc = br.read(5)
    br.read(32)
    ptl.progressive_source = bool(br.read_flag())
    ptl.interlaced_source = bool(br.read_flag())
    ptl.non_packed = bool(br.read_flag())
    ptl.frame_only = bool(br.read_flag())
    br.read(32)
    br.read(12)
    ptl.level_idc = br.read(8)
    sub_profile = []
    sub_level = []
    for _ in range(max_sub_layers - 1):
        sub_profile.append(br.read_flag())
        sub_level.append(br.read_flag())
    if max_sub_layers > 1:
        for _ in range(max_sub_layers - 1, 8):
            br.read(2)
    for i in range(max_sub_layers - 1):
        if sub_profile[i]:
            br.read(32); br.read(32); br.read(24)  # 88 bits sub-layer profile
        if sub_level[i]:
            br.read(8)
    return ptl


# ---------------------------------------------------------------------------
# VPS
# ---------------------------------------------------------------------------

def write_vps(vps: VPS) -> bytes:
    bw = BitWriter()
    bw.write(0, 4)                        # vps_video_parameter_set_id
    bw.write(3, 2)                        # vps_reserved_three_2bits
    bw.write(0, 6)                        # vps_max_layers_minus1
    bw.write(vps.max_sub_layers - 1, 3)
    bw.write_flag(vps.max_sub_layers == 1)  # temporal_id_nesting
    bw.write(0xFFFF, 16)                  # reserved
    write_ptl(bw, vps.ptl, vps.max_sub_layers)
    bw.write_flag(1)                      # sub_layer_ordering_info_present
    for _ in range(vps.max_sub_layers):
        bw.write_ue(vps.max_dec_pic_buffering - 1)
        bw.write_ue(vps.num_reorder_pics)
        bw.write_ue(0)                    # max_latency_increase_plus1
    bw.write(0, 6)                        # vps_max_layer_id
    bw.write_ue(0)                        # vps_num_layer_sets_minus1
    bw.write_flag(0)                      # vps_timing_info_present
    bw.write_flag(0)                      # vps_extension
    bw.rbsp_trailing_bits()
    return bw.data()


def parse_vps(data: bytes) -> VPS:
    br = BitReader(data)
    vps = VPS()
    br.read(4); br.read(2); br.read(6)
    vps.max_sub_layers = br.read(3) + 1
    br.read_flag()
    br.read(16)
    vps.ptl = parse_ptl(br, vps.max_sub_layers)
    sub_layer_ordering = br.read_flag()
    n = vps.max_sub_layers if sub_layer_ordering else 1
    for _ in range(n):
        vps.max_dec_pic_buffering = br.read_ue() + 1
        vps.num_reorder_pics = br.read_ue()
        br.read_ue()
    # remainder ignored by our decoder
    return vps


# ---------------------------------------------------------------------------
# short-term RPS
# ---------------------------------------------------------------------------

def write_st_rps(bw: BitWriter, rps: ShortTermRPS, idx: int) -> None:
    if idx > 0:
        bw.write_flag(0)                  # inter_ref_pic_set_prediction_flag
    bw.write_ue(rps.num_negative)
    bw.write_ue(rps.num_positive)
    for i in range(rps.num_negative):
        prev = 0 if i == 0 else rps.delta_poc_s0[i - 1]
        bw.write_ue(-(rps.delta_poc_s0[i] - prev) - 1)
        bw.write_flag(rps.used_s0[i])
    for i in range(rps.num_positive):
        prev = 0 if i == 0 else rps.delta_poc_s1[i - 1]
        bw.write_ue(rps.delta_poc_s1[i] - prev - 1)
        bw.write_flag(rps.used_s1[i])


def parse_st_rps(br: BitReader, idx: int, prev_rps_list: List[ShortTermRPS]) -> ShortTermRPS:
    rps = ShortTermRPS()
    pred = br.read_flag() if idx > 0 else 0
    if pred:
        raise NotImplementedError("inter RPS prediction not supported")
    rps.num_negative = br.read_ue()
    rps.num_positive = br.read_ue()
    prev = 0
    for _ in range(rps.num_negative):
        prev = prev - (br.read_ue() + 1)
        rps.delta_poc_s0.append(prev)
        rps.used_s0.append(bool(br.read_flag()))
    prev = 0
    for _ in range(rps.num_positive):
        prev = prev + br.read_ue() + 1
        rps.delta_poc_s1.append(prev)
        rps.used_s1.append(bool(br.read_flag()))
    return rps


# ---------------------------------------------------------------------------
# Scaling lists (spec 7.3.4 scaling_list_data + 7.4.5 ScalingFactor
# derivation; x265 analog scalinglist.cpp — setDefaultScalingList /
# parseScalingList)
# ---------------------------------------------------------------------------

def _diag_scan_xy(n: int):
    """Up-right diagonal scan (spec 6.5.3): list of (x, y), len n*n."""
    order = []
    x = y = 0
    while len(order) < n * n:
        while y >= 0:
            if x < n and y < n:
                order.append((x, y))
            y -= 1
            x += 1
        y = x
        x = 0
    return order


_SL_COEF_NUM = {0: 16, 1: 64, 2: 64, 3: 64}


def default_scaling_vals(size_id: int, matrix_id: int):
    """Default ScalingList values in diag-scan order + dc (Tables 7-5/7-6:
    matrixId < 3 intra, >= 3 inter; sizeId 3 has matrixIds {0: intra,
    1: inter} luma only)."""
    import numpy as np
    from encbench.reference.tables import (SCALING_DEFAULT_8x8_INTRA,
                                      SCALING_DEFAULT_8x8_INTER)
    if size_id == 0:
        return np.full(16, 16, np.int32), 16
    is_intra = matrix_id < 3 if size_id < 3 else matrix_id == 0
    base = (SCALING_DEFAULT_8x8_INTRA if is_intra
            else SCALING_DEFAULT_8x8_INTER)
    vals = np.array([base[y, x] for x, y in _diag_scan_xy(8)], np.int32)
    return vals, 16


def write_scaling_list_data(bw, sld: Optional[dict]) -> None:
    """scaling_list_data() (7.3.4). sld None => every list signalled as
    'use default' (pred_mode 0, delta 0)."""
    import numpy as np
    for size_id in range(4):
        step = 3 if size_id == 3 else 1
        for matrix_id in range(0, 6, step):
            ent = (sld or {}).get((size_id, matrix_id))
            dv, ddc = default_scaling_vals(size_id, matrix_id)
            if ent is None or (np.array_equal(ent[0], dv)
                               and ent[1] == ddc):
                bw.write_flag(0)            # scaling_list_pred_mode_flag
                bw.write_ue(0)              # pred_matrix_id_delta: default
                continue
            vals, dc = ent
            bw.write_flag(1)
            coef_num = min(64, 1 << (4 + (size_id << 1)))
            next_coef = 8
            if size_id > 1:
                bw.write_se(int(dc) - 8)
                next_coef = int(dc)
            for i in range(coef_num):
                delta = (int(vals[i]) - next_coef + 256) % 256
                if delta > 127:
                    delta -= 256
                bw.write_se(delta)
                next_coef = (next_coef + delta + 256) % 256


def parse_scaling_list_data(br) -> dict:
    """Parse scaling_list_data(); returns {(sizeId, matrixId): (vals, dc)}
    with prediction (default / ref-matrix copy) resolved."""
    import numpy as np
    out = {}
    for size_id in range(4):
        step = 3 if size_id == 3 else 1
        for matrix_id in range(0, 6, step):
            if not br.read_flag():          # pred from default/ref matrix
                delta = br.read_ue()
                if delta == 0:
                    out[size_id, matrix_id] = default_scaling_vals(
                        size_id, matrix_id)
                else:
                    ref = matrix_id - delta * step
                    out[size_id, matrix_id] = out[size_id, ref]
                continue
            coef_num = min(64, 1 << (4 + (size_id << 1)))
            next_coef, dc = 8, 16
            if size_id > 1:
                dc = br.read_se() + 8
                next_coef = dc
            vals = np.empty(coef_num, np.int32)
            for i in range(coef_num):
                next_coef = (next_coef + br.read_se() + 256) % 256
                vals[i] = next_coef
            out[size_id, matrix_id] = (vals, dc)
    return out


def scaling_factor_matrix(sld: Optional[dict], n: int,
                          matrix_id: int):
    """Resolved m (ScalingFactor, 7.4.5 eq. 7-40..7-46) as an [n, n] int32
    array indexed [y][x] == ScalingFactor[x][y]. sld None => defaults."""
    import numpy as np
    size_id = n.bit_length() - 3            # 4->0, 8->1, 16->2, 32->3
    ent = (sld or {}).get((size_id, matrix_id))
    if ent is None:
        ent = default_scaling_vals(size_id, matrix_id)
    vals, dc = ent
    base_n = 4 if size_id == 0 else 8
    base = np.zeros((base_n, base_n), np.int32)
    for i, (x, y) in enumerate(_diag_scan_xy(base_n)):
        base[y, x] = vals[i]
    if size_id <= 1:
        return base
    r = n // 8
    m = np.repeat(np.repeat(base, r, 0), r, 1)
    m[0, 0] = dc
    return m


def sps_scaling_matrix(sps, n: int, is_intra: bool, c_idx: int):
    """The m matrix the decoder/dequant must use for an n x n TB, or None
    when scaling lists are off (flat 16)."""
    if not sps.scaling_list_enabled:
        return None
    size_id = n.bit_length() - 3
    if size_id == 3:
        matrix_id = 0 if is_intra else 1
    else:
        matrix_id = (0 if is_intra else 3) + c_idx
    return scaling_factor_matrix(sps.scaling_list_data, n, matrix_id)


# ---------------------------------------------------------------------------
# SPS
# ---------------------------------------------------------------------------

def write_sps(sps: SPS) -> bytes:
    bw = BitWriter()
    bw.write(sps.vps_id, 4)
    bw.write(0, 3)                        # sps_max_sub_layers_minus1
    bw.write_flag(1)                      # sps_temporal_id_nesting
    write_ptl(bw, sps.ptl, 1)
    bw.write_ue(sps.sps_id)
    bw.write_ue(sps.chroma_format_idc)
    bw.write_ue(sps.width)
    bw.write_ue(sps.height)
    cw = sps.conf_win
    if any(cw):
        bw.write_flag(1)
        for v in cw:
            bw.write_ue(v)
    else:
        bw.write_flag(0)
    bw.write_ue(sps.bit_depth - 8)
    bw.write_ue(sps.bit_depth - 8)
    bw.write_ue(sps.log2_max_poc_lsb - 4)
    bw.write_flag(1)                      # sub_layer_ordering_info_present
    bw.write_ue(sps.max_dec_pic_buffering - 1)
    bw.write_ue(sps.num_reorder_pics)
    bw.write_ue(0)                        # max_latency_increase_plus1
    bw.write_ue(sps.log2_min_cb - 3)
    bw.write_ue(sps.log2_diff_max_min_cb)
    bw.write_ue(sps.log2_min_tb - 2)
    bw.write_ue(sps.log2_diff_max_min_tb)
    bw.write_ue(sps.max_transform_hierarchy_depth_inter)
    bw.write_ue(sps.max_transform_hierarchy_depth_intra)
    bw.write_flag(sps.scaling_list_enabled)
    if sps.scaling_list_enabled:
        bw.write_flag(sps.scaling_list_data is not None)
        if sps.scaling_list_data is not None:
            write_scaling_list_data(bw, sps.scaling_list_data)
    bw.write_flag(sps.amp_enabled)
    bw.write_flag(sps.sao_enabled)
    bw.write_flag(sps.pcm_enabled)
    bw.write_ue(len(sps.short_term_rps))
    for i, rps in enumerate(sps.short_term_rps):
        write_st_rps(bw, rps, i)
    bw.write_flag(sps.long_term_ref_pics_present)
    bw.write_flag(sps.temporal_mvp_enabled)
    bw.write_flag(sps.strong_intra_smoothing)
    if sps.vui_present and sps.fps_num:
        bw.write_flag(1)
        _write_vui(bw, sps)
    else:
        bw.write_flag(0)
    bw.write_flag(0)                      # sps_extension_present
    bw.rbsp_trailing_bits()
    return bw.data()


def _write_vui(bw: BitWriter, sps: SPS) -> None:
    if sps.sar_idc:
        bw.write_flag(1)                  # aspect_ratio_info_present
        bw.write(sps.sar_idc, 8)
        if sps.sar_idc == 255:            # Extended_SAR
            bw.write(sps.sar_width, 16)
            bw.write(sps.sar_height, 16)
    else:
        bw.write_flag(0)                  # aspect_ratio_info_present
    bw.write_flag(0)                      # overscan_info_present
    colour_desc = (sps.colour_primaries or sps.transfer_characteristics
                   or sps.matrix_coeffs >= 0)
    if colour_desc or sps.video_full_range or sps.video_format != 5:
        bw.write_flag(1)                  # video_signal_type_present
        bw.write(sps.video_format, 3)
        bw.write_flag(sps.video_full_range)
        if colour_desc:
            bw.write_flag(1)              # colour_description_present
            bw.write(sps.colour_primaries or 2, 8)
            bw.write(sps.transfer_characteristics or 2, 8)
            bw.write(sps.matrix_coeffs if sps.matrix_coeffs >= 0 else 2, 8)
        else:
            bw.write_flag(0)
    else:
        bw.write_flag(0)                  # video_signal_type_present
    if sps.chroma_loc >= 0:
        bw.write_flag(1)                  # chroma_loc_info_present
        bw.write_ue(sps.chroma_loc)       # top field
        bw.write_ue(sps.chroma_loc)       # bottom field
    else:
        bw.write_flag(0)                  # chroma_loc_info_present
    bw.write_flag(0)                      # neutral_chroma_indication
    bw.write_flag(0)                      # field_seq
    bw.write_flag(sps.frame_field_info)  # frame_field_info_present
    bw.write_flag(0)                      # default_display_window
    bw.write_flag(1)                      # vui_timing_info_present
    bw.write(sps.fps_den, 32)             # vui_num_units_in_tick
    bw.write(sps.fps_num, 32)             # vui_time_scale
    bw.write_flag(0)                      # poc_proportional_to_timing
    if sps.hrd_bitrate > 0:
        bw.write_flag(1)                  # vui_hrd_parameters_present
        _write_hrd(bw, sps)
    else:
        bw.write_flag(0)                  # vui_hrd_parameters_present
    bw.write_flag(0)                      # bitstream_restriction


def _write_hrd(bw: BitWriter, sps: SPS) -> None:
    """hrd_parameters (E.2.2), NAL HRD, one CPB, fixed pic rate —
    the shape x265 signals for --hrd (hrd.cpp)."""
    BR_SHIFT, CPB_SHIFT = 6, 4
    br_scale, cpb_scale = 4, 4        # units: 2^(6+4)=1024 b/s, 2^(4+4)=256 b
    br_val = max(1, sps.hrd_bitrate >> (BR_SHIFT + br_scale))
    cpb_val = max(1, sps.hrd_cpb_size >> (CPB_SHIFT + cpb_scale))
    bw.write_flag(1)                  # nal_hrd_parameters_present
    bw.write_flag(0)                  # vcl_hrd_parameters_present
    bw.write_flag(0)                  # sub_pic_hrd_params_present
    bw.write(br_scale, 4)             # bit_rate_scale
    bw.write(cpb_scale, 4)            # cpb_size_scale
    bw.write(23, 5)                   # initial_cpb_removal_delay_length-1
    bw.write(23, 5)                   # au_cpb_removal_delay_length-1
    bw.write(23, 5)                   # dpb_output_delay_length-1
    # sub-layer 0
    bw.write_flag(1)                  # fixed_pic_rate_general_flag
    bw.write_ue(0)                    # elemental_duration_in_tc_minus1
    bw.write_ue(0)                    # cpb_cnt_minus1
    bw.write_ue(br_val - 1)           # bit_rate_value_minus1
    bw.write_ue(cpb_val - 1)          # cpb_size_value_minus1
    bw.write_flag(0)                  # cbr_flag


def parse_sps(data: bytes) -> SPS:
    br = BitReader(data)
    sps = SPS()
    sps.vps_id = br.read(4)
    max_sub_layers = br.read(3) + 1
    br.read_flag()
    sps.ptl = parse_ptl(br, max_sub_layers)
    sps.sps_id = br.read_ue()
    sps.chroma_format_idc = br.read_ue()
    if sps.chroma_format_idc == 3:
        br.read_flag()
    sps.width = br.read_ue()
    sps.height = br.read_ue()
    if br.read_flag():
        sps.conf_win = (br.read_ue(), br.read_ue(), br.read_ue(), br.read_ue())
    sps.bit_depth = br.read_ue() + 8
    br.read_ue()                          # chroma bit depth
    sps.log2_max_poc_lsb = br.read_ue() + 4
    sub_layer_ordering = br.read_flag()
    for _ in range(max_sub_layers if sub_layer_ordering else 1):
        sps.max_dec_pic_buffering = br.read_ue() + 1
        sps.num_reorder_pics = br.read_ue()
        br.read_ue()
    sps.log2_min_cb = br.read_ue() + 3
    sps.log2_diff_max_min_cb = br.read_ue()
    sps.log2_min_tb = br.read_ue() + 2
    sps.log2_diff_max_min_tb = br.read_ue()
    sps.max_transform_hierarchy_depth_inter = br.read_ue()
    sps.max_transform_hierarchy_depth_intra = br.read_ue()
    sps.scaling_list_enabled = bool(br.read_flag())
    if sps.scaling_list_enabled:
        if br.read_flag():
            sps.scaling_list_data = parse_scaling_list_data(br)
    sps.amp_enabled = bool(br.read_flag())
    sps.sao_enabled = bool(br.read_flag())
    sps.pcm_enabled = bool(br.read_flag())
    if sps.pcm_enabled:
        raise NotImplementedError("PCM")
    n_rps = br.read_ue()
    for i in range(n_rps):
        sps.short_term_rps.append(parse_st_rps(br, i, sps.short_term_rps))
    sps.long_term_ref_pics_present = bool(br.read_flag())
    if sps.long_term_ref_pics_present:
        raise NotImplementedError("long-term refs")
    sps.temporal_mvp_enabled = bool(br.read_flag())
    sps.strong_intra_smoothing = bool(br.read_flag())
    sps.vui_present = bool(br.read_flag())
    if sps.vui_present:
        _parse_vui(br, sps)
    return sps


def _parse_vui(br: BitReader, sps: SPS) -> None:
    if br.read_flag():                    # aspect_ratio_info
        idc = br.read(8)
        if idc == 255:
            br.read(16); br.read(16)
    if br.read_flag():                    # overscan
        br.read_flag()
    if br.read_flag():                    # video_signal_type
        br.read(3)
        sps.video_full_range = bool(br.read_flag())
        if br.read_flag():
            sps.colour_primaries = br.read(8)
            sps.transfer_characteristics = br.read(8)
            sps.matrix_coeffs = br.read(8)
    if br.read_flag():                    # chroma_loc
        sps.chroma_loc = br.read_ue(); br.read_ue()
    br.read_flag(); br.read_flag()        # neutral chroma, field_seq
    sps.frame_field_info = bool(br.read_flag())
    if br.read_flag():                    # default display window
        br.read_ue(); br.read_ue(); br.read_ue(); br.read_ue()
    if br.read_flag():                    # timing info
        sps.fps_den = br.read(32)
        sps.fps_num = br.read(32)
        if br.read_flag():
            br.read_ue()
        if br.read_flag():
            _skip_hrd(br)
    if br.read_flag():                    # bitstream restriction
        br.read_flag(); br.read_flag(); br.read_flag()
        br.read_ue(); br.read_ue(); br.read_ue(); br.read_ue(); br.read_ue()


def _skip_hrd(br: BitReader, common_present: bool = True, max_sub_layers: int = 1) -> None:
    nal_hrd = vcl_hrd = 0
    sub_pic = 0
    if common_present:
        nal_hrd = br.read_flag()
        vcl_hrd = br.read_flag()
        if nal_hrd or vcl_hrd:
            sub_pic = br.read_flag()
            if sub_pic:
                br.read(8); br.read(5); br.read_flag(); br.read(5)
            br.read(4); br.read(4)
            if sub_pic:
                br.read(4)
            br.read(5); br.read(5); br.read(5)
    for _ in range(max_sub_layers):
        fixed_rate = br.read_flag()
        if not fixed_rate:
            fixed_rate = br.read_flag()
        low_delay = 0
        if fixed_rate:
            br.read_ue()
        else:
            low_delay = br.read_flag()
        cpb_cnt = 1
        if not low_delay:
            cpb_cnt = br.read_ue() + 1
        for hrd in (nal_hrd, vcl_hrd):
            if hrd:
                for _ in range(cpb_cnt):
                    br.read_ue(); br.read_ue()
                    if sub_pic:
                        br.read_ue(); br.read_ue()
                    br.read_flag()


# ---------------------------------------------------------------------------
# PPS
# ---------------------------------------------------------------------------

def write_pps(pps: PPS) -> bytes:
    bw = BitWriter()
    bw.write_ue(pps.pps_id)
    bw.write_ue(pps.sps_id)
    bw.write_flag(0)                      # dependent_slice_segments_enabled
    bw.write_flag(0)                      # output_flag_present
    bw.write(0, 3)                        # num_extra_slice_header_bits
    bw.write_flag(pps.sign_data_hiding)
    bw.write_flag(pps.cabac_init_present)
    bw.write_ue(pps.num_ref_idx_l0_default - 1)
    bw.write_ue(pps.num_ref_idx_l1_default - 1)
    bw.write_se(pps.init_qp - 26)
    bw.write_flag(pps.constrained_intra_pred)
    bw.write_flag(pps.transform_skip_enabled)
    bw.write_flag(pps.cu_qp_delta_enabled)
    if pps.cu_qp_delta_enabled:
        bw.write_ue(pps.diff_cu_qp_delta_depth)
    bw.write_se(pps.cb_qp_offset)
    bw.write_se(pps.cr_qp_offset)
    bw.write_flag(pps.slice_chroma_qp_offsets_present)
    bw.write_flag(pps.weighted_pred)
    bw.write_flag(pps.weighted_bipred)
    bw.write_flag(pps.transquant_bypass_enabled)
    bw.write_flag(pps.tiles_enabled)
    bw.write_flag(pps.entropy_coding_sync_enabled)
    bw.write_flag(pps.loop_filter_across_slices)
    bw.write_flag(pps.deblocking_filter_control_present)
    if pps.deblocking_filter_control_present:
        bw.write_flag(pps.deblocking_filter_override_enabled)
        bw.write_flag(pps.deblocking_filter_disabled)
        if not pps.deblocking_filter_disabled:
            bw.write_se(pps.beta_offset_div2)
            bw.write_se(pps.tc_offset_div2)
    bw.write_flag(0)                      # pps_scaling_list_data_present
    bw.write_flag(pps.lists_modification_present)
    bw.write_ue(pps.log2_parallel_merge_level - 2)
    bw.write_flag(0)                      # slice_segment_header_extension
    bw.write_flag(0)                      # pps_extension
    bw.rbsp_trailing_bits()
    return bw.data()


def parse_pps(data: bytes) -> PPS:
    br = BitReader(data)
    pps = PPS()
    pps.pps_id = br.read_ue()
    pps.sps_id = br.read_ue()
    if br.read_flag():
        raise NotImplementedError("dependent slice segments")
    output_flag_present = br.read_flag()
    extra_bits = br.read(3)
    if output_flag_present or extra_bits:
        raise NotImplementedError("pps options")
    pps.sign_data_hiding = bool(br.read_flag())
    pps.cabac_init_present = bool(br.read_flag())
    pps.num_ref_idx_l0_default = br.read_ue() + 1
    pps.num_ref_idx_l1_default = br.read_ue() + 1
    pps.init_qp = br.read_se() + 26
    pps.constrained_intra_pred = bool(br.read_flag())
    pps.transform_skip_enabled = bool(br.read_flag())
    pps.cu_qp_delta_enabled = bool(br.read_flag())
    if pps.cu_qp_delta_enabled:
        pps.diff_cu_qp_delta_depth = br.read_ue()
    pps.cb_qp_offset = br.read_se()
    pps.cr_qp_offset = br.read_se()
    pps.slice_chroma_qp_offsets_present = bool(br.read_flag())
    pps.weighted_pred = bool(br.read_flag())
    pps.weighted_bipred = bool(br.read_flag())
    pps.transquant_bypass_enabled = bool(br.read_flag())
    pps.tiles_enabled = bool(br.read_flag())
    pps.entropy_coding_sync_enabled = bool(br.read_flag())
    if pps.tiles_enabled:
        raise NotImplementedError("tiles parsing")
    pps.loop_filter_across_slices = bool(br.read_flag())
    pps.deblocking_filter_control_present = bool(br.read_flag())
    if pps.deblocking_filter_control_present:
        pps.deblocking_filter_override_enabled = bool(br.read_flag())
        pps.deblocking_filter_disabled = bool(br.read_flag())
        if not pps.deblocking_filter_disabled:
            pps.beta_offset_div2 = br.read_se()
            pps.tc_offset_div2 = br.read_se()
    if br.read_flag():                    # pps_scaling_list_data_present
        pps.scaling_list_data = parse_scaling_list_data(br)
    pps.lists_modification_present = bool(br.read_flag())
    pps.log2_parallel_merge_level = br.read_ue() + 2
    return pps


# ---------------------------------------------------------------------------
# Slice segment header
# ---------------------------------------------------------------------------

def is_irap(nal_type: int) -> bool:
    return NAL_BLA_W_LP <= nal_type <= 23


def is_idr(nal_type: int) -> bool:
    return nal_type in (NAL_IDR_W_RADL, NAL_IDR_N_LP)


def _write_pred_weight_table(bw: BitWriter, sh: SliceHeader) -> None:
    """pred_weight_table (7.3.6.3), L0 only (P slices)."""
    n = sh.num_ref_idx_l0_active
    lw = sh.luma_weights_l0 or [None] * n
    cw = sh.chroma_weights_l0 or [None] * n
    bw.write_ue(sh.luma_log2_weight_denom)
    bw.write_se(sh.chroma_log2_weight_denom - sh.luma_log2_weight_denom)
    for i in range(n):
        bw.write_flag(lw[i] is not None)
    for i in range(n):
        bw.write_flag(cw[i] is not None)
    for i in range(n):
        if lw[i] is not None:
            w, off = lw[i]
            bw.write_se(w - (1 << sh.luma_log2_weight_denom))
            bw.write_se(off)
        if cw[i] is not None:
            for (w, off) in cw[i]:
                bw.write_se(w - (1 << sh.chroma_log2_weight_denom))
                # delta_chroma_offset (7.4.7.3): off coded as delta vs the
                # weight-implied midpoint shift
                pred = 128 - ((128 * w) >> sh.chroma_log2_weight_denom)
                bw.write_se(off - pred)


def _parse_pred_weight_table(br: BitReader, sh: SliceHeader) -> None:
    n = sh.num_ref_idx_l0_active
    sh.luma_log2_weight_denom = br.read_ue()
    sh.chroma_log2_weight_denom = (sh.luma_log2_weight_denom + br.read_se())
    lflags = [br.read_flag() for _ in range(n)]
    cflags = [br.read_flag() for _ in range(n)]
    lw: List = [None] * n
    cw: List = [None] * n
    for i in range(n):
        if lflags[i]:
            dw = br.read_se()
            off = br.read_se()
            lw[i] = ((1 << sh.luma_log2_weight_denom) + dw, off)
        if cflags[i]:
            pair = []
            for _ in range(2):
                dw = br.read_se()
                doff = br.read_se()
                w = (1 << sh.chroma_log2_weight_denom) + dw
                pred = 128 - ((128 * w) >> sh.chroma_log2_weight_denom)
                pair.append((w, doff + pred))
            cw[i] = tuple(pair)
    sh.luma_weights_l0 = lw
    sh.chroma_weights_l0 = cw


def write_slice_header(sh: SliceHeader, sps: SPS, pps: PPS, nal_type: int) -> BitWriter:
    """Write the slice header; returns the (unaligned-complete) BitWriter so
    the caller can append entry points + byte alignment + slice data."""
    bw = BitWriter()
    bw.write_flag(sh.first_slice_in_pic)
    if is_irap(nal_type):
        bw.write_flag(sh.no_output_of_prior_pics)
    bw.write_ue(sh.pps_id)
    if not sh.first_slice_in_pic:
        n_ctbs = sps.pic_width_in_ctbs * sps.pic_height_in_ctbs
        addr_bits = max(1, (n_ctbs - 1).bit_length())
        bw.write(sh.segment_address, addr_bits)
    bw.write_ue(sh.slice_type)
    if not is_idr(nal_type):
        bw.write(sh.pic_order_cnt_lsb, sps.log2_max_poc_lsb)
        if sh.rps_in_sps:
            if len(sps.short_term_rps) > 1:
                nbits = (len(sps.short_term_rps) - 1).bit_length()
                bw.write_flag(1)
                bw.write(sh.short_term_rps_idx, nbits)
            else:
                bw.write_flag(1)
        else:
            bw.write_flag(0)
            write_st_rps(bw, sh.short_term_rps, len(sps.short_term_rps))
        if sps.temporal_mvp_enabled:
            bw.write_flag(sh.temporal_mvp_enabled)
    if sps.sao_enabled:
        bw.write_flag(sh.sao_luma)
        bw.write_flag(sh.sao_chroma)
    if sh.slice_type != SLICE_I:
        nro = (sh.num_ref_idx_l0_active != pps.num_ref_idx_l0_default or
               (sh.slice_type == SLICE_B and
                sh.num_ref_idx_l1_active != pps.num_ref_idx_l1_default))
        bw.write_flag(nro)
        if nro:
            bw.write_ue(sh.num_ref_idx_l0_active - 1)
            if sh.slice_type == SLICE_B:
                bw.write_ue(sh.num_ref_idx_l1_active - 1)
        if pps.lists_modification_present:
            raise NotImplementedError
        if sh.slice_type == SLICE_B:
            bw.write_flag(sh.mvd_l1_zero)
        if pps.cabac_init_present:
            bw.write_flag(sh.cabac_init_flag)
        if sh.temporal_mvp_enabled:
            if sh.slice_type == SLICE_B:
                bw.write_flag(sh.collocated_from_l0)
            nrefs = (sh.num_ref_idx_l0_active if sh.collocated_from_l0
                     else sh.num_ref_idx_l1_active)
            if nrefs > 1:
                bw.write_ue(sh.collocated_ref_idx)
        if (pps.weighted_pred and sh.slice_type == SLICE_P) or (
                pps.weighted_bipred and sh.slice_type == SLICE_B):
            _write_pred_weight_table(bw, sh)
        bw.write_ue(5 - sh.max_num_merge_cand)
    bw.write_se(sh.qp - 26 - (pps.init_qp - 26))
    if pps.slice_chroma_qp_offsets_present:
        bw.write_se(0); bw.write_se(0)
    if pps.deblocking_filter_control_present and pps.deblocking_filter_override_enabled:
        bw.write_flag(0)                  # no override
    deblock_on = not (pps.deblocking_filter_disabled or sh.deblocking_filter_disabled)
    if pps.loop_filter_across_slices and (sh.sao_luma or sh.sao_chroma or deblock_on):
        bw.write_flag(sh.loop_filter_across_slices)
    if pps.tiles_enabled or pps.entropy_coding_sync_enabled:
        bw.write_ue(len(sh.entry_point_offsets))
        if sh.entry_point_offsets:
            maxoff = max(sh.entry_point_offsets)
            nbits = max(1, maxoff.bit_length())
            bw.write_ue(nbits - 1)
            for off in sh.entry_point_offsets:
                bw.write(off - 1, nbits)
    bw.byte_align_with_ones()
    return bw


def parse_slice_header(data: bytes, nal_type: int, sps: SPS, pps: PPS) -> tuple:
    """Parse a slice segment header; returns (SliceHeader, byte_offset) where
    byte_offset is the start of slice data within the RBSP."""
    br = BitReader(data)
    sh = SliceHeader()
    sh.first_slice_in_pic = bool(br.read_flag())
    if is_irap(nal_type):
        sh.no_output_of_prior_pics = bool(br.read_flag())
    sh.pps_id = br.read_ue()
    if not sh.first_slice_in_pic:
        n_ctbs = sps.pic_width_in_ctbs * sps.pic_height_in_ctbs
        addr_bits = max(1, (n_ctbs - 1).bit_length())
        sh.segment_address = br.read(addr_bits)
    sh.slice_type = br.read_ue()
    if not is_idr(nal_type):
        sh.pic_order_cnt_lsb = br.read(sps.log2_max_poc_lsb)
        if br.read_flag():                # short_term_ref_pic_set_sps_flag
            sh.rps_in_sps = True
            nbits = max(0, (len(sps.short_term_rps) - 1).bit_length()) \
                if len(sps.short_term_rps) > 1 else 0
            sh.short_term_rps_idx = br.read(nbits) if nbits else 0
            sh.short_term_rps = sps.short_term_rps[sh.short_term_rps_idx]
        else:
            sh.short_term_rps = parse_st_rps(br, len(sps.short_term_rps),
                                             sps.short_term_rps)
        if sps.temporal_mvp_enabled:
            sh.temporal_mvp_enabled = bool(br.read_flag())
    if sps.sao_enabled:
        sh.sao_luma = bool(br.read_flag())
        sh.sao_chroma = bool(br.read_flag())
    sh.num_ref_idx_l0_active = pps.num_ref_idx_l0_default
    sh.num_ref_idx_l1_active = pps.num_ref_idx_l1_default
    if sh.slice_type != SLICE_I:
        if br.read_flag():
            sh.num_ref_idx_l0_active = br.read_ue() + 1
            if sh.slice_type == SLICE_B:
                sh.num_ref_idx_l1_active = br.read_ue() + 1
        if pps.lists_modification_present:
            raise NotImplementedError
        if sh.slice_type == SLICE_B:
            sh.mvd_l1_zero = bool(br.read_flag())
        if pps.cabac_init_present:
            sh.cabac_init_flag = bool(br.read_flag())
        if sh.temporal_mvp_enabled:
            if sh.slice_type == SLICE_B:
                sh.collocated_from_l0 = bool(br.read_flag())
            nrefs = (sh.num_ref_idx_l0_active if sh.collocated_from_l0
                     else sh.num_ref_idx_l1_active)
            if nrefs > 1:
                sh.collocated_ref_idx = br.read_ue()
        if (pps.weighted_pred and sh.slice_type == SLICE_P) or (
                pps.weighted_bipred and sh.slice_type == SLICE_B):
            _parse_pred_weight_table(br, sh)
        sh.max_num_merge_cand = 5 - br.read_ue()
    sh.qp = 26 + pps.init_qp - 26 + br.read_se()
    if pps.slice_chroma_qp_offsets_present:
        br.read_se(); br.read_se()
    deblock_override = False
    if pps.deblocking_filter_control_present:
        if pps.deblocking_filter_override_enabled:
            deblock_override = bool(br.read_flag())
        if deblock_override:
            sh.deblocking_filter_disabled = bool(br.read_flag())
            if not sh.deblocking_filter_disabled:
                sh.beta_offset_div2 = br.read_se()
                sh.tc_offset_div2 = br.read_se()
        else:
            sh.deblocking_filter_disabled = pps.deblocking_filter_disabled
            sh.beta_offset_div2 = pps.beta_offset_div2
            sh.tc_offset_div2 = pps.tc_offset_div2
    deblock_on = not sh.deblocking_filter_disabled
    if pps.loop_filter_across_slices and (sh.sao_luma or sh.sao_chroma or deblock_on):
        sh.loop_filter_across_slices = bool(br.read_flag())
    if pps.tiles_enabled or pps.entropy_coding_sync_enabled:
        n = br.read_ue()
        if n:
            nbits = br.read_ue() + 1
            sh.entry_point_offsets = [br.read(nbits) + 1 for _ in range(n)]
    # byte_alignment(): alignment_bit_equal_to_one + zeros (spec 7.3.2.10);
    # must consume the '1' first — the header may already be byte-aligned,
    # in which case a full alignment byte follows.
    one = br.read_flag()
    if one != 1:
        raise ValueError("slice header alignment bit missing")
    br.byte_align()
    return sh, br.bit_position // 8
