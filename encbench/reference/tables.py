"""HEVC spec-mandated constant tables.

Everything here is an interoperability constant fixed by ITU-T H.265 /
ISO 23008-2 (CABAC tables 9-46/9-47, context init tables 9-5..9-32, scan
orders 6.5.3, intra angle tables 8.4.4.2.6, chroma QP table 8-10). The
reference encoder necessarily carries the same values
(source/common/contexts.h, constants.cpp, entropy.cpp:44-230); layout and
generation code here are original.

Context initialization types follow the spec: initType 0 = I slice,
1 = P slice, 2 = B slice (with cabac_init_flag swapping 1/2).
"""
from __future__ import annotations

import math
import numpy as np

# ---------------------------------------------------------------------------
# CABAC arithmetic-coder tables (spec 9.3.4.3, Tables 9-46 / 9-47)
# ---------------------------------------------------------------------------

# rangeTabLps[pStateIdx][qRangeIdx] (Table 9-46)
LPS_TABLE = np.array([
    [128, 176, 208, 240], [128, 167, 197, 227], [128, 158, 187, 216],
    [123, 150, 178, 205], [116, 142, 169, 195], [111, 135, 160, 185],
    [105, 128, 152, 175], [100, 122, 144, 166], [95, 116, 137, 158],
    [90, 110, 130, 150], [85, 104, 123, 142], [81, 99, 117, 135],
    [77, 94, 111, 128], [73, 89, 105, 122], [69, 85, 100, 116],
    [66, 80, 95, 110], [62, 76, 90, 104], [59, 72, 86, 99],
    [56, 69, 81, 94], [53, 65, 77, 89], [51, 62, 73, 85],
    [48, 59, 69, 80], [46, 56, 66, 76], [43, 53, 63, 72],
    [41, 50, 59, 69], [39, 48, 56, 65], [37, 45, 54, 62],
    [35, 43, 51, 59], [33, 41, 48, 56], [32, 39, 46, 53],
    [30, 37, 43, 50], [29, 35, 41, 48], [27, 33, 39, 45],
    [26, 31, 37, 43], [24, 30, 35, 41], [23, 28, 33, 39],
    [22, 27, 32, 37], [21, 26, 30, 35], [20, 24, 29, 33],
    [19, 23, 27, 31], [18, 22, 26, 30], [17, 21, 25, 28],
    [16, 20, 23, 27], [15, 19, 22, 25], [14, 18, 21, 24],
    [14, 17, 20, 23], [13, 16, 19, 22], [12, 15, 18, 21],
    [12, 14, 17, 20], [11, 14, 16, 19], [11, 13, 15, 18],
    [10, 12, 15, 17], [10, 12, 14, 16], [9, 11, 13, 15],
    [9, 11, 12, 14], [8, 10, 12, 14], [8, 9, 11, 13],
    [7, 9, 11, 12], [7, 9, 10, 12], [7, 8, 10, 11],
    [6, 8, 9, 11], [6, 7, 9, 10], [6, 7, 8, 9],
    [2, 2, 2, 2],
], dtype=np.uint16)

# transIdxLps (Table 9-47); transIdxMps = min(pState+1, 62), 63 stays 63
TRANS_IDX_LPS = np.array([
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
    13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
    24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
    33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63,
], dtype=np.uint8)

# Renormalization shift amounts indexed by LPS >> 3 (HM-style renorm).
RENORM_TABLE = np.array(
    [6, 5, 4, 4, 3, 3, 3, 3] + [2] * 8 + [1] * 16, dtype=np.uint8)

# Packed state = (pStateIdx << 1) | valMps. Next-state LUTs (128 entries).
_next_mps = np.empty(128, dtype=np.uint8)
_next_lps = np.empty(128, dtype=np.uint8)
for _s in range(128):
    _p, _m = _s >> 1, _s & 1
    _mps_next = 63 if _p == 63 else min(_p + 1, 62)
    _next_mps[_s] = (_mps_next << 1) | _m
    _next_lps[_s] = (int(TRANS_IDX_LPS[_p]) << 1) | (_m if _p else 1 - _m)
NEXT_STATE_MPS = _next_mps
NEXT_STATE_LPS = _next_lps

# Fractional-bit cost of coding a bin in a given packed state (Q15).
# ENTROPY_BITS[state ^ bin] = -log2(P(bin)) * 32768. Derived from the CABAC
# probability model p_k = 0.5 * alpha^k with alpha = (0.01875/0.5)^(1/63)
# (this is the defining model of Table 9-46; used for RD estimation only,
# never for conformance). x265's analogous table: g_entropyBits.
_alpha = (0.01875 / 0.5) ** (1.0 / 63.0)
_eb = np.empty(128, dtype=np.uint32)
for _p in range(64):
    _plps = 0.5 * (_alpha ** _p)
    _lps_bits = int(round(-math.log2(_plps) * 32768))
    _mps_bits = int(round(-math.log2(1.0 - _plps) * 32768))
    # state ^ bin: (p<<1|mps) ^ bin == coding `bin` == mps → MPS cost
    _eb[(_p << 1) | 0] = _mps_bits   # state mps=0, bin 0 → ^= 0 stays even
    _eb[(_p << 1) | 1] = _lps_bits
ENTROPY_BITS = _eb  # index with state ^ bin

# ---------------------------------------------------------------------------
# Context model layout (original layout; counts fixed by spec 9.3.2.2)
# ---------------------------------------------------------------------------

_CTX_LAYOUT = [
    ("sao_merge", 1),
    ("sao_type", 1),
    ("split_cu", 3),
    ("cu_transquant_bypass", 1),
    ("cu_skip", 3),
    ("pred_mode", 1),
    ("part_mode", 4),
    ("prev_intra_luma_pred", 1),
    ("intra_chroma_pred", 1),
    ("rqt_root_cbf", 1),
    ("merge_flag", 1),
    ("merge_idx", 1),
    ("inter_pred_idc", 5),
    ("ref_idx", 2),
    ("mvd", 2),
    ("mvp_flag", 1),
    ("split_transform", 3),
    ("cbf_luma", 2),
    ("cbf_chroma", 5),
    ("cu_qp_delta", 2),
    ("transform_skip_luma", 1),
    ("transform_skip_chroma", 1),
    ("last_x_luma", 15),
    ("last_x_chroma", 3),
    ("last_y_luma", 15),
    ("last_y_chroma", 3),
    ("csbf_luma", 2),
    ("csbf_chroma", 2),
    ("sig_luma", 27),
    ("sig_chroma", 15),
    ("gt1_luma", 16),
    ("gt1_chroma", 8),
    ("gt2_luma", 4),
    ("gt2_chroma", 2),
]

CTX_OFF = {}
CTX_CNT = {}
_off = 0
for _name, _cnt in _CTX_LAYOUT:
    CTX_OFF[_name] = _off
    CTX_CNT[_name] = _cnt
    _off += _cnt
NUM_CONTEXTS = _off

CNU = 154  # context-not-used init value

# Init values in spec order [initType 0 (I), 1 (P), 2 (B)] per context name.
# Values are the HEVC spec Tables 9-5..9-32 constants.
_INIT_VALUES = {
    "sao_merge": [[153], [153], [153]],
    "sao_type": [[200], [185], [160]],
    "split_cu": [[139, 141, 157], [107, 139, 126], [107, 139, 126]],
    "cu_transquant_bypass": [[154], [154], [154]],
    "cu_skip": [[CNU] * 3, [197, 185, 201], [197, 185, 201]],
    "pred_mode": [[CNU], [149], [134]],
    "part_mode": [[184, CNU, CNU, CNU], [154, 139, 154, 154], [154, 139, 154, 154]],
    "prev_intra_luma_pred": [[184], [154], [183]],
    "intra_chroma_pred": [[63], [152], [152]],
    "rqt_root_cbf": [[CNU], [79], [79]],
    "merge_flag": [[CNU], [110], [154]],
    "merge_idx": [[CNU], [122], [137]],
    "inter_pred_idc": [[CNU] * 5, [95, 79, 63, 31, 31], [95, 79, 63, 31, 31]],
    "ref_idx": [[CNU, CNU], [153, 153], [153, 153]],
    "mvd": [[CNU, CNU], [140, 198], [169, 198]],
    "mvp_flag": [[CNU], [168], [168]],
    "split_transform": [[153, 138, 138], [124, 138, 94], [224, 167, 122]],
    "cbf_luma": [[111, 141], [153, 111], [153, 111]],
    "cbf_chroma": [[94, 138, 182, 154, 154], [149, 107, 167, 154, 154],
                   [149, 92, 167, 154, 154]],
    "cu_qp_delta": [[154, 154], [154, 154], [154, 154]],
    "transform_skip_luma": [[139], [139], [139]],
    "transform_skip_chroma": [[139], [139], [139]],
    "last_x_luma": [
        [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111, 79],
        [125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94],
        [125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79],
    ],
    "last_x_chroma": [[108, 123, 63], [108, 123, 108], [108, 123, 93]],
    "last_y_luma": None,   # same as last_x_luma (spec uses one table for both)
    "last_y_chroma": None,
    "csbf_luma": [[91, 171], [121, 140], [121, 140]],
    "csbf_chroma": [[134, 141], [61, 154], [61, 154]],
    "sig_luma": [
        [111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179, 153,
         125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153, 125],
        [155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136, 153,
         154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154],
        [170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136, 153,
         154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154],
    ],
    "sig_chroma": [
        [140, 139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111, 136, 139, 111],
        [170, 153, 123, 123, 107, 121, 107, 121, 167, 151, 183, 140, 151, 183, 140],
        [170, 153, 138, 138, 122, 121, 122, 121, 167, 151, 183, 140, 151, 183, 140],
    ],
    "gt1_luma": [
        [140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107, 122, 152],
        [154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 137],
        [154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 122],
    ],
    "gt1_chroma": [
        [140, 179, 166, 182, 140, 227, 122, 197],
        [169, 194, 166, 167, 154, 167, 137, 182],
        [169, 208, 166, 167, 154, 152, 167, 182],
    ],
    "gt2_luma": [[138, 153, 136, 167], [107, 167, 91, 122], [107, 167, 91, 107]],
    "gt2_chroma": [[152, 152], [107, 167], [107, 167]],
}
_INIT_VALUES["last_y_luma"] = _INIT_VALUES["last_x_luma"]
_INIT_VALUES["last_y_chroma"] = _INIT_VALUES["last_x_chroma"]


def _init_state(init_value: int, qp: int) -> int:
    """Spec 9.3.2.2: initValue + SliceQpY -> packed context state."""
    slope = (init_value >> 4) * 5 - 45
    offset = ((init_value & 15) << 3) - 16
    pre = min(max(1, ((slope * min(max(0, qp), 51)) >> 4) + offset), 126)
    mps = 1 if pre > 63 else 0
    p_state = (pre - 64) if mps else (63 - pre)
    return (p_state << 1) | mps


def init_contexts(slice_type_init: int, qp: int) -> np.ndarray:
    """Build the full context-state array for a slice.

    slice_type_init: initType (0=I, 1=P, 2=B after cabac_init_flag).
    """
    states = np.empty(NUM_CONTEXTS, dtype=np.uint8)
    for name, cnt in _CTX_LAYOUT:
        vals = _INIT_VALUES[name][slice_type_init]
        off = CTX_OFF[name]
        for i in range(cnt):
            states[off + i] = _init_state(vals[i], qp)
    return states


# ---------------------------------------------------------------------------
# Scan orders (spec 6.5.3-6.5.5)
# ---------------------------------------------------------------------------

SCAN_DIAG, SCAN_HOR, SCAN_VER = 0, 1, 2


def _diag_scan(n: int):
    """Up-right diagonal scan of an n x n block -> list of (x, y)."""
    out = []
    for s in range(2 * n - 1):
        # within a diagonal, start at the lowest-left element and move up-right
        for y in range(min(s, n - 1), -1, -1):
            x = s - y
            if x < n:
                out.append((x, y))
    return out


def _hor_scan(n: int):
    return [(x, y) for y in range(n) for x in range(n)]


def _ver_scan(n: int):
    return [(x, y) for x in range(n) for y in range(n)]


def build_scan(log2_size: int, scan_idx: int) -> np.ndarray:
    """Coefficient scan for a TB: raster index per scan position.

    Hierarchical: 4x4 coefficient groups scanned in the given order, and the
    same order inside each group (spec 6.5.3).
    """
    n = 1 << log2_size
    if log2_size == 2:
        groups = [(0, 0)]
        inner_n = 4
    else:
        ng = n >> 2
        groups = {SCAN_DIAG: _diag_scan, SCAN_HOR: _hor_scan, SCAN_VER: _ver_scan}[scan_idx](ng)
        inner_n = 4
    inner = {SCAN_DIAG: _diag_scan, SCAN_HOR: _hor_scan, SCAN_VER: _ver_scan}[scan_idx](inner_n)
    order = np.empty(n * n, dtype=np.int32)
    k = 0
    for gx, gy in groups:
        for ix, iy in inner:
            x, y = gx * 4 + ix, gy * 4 + iy
            order[k] = y * n + x
            k += 1
    return order


def build_cg_scan(log2_size: int, scan_idx: int) -> np.ndarray:
    """Scan order of 4x4 coefficient groups: raster CG index per scan pos."""
    ng = max(1, (1 << log2_size) >> 2)
    if ng == 1:
        return np.zeros(1, dtype=np.int32)
    groups = {SCAN_DIAG: _diag_scan, SCAN_HOR: _hor_scan, SCAN_VER: _ver_scan}[scan_idx](ng)
    return np.array([gy * ng + gx for gx, gy in groups], dtype=np.int32)


# Cache of scan tables: SCANS[(log2_size, scan_idx)] -> raster order array
SCANS = {}
CG_SCANS = {}
for _l in (2, 3, 4, 5):
    for _si in (SCAN_DIAG, SCAN_HOR, SCAN_VER):
        if _l > 3 and _si != SCAN_DIAG:
            continue  # mode-dependent scans only at 4x4/8x8
        SCANS[(_l, _si)] = build_scan(_l, _si)
        CG_SCANS[(_l, _si)] = build_cg_scan(_l, _si)


def coeff_scan_index(log2_size: int, c_idx: int, intra_mode: int, is_intra: bool) -> int:
    """Mode-dependent scan selection (spec 7.4.9.11 scanIdx derivation)."""
    if is_intra and (log2_size == 2 or (log2_size == 3 and c_idx == 0)):
        if 6 <= intra_mode <= 14:
            return SCAN_VER
        if 22 <= intra_mode <= 30:
            return SCAN_HOR
    return SCAN_DIAG


# sig_coeff_flag 4x4 context index map (spec 9.3.4.2.5 ctxIdxMap)
SIG_CTX_MAP_4x4 = np.array(
    [0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8], dtype=np.int32)

# ---------------------------------------------------------------------------
# Intra prediction tables (spec 8.4.4.2.6)
# ---------------------------------------------------------------------------

# intraPredAngle for modes 2..34
INTRA_PRED_ANGLE = np.array(
    [32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
     -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32],
    dtype=np.int32)

# invAngle = round(8192 / intraPredAngle) for negative angles (modes 11..25)
INTRA_INV_ANGLE = np.array(
    [-4096, -1638, -910, -630, -482, -390, -315, -256,
     -315, -390, -482, -630, -910, -1638, -4096], dtype=np.int32)
# indexed by mode-11 for modes 11..25


def intra_filter_flag(mode: int, log2_size: int) -> bool:
    """Reference-sample smoothing decision (spec 8.4.4.2.3)."""
    if mode == 1 or mode == 10 or mode == 26:   # DC / pure hor / pure ver
        return False
    if log2_size == 2:
        return False
    if mode == 0:  # planar filters except at 4x4
        return True
    min_dist = min(abs(mode - 26), abs(mode - 10))
    thresh = {3: 7, 4: 1, 5: 0}[log2_size]
    return min_dist > thresh


# ---------------------------------------------------------------------------
# QP / chroma tables (spec 8-10) and quant scales
# ---------------------------------------------------------------------------

# chroma QP mapping for 4:2:0 (qPi -> QpC)
_CHROMA_QP_MAP = list(range(30)) + [29, 30, 31, 32, 33, 33, 34, 34, 35, 35,
                                    36, 36, 37, 37] + [q - 6 for q in range(44, 70)]
CHROMA_QP_TABLE = np.array(_CHROMA_QP_MAP, dtype=np.int32)


def chroma_qp(qp_y: int, qp_offset: int = 0, bit_depth: int = 8) -> int:
    qp_bd_offset = 6 * (bit_depth - 8)
    q = min(max(-qp_bd_offset, qp_y + qp_offset), 57)
    if q < 0:
        return q + qp_bd_offset
    return int(CHROMA_QP_TABLE[q]) + qp_bd_offset


# forward quant scales: round(2^14 / qstep) per qp%6  (spec-aligned, 8.6.3)
QUANT_SCALES = np.array([26214, 23302, 20560, 18396, 16384, 14564], dtype=np.int32)
# inverse quant scales per qp%6
DEQUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], dtype=np.int32)

# --- default scaling lists (spec 7.4.5 Tables 7-5/7-6; x265 analog
# scalinglist.cpp:417 setDefaultScalingList). 4x4 default is flat 16;
# 16x16/32x32 are the 8x8 matrix upsampled 2x/4x with DC kept at 16.
SCALING_DEFAULT_8x8_INTRA = np.array([
    [16, 16, 16, 16, 17, 18, 21, 24],
    [16, 16, 16, 16, 17, 19, 22, 25],
    [16, 16, 17, 18, 20, 22, 25, 29],
    [16, 16, 18, 21, 24, 27, 31, 36],
    [17, 17, 20, 24, 30, 35, 41, 47],
    [18, 19, 22, 27, 35, 44, 54, 65],
    [21, 22, 25, 31, 41, 54, 70, 88],
    [24, 25, 29, 36, 47, 65, 88, 115]], dtype=np.int32)
SCALING_DEFAULT_8x8_INTER = np.array([
    [16, 16, 16, 16, 17, 18, 20, 24],
    [16, 16, 16, 17, 18, 20, 24, 25],
    [16, 16, 17, 18, 20, 24, 25, 28],
    [16, 17, 18, 20, 24, 25, 28, 33],
    [17, 18, 20, 24, 25, 28, 33, 41],
    [18, 20, 24, 25, 28, 33, 41, 54],
    [20, 24, 25, 28, 33, 41, 54, 71],
    [24, 25, 28, 33, 41, 54, 71, 91]], dtype=np.int32)


def default_scaling_matrix(n: int, is_intra: bool) -> np.ndarray:
    """[n,n] default scaling matrix m (spec 7.4.5 semantics: ScalingFactor
    derivation 7-40..7-46). n=4 flat; n in (8,16,32) from the 8x8 base with
    nearest upsampling; DC term (0,0) is scaling_list_dc = 16 by default."""
    if n == 4:
        return np.full((4, 4), 16, np.int32)
    base = (SCALING_DEFAULT_8x8_INTRA if is_intra
            else SCALING_DEFAULT_8x8_INTER)
    if n == 8:
        return base.copy()
    r = n // 8
    m = np.repeat(np.repeat(base, r, 0), r, 1).astype(np.int32)
    m[0, 0] = 16
    return m


# Golomb-Rice parameter update thresholds (spec 9.3.3.13)
GO_RICE_RANGE = np.array([7, 14, 26, 46, 78], dtype=np.int32)

# RDOQ lambda, 5-bit fixed point (x265 Quant::setQPforQuant lambda wiring,
# calibration 0.4 from round-1 tuning): LAM32[qp] ~ 0.4*0.85*2^((qp-12)/3)*32.
# Kept integer so the native finalizer, the Python oracle, and the TPU
# residual pipeline make bit-identical RDOQ decisions (no float divergence).
RDOQ_LAM32 = np.array(
    [int(np.floor(0.4 * 0.85 * (2.0 ** ((q - 12) / 3.0)) * 32 + 0.5))
     for q in range(70)], dtype=np.int64)

# Full-calibration variant (x265's lambda2, rdcost.h): used by the
# estBit fractional-bit RDOQ path (hevc/rate_model.py) — real bits get
# the real lambda; the 0.4 factor above compensated the bin-count
# model's systematic rate overestimate.
RDOQ_LAM32_FULL = np.array(
    [int(np.floor(0.85 * (2.0 ** ((q - 12) / 3.0)) * 32 + 0.5))
     for q in range(70)], dtype=np.int64)
