"""residual_coding() syntax — encode and decode (HEVC spec 7.3.8.11,
9.3.4.2.3-9.3.4.2.9, 9.3.3.13).

Context-derivation helpers are shared between the encoder finalizer and the
reference decoder so a single test can pin both. x265's analogous code:
Entropy::codeCoeffNxN (source/encoder/entropy.cpp:1825) and the
scanPosLast/costCoeff primitives (SURVEY.md §2.3).
"""
from __future__ import annotations

import numpy as np

from encbench.reference.cabac import CabacDecoder, CabacEncoder
from encbench.reference.tables import (
    CTX_OFF, SCANS, CG_SCANS, SCAN_VER, SIG_CTX_MAP_4x4,
)

# last position group tables (spec Table 9-48 binarization)
MIN_IN_GROUP = np.array([0, 1, 2, 3, 4, 6, 8, 12, 16, 24], dtype=np.int32)
GROUP_IDX = np.array(
    [0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7,
     8, 8, 8, 8, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9, 9, 9], dtype=np.int32)

C1FLAG_NUMBER = 8       # max greater1 flags per CG
C2FLAG_NUMBER = 1       # max greater2 flags per CG
COEF_REMAIN_BIN_REDUCTION = 3


def _last_ctx_params(log2: int, luma: bool):
    if luma:
        offset = 3 * (log2 - 2) + ((log2 - 1) >> 2)
        shift = (log2 + 1) >> 2
    else:
        offset = 0
        shift = log2 - 2
    return offset, shift


def _sig_ctx(x: int, y: int, log2: int, luma: bool, scan_idx: int,
             prev_csbf: int) -> int:
    """sig_coeff_flag ctxInc within the luma/chroma context family."""
    if log2 == 2:
        return int(SIG_CTX_MAP_4x4[(y << 2) + x])
    if x + y == 0:
        return 0
    xp, yp = x & 3, y & 3
    if prev_csbf == 0:
        s = xp + yp
        cnt = 2 if s == 0 else (1 if s <= 2 else 0)
    elif prev_csbf == 1:
        cnt = 2 if yp == 0 else (1 if yp == 1 else 0)
    elif prev_csbf == 2:
        cnt = 2 if xp == 0 else (1 if xp == 1 else 0)
    else:
        cnt = 2
    first_cg = (x >> 2) + (y >> 2) == 0
    if luma:
        base = 0 if first_cg else 3
        offset = (9 if scan_idx == 0 else 15) if log2 == 3 else 21
    else:
        base = 0
        offset = 9 if log2 == 3 else 12
    return base + offset + cnt


# ---------------------------------------------------------------------------
# Encoder side
# ---------------------------------------------------------------------------

def encode_residual(enc: CabacEncoder, coeff: np.ndarray, log2: int,
                    c_idx: int, scan_idx: int,
                    sign_hiding: bool = False,
                    transquant_bypass: bool = False,
                    transform_skip: int = -1) -> None:
    """Encode one TB's coefficients. coeff: [n, n] int array (raster).

    transform_skip: -1 = flag not present; 0/1 = signal
    transform_skip_flag (7.3.8.11, 4x4 TBs with --tskip) before the
    last-position syntax — mirroring the decoder's parse order."""
    n = 1 << log2
    luma = c_idx == 0
    if transform_skip >= 0:
        enc.encode_bin(CTX_OFF["transform_skip_luma" if luma else
                               "transform_skip_chroma"], transform_skip)
    scan = SCANS[(log2, scan_idx)]
    cg_scan = CG_SCANS[(log2, scan_idx)]
    flat = coeff.reshape(-1)
    levels = flat[scan]                       # coefficients in scan order
    nz = np.nonzero(levels)[0]
    assert nz.size > 0, "encode_residual requires a non-zero TB (cbf=1)"
    last_scan_pos = int(nz[-1])

    # --- last position ---
    last_raster = int(scan[last_scan_pos])
    last_x, last_y = last_raster % n, last_raster // n
    if scan_idx == SCAN_VER:
        last_x, last_y = last_y, last_x
    _encode_last_xy(enc, last_x, last_y, log2, luma)

    # --- CG pass ---
    ng = max(1, n >> 2)
    num_cgs = (last_scan_pos >> 4) + 1
    csbf = np.zeros(ng * ng, dtype=np.int8)   # raster CG indices
    cg_levels = levels.reshape(-1, 16)
    for ci in range(num_cgs):
        if np.any(cg_levels[ci] != 0):
            csbf[cg_scan[ci]] = 1

    c1 = 1
    for ci in range(num_cgs - 1, -1, -1):
        cg_raster = int(cg_scan[ci])
        cgx, cgy = cg_raster % ng, cg_raster // ng
        right = int(csbf[cgy * ng + cgx + 1]) if cgx + 1 < ng else 0
        below = int(csbf[(cgy + 1) * ng + cgx]) if cgy + 1 < ng else 0
        is_last_cg = ci == num_cgs - 1
        infer_sb_dc = False
        if is_last_cg or ci == 0:
            # csbf inferred 1 for the last and the DC sub-block (spec
            # 7.4.9.11): sig flags are coded there even if all zero
            csbf[cg_raster] = 1
        else:
            ctx = CTX_OFF["csbf_luma" if luma else "csbf_chroma"] + \
                (1 if (right or below) else 0)
            enc.encode_bin(ctx, int(csbf[cg_raster]))
            infer_sb_dc = bool(csbf[cg_raster])
        if not csbf[cg_raster]:
            continue

        sub = cg_levels[ci]
        start = 15 if not is_last_cg else (last_scan_pos & 15) - 1
        # sig flags (reverse scan); last coeff's sig implied
        sig_positions = []
        if is_last_cg:
            sig_positions.append(last_scan_pos & 15)
        prev_csbf = right + 2 * below
        sig_off = CTX_OFF["sig_luma" if luma else "sig_chroma"]
        for k in range(start, -1, -1):
            sig = 1 if sub[k] != 0 else 0
            if k == 0 and infer_sb_dc and not sig_positions:
                # all later coeffs zero in an explicitly-signaled CG:
                # sig_coeff_flag[0] inferred 1
                sig_positions.append(0)
                break
            raster = int(scan[(ci << 4) + k])
            x, y = raster % n, raster // n
            ctx = sig_off + _sig_ctx(x, y, log2, luma, scan_idx, prev_csbf)
            enc.encode_bin(ctx, sig)
            if sig:
                sig_positions.append(k)
        # coefficient data for this CG (positions in reverse scan order)
        abs_vals = [int(abs(sub[k])) for k in sorted(sig_positions, reverse=True)]
        signs = [1 if sub[k] < 0 else 0 for k in sorted(sig_positions, reverse=True)]
        nnz = len(abs_vals)

        ctx_set = (2 if (ci > 0 and luma) else 0) + (1 if c1 == 0 else 0)
        c1 = 1
        g1_off = CTX_OFF["gt1_luma" if luma else "gt1_chroma"]
        g2_off = CTX_OFF["gt2_luma" if luma else "gt2_chroma"]
        num_c1 = min(nnz, C1FLAG_NUMBER)
        first_g2_idx = -1
        for i in range(num_c1):
            sym = 1 if abs_vals[i] > 1 else 0
            enc.encode_bin(g1_off + 4 * ctx_set + c1, sym)
            if sym:
                c1 = 0
                if first_g2_idx == -1:
                    first_g2_idx = i
            elif 0 < c1 < 3:
                c1 += 1
        if first_g2_idx != -1:
            enc.encode_bin(g2_off + ctx_set, 1 if abs_vals[first_g2_idx] > 2 else 0)

        # sign bits
        pos_sorted = sorted(sig_positions, reverse=True)
        if not pos_sorted:
            c1 = 1  # empty inferred CG still resets the carried c1 state
            continue
        sign_hidden = (sign_hiding and not transquant_bypass and
                       pos_sorted[0] - pos_sorted[-1] > 3)
        n_signs = nnz - 1 if sign_hidden else nnz
        for i in range(n_signs):
            enc.encode_bin_ep(signs[i])

        # remaining levels
        rice = 0
        for i in range(nnz):
            if i < C1FLAG_NUMBER:
                base = 3 if i == first_g2_idx else 2
            else:
                base = 1
            if abs_vals[i] >= base:
                _encode_remain(enc, abs_vals[i] - base, rice)
            if abs_vals[i] > (3 << rice):
                rice = min(rice + 1, 4)


def _encode_last_xy(enc: CabacEncoder, last_x: int, last_y: int, log2: int,
                    luma: bool) -> None:
    gx, gy = int(GROUP_IDX[last_x]), int(GROUP_IDX[last_y])
    offset, shift = _last_ctx_params(log2, luma)
    cmax = (log2 << 1) - 1
    ox = CTX_OFF["last_x_luma" if luma else "last_x_chroma"]
    oy = CTX_OFF["last_y_luma" if luma else "last_y_chroma"]
    for i in range(gx):
        enc.encode_bin(ox + offset + (i >> shift), 1)
    if gx < cmax:
        enc.encode_bin(ox + offset + (gx >> shift), 0)
    for i in range(gy):
        enc.encode_bin(oy + offset + (i >> shift), 1)
    if gy < cmax:
        enc.encode_bin(oy + offset + (gy >> shift), 0)
    if gx > 3:
        nbits = (gx >> 1) - 1
        enc.encode_bins_ep(last_x - int(MIN_IN_GROUP[gx]), nbits)
    if gy > 3:
        nbits = (gy >> 1) - 1
        enc.encode_bins_ep(last_y - int(MIN_IN_GROUP[gy]), nbits)


def _encode_remain(enc: CabacEncoder, value: int, rice: int) -> None:
    if value < (COEF_REMAIN_BIN_REDUCTION << rice):
        length = value >> rice
        enc.encode_bins_ep((1 << (length + 1)) - 2, length + 1)
        if rice:
            enc.encode_bins_ep(value & ((1 << rice) - 1), rice)
    else:
        length = rice
        value -= COEF_REMAIN_BIN_REDUCTION << rice
        while value >= (1 << length):
            value -= 1 << length
            length += 1
        npre = COEF_REMAIN_BIN_REDUCTION + length + 1 - rice
        enc.encode_bins_ep((1 << npre) - 2, npre)
        enc.encode_bins_ep(value, length)


# ---------------------------------------------------------------------------
# Decoder side
# ---------------------------------------------------------------------------

def decode_residual(dec: CabacDecoder, log2: int, c_idx: int, scan_idx: int,
                    sign_hiding: bool = False,
                    transquant_bypass: bool = False) -> np.ndarray:
    """Decode one TB's coefficients -> [n, n] int32 raster array."""
    n = 1 << log2
    luma = c_idx == 0
    scan = SCANS[(log2, scan_idx)]
    cg_scan = CG_SCANS[(log2, scan_idx)]
    levels = np.zeros(n * n, dtype=np.int64)  # scan-order levels

    last_x, last_y = _decode_last_xy(dec, log2, luma)
    if scan_idx == SCAN_VER:
        last_x, last_y = last_y, last_x
    last_raster = last_y * n + last_x
    last_scan_pos = int(np.nonzero(scan == last_raster)[0][0])

    ng = max(1, n >> 2)
    num_cgs = (last_scan_pos >> 4) + 1
    csbf = np.zeros(ng * ng, dtype=np.int8)

    c1 = 1
    for ci in range(num_cgs - 1, -1, -1):
        cg_raster = int(cg_scan[ci])
        cgx, cgy = cg_raster % ng, cg_raster // ng
        right = int(csbf[cgy * ng + cgx + 1]) if cgx + 1 < ng else 0
        below = int(csbf[(cgy + 1) * ng + cgx]) if cgy + 1 < ng else 0
        is_last_cg = ci == num_cgs - 1
        infer_sb_dc = False
        if is_last_cg or ci == 0:
            csbf[cg_raster] = 1
        else:
            ctx = CTX_OFF["csbf_luma" if luma else "csbf_chroma"] + \
                (1 if (right or below) else 0)
            csbf[cg_raster] = dec.decode_bin(ctx)
            infer_sb_dc = bool(csbf[cg_raster])
        if not csbf[cg_raster]:
            continue

        start = 15 if not is_last_cg else (last_scan_pos & 15) - 1
        sig_positions = []
        if is_last_cg:
            sig_positions.append(last_scan_pos & 15)
        prev_csbf = right + 2 * below
        sig_off = CTX_OFF["sig_luma" if luma else "sig_chroma"]
        for k in range(start, -1, -1):
            if k == 0 and infer_sb_dc and not sig_positions:
                sig_positions.append(0)
                break
            raster = int(scan[(ci << 4) + k])
            x, y = raster % n, raster // n
            ctx = sig_off + _sig_ctx(x, y, log2, luma, scan_idx, prev_csbf)
            if dec.decode_bin(ctx):
                sig_positions.append(k)

        pos_sorted = sorted(sig_positions, reverse=True)
        nnz = len(pos_sorted)
        abs_vals = [1] * nnz

        ctx_set = (2 if (ci > 0 and luma) else 0) + (1 if c1 == 0 else 0)
        c1 = 1
        g1_off = CTX_OFF["gt1_luma" if luma else "gt1_chroma"]
        g2_off = CTX_OFF["gt2_luma" if luma else "gt2_chroma"]
        num_c1 = min(nnz, C1FLAG_NUMBER)
        first_g2_idx = -1
        for i in range(num_c1):
            if dec.decode_bin(g1_off + 4 * ctx_set + c1):
                abs_vals[i] = 2
                c1 = 0
                if first_g2_idx == -1:
                    first_g2_idx = i
            elif 0 < c1 < 3:
                c1 += 1
        if first_g2_idx != -1:
            if dec.decode_bin(g2_off + ctx_set):
                abs_vals[first_g2_idx] = 3

        if not pos_sorted:
            continue  # empty inferred CG (DC sub-block all zero)
        sign_hidden = (sign_hiding and not transquant_bypass and
                       pos_sorted[0] - pos_sorted[-1] > 3)
        n_signs = nnz - 1 if sign_hidden else nnz
        signs = [dec.decode_bins_ep(1) for _ in range(n_signs)]

        rice = 0
        total = 0
        for i in range(nnz):
            if i < C1FLAG_NUMBER:
                base = 3 if i == first_g2_idx else 2
            else:
                base = 1
            if abs_vals[i] == base:
                abs_vals[i] = base + _decode_remain(dec, rice)
            if abs_vals[i] > (3 << rice):
                rice = min(rice + 1, 4)
            total += abs_vals[i]
        if sign_hidden:
            signs.append(total & 1)

        for i, k in enumerate(pos_sorted):
            v = abs_vals[i]
            levels[(ci << 4) + k] = -v if signs[i] else v

    out = np.zeros(n * n, dtype=np.int64)
    out[scan] = levels
    return out.reshape(n, n).astype(np.int32)


def _decode_last_xy(dec: CabacDecoder, log2: int, luma: bool):
    offset, shift = _last_ctx_params(log2, luma)
    cmax = (log2 << 1) - 1
    ox = CTX_OFF["last_x_luma" if luma else "last_x_chroma"]
    oy = CTX_OFF["last_y_luma" if luma else "last_y_chroma"]
    gx = 0
    while gx < cmax and dec.decode_bin(ox + offset + (gx >> shift)):
        gx += 1
    gy = 0
    while gy < cmax and dec.decode_bin(oy + offset + (gy >> shift)):
        gy += 1
    if gx > 3:
        nbits = (gx >> 1) - 1
        last_x = int(MIN_IN_GROUP[gx]) + dec.decode_bins_ep(nbits)
    else:
        last_x = gx
    if gy > 3:
        nbits = (gy >> 1) - 1
        last_y = int(MIN_IN_GROUP[gy]) + dec.decode_bins_ep(nbits)
    else:
        last_y = gy
    return last_x, last_y


def _decode_remain(dec: CabacDecoder, rice: int) -> int:
    prefix = 0
    while prefix < 32 and dec.decode_bin_ep():
        prefix += 1
    if prefix < COEF_REMAIN_BIN_REDUCTION:
        suffix = dec.decode_bins_ep(rice) if rice else 0
        return (prefix << rice) + suffix
    suffix = dec.decode_bins_ep(prefix - COEF_REMAIN_BIN_REDUCTION + rice)
    return (((1 << (prefix - COEF_REMAIN_BIN_REDUCTION)) +
             COEF_REMAIN_BIN_REDUCTION - 1) << rice) + suffix
