"""Reference (numpy) HEVC transforms + quantization — spec 8.6.

Golden model for the TPU transform kernels (``x265_tpu_torch.ops.transform``)
and the production inverse path of the reference decoder. x265 analogs:
source/common/dct.cpp (partial butterflies), source/encoder/quant.cpp.

The integer DCT matrices are generated from the spec's 33-entry scaled
cosine constant list via the (k*(2n+1)) mod 128 symmetry — the constants
are hand-tuned by the standard (not exact cosine roundings), so they are
listed literally.
"""
from __future__ import annotations

import numpy as np

# CC[s] ~ scaled cos(s*pi/64), s=0..32 (spec-tuned integers; CC[32]=0)
_CC = np.array([
    64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
    64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4, 0,
], dtype=np.int64)


def _cos_val(s: int) -> int:
    s %= 128
    if s <= 32:
        return int(_CC[s])
    if s <= 64:
        return -int(_CC[64 - s])
    if s <= 96:
        return -int(_CC[s - 64])
    return int(_CC[128 - s])


def dct_matrix(n: int) -> np.ndarray:
    """HEVC integer DCT-II basis T[k][n_] for n in {4, 8, 16, 32}."""
    stride = 32 // n
    t = np.empty((n, n), dtype=np.int64)
    for k in range(n):
        for j in range(n):
            t[k, j] = _cos_val(k * (2 * j + 1) * stride)
    return t


# 4x4 DST-VII (spec 8.6.4.2) — used for 4x4 intra luma
DST4 = np.array([
    [29, 55, 74, 84],
    [74, 74, 0, -74],
    [84, -29, -74, 55],
    [55, -84, 74, -29],
], dtype=np.int64)

DCT = {n: dct_matrix(n) for n in (4, 8, 16, 32)}

MAX_TR_DYNAMIC_RANGE = 15
QUANT_SHIFT = 14
IQUANT_SHIFT = 6

LEV_SCALE = np.array([40, 45, 51, 57, 64, 72], dtype=np.int64)     # dequant
QUANT_SCALE = np.array([26214, 23302, 20560, 18396, 16384, 14564],
                       dtype=np.int64)                              # quant


def _t(n: int, dst: bool) -> np.ndarray:
    return DST4 if (dst and n == 4) else DCT[n]


def forward_transform(resi: np.ndarray, dst: bool = False,
                      bit_depth: int = 8) -> np.ndarray:
    """Forward 2-D transform of an [n,n] residual -> coefficient block.

    Matches the HM/x265 scaling: shift1 = log2n + bd - 9, shift2 = log2n + 6,
    intermediate clip to 16 bits.
    """
    n = resi.shape[0]
    log2 = n.bit_length() - 1
    t = _t(n, dst)
    shift1 = log2 + bit_depth - 9
    shift2 = log2 + 6
    # columns first? HM applies stage1 on rows of input: E = T * resi^T ...
    # Using separable form: coeff = (T @ resi @ T^T) with per-stage shifts.
    tmp = (t @ resi.astype(np.int64).T + (1 << (shift1 - 1))) >> shift1
    out = (t @ tmp.T + (1 << (shift2 - 1))) >> shift2
    return out.astype(np.int32)


def inverse_transform(coeff: np.ndarray, dst: bool = False,
                      bit_depth: int = 8) -> np.ndarray:
    """Normative inverse transform (spec 8.6.4): stage shifts 7 and 20-bd,
    16-bit clamp between stages."""
    n = coeff.shape[0]
    t = _t(n, dst)
    shift1 = 7
    shift2 = 20 - bit_depth
    c = coeff.astype(np.int64)
    tmp = (t.T @ c + (1 << (shift1 - 1))) >> shift1
    tmp = np.clip(tmp, -32768, 32767)
    out = (t.T @ tmp.T + (1 << (shift2 - 1))) >> shift2
    out = np.clip(out, -32768, 32767)
    return out.T.astype(np.int32)


def quantize(coeff: np.ndarray, qp: int, log2: int, is_intra: bool,
             bit_depth: int = 8, m: np.ndarray = None) -> np.ndarray:
    """Scalar forward quant (x265 Quant::quant semantics, no RDOQ).

    m: optional [n,n] scaling matrix; the encoder-side per-position quant
    coefficient is quantScale[rem]*16/m (x265 ScalingList::processScaling
    quantCoef derivation) — flat 16 reduces to quantScale[rem] exactly."""
    per, rem = qp // 6, qp % 6
    tr_shift = MAX_TR_DYNAMIC_RANGE - bit_depth - log2
    qbits = QUANT_SHIFT + per + tr_shift
    offset = (171 if is_intra else 85) << (qbits - 9)
    c = coeff.astype(np.int64)
    if m is None:
        scale = int(QUANT_SCALE[rem])
    else:
        scale = (int(QUANT_SCALE[rem]) * 16) // m.astype(np.int64)
    level = (np.abs(c) * scale + offset) >> qbits
    level = np.clip(level, 0, 32767)
    return (np.sign(c) * level).astype(np.int32)


def dequantize(level: np.ndarray, qp: int, log2: int,
               bit_depth: int = 8, m: np.ndarray = None) -> np.ndarray:
    """Normative dequant (spec 8.6.3); m = scaling matrix (flat 16 when
    scaling lists are off)."""
    per, rem = qp // 6, qp % 6
    bd_shift = bit_depth + log2 - 5
    mm = 16 if m is None else m.astype(np.int64)
    scale = int(LEV_SCALE[rem]) * mm
    d = (level.astype(np.int64) * scale << per) + (1 << (bd_shift - 1))
    d >>= bd_shift
    return np.clip(d, -32768, 32767).astype(np.int32)


def sign_bit_hiding_adjust(level: np.ndarray, scan: np.ndarray) -> np.ndarray:
    """Pre-condition quantized levels for sign-data hiding (encoder choice;
    x265 analog: Quant::signBitHidingHDQ, quant.cpp:247).

    For each 16-coefficient group where SDH applies (lastNZ - firstNZ > 3),
    force parity(sum of abs levels) == sign(first NZ): adjust the hidden
    coefficient's magnitude by +/-1 (never across zero), keeping positions
    stable.
    """
    out = level.copy()
    n = level.shape[0]
    flat = out.reshape(-1)
    s = flat[scan]
    for cg in range(0, n * n, 16):
        sub = s[cg:cg + 16]
        nz = np.nonzero(sub)[0]
        if nz.size == 0:
            continue
        first, last = int(nz[0]), int(nz[-1])
        if last - first <= 3:
            continue
        want = 1 if sub[first] < 0 else 0
        if (int(np.abs(sub).sum()) & 1) != want:
            v = int(sub[first])
            sub[first] = v + (1 if v > 0 else -1) if abs(v) == 1 else \
                v - (1 if v > 0 else -1)
    flat[scan] = s
    return out


def transform_skip_residual(dequant: np.ndarray, bit_depth: int = 8) -> np.ndarray:
    """Residual for transform-skip TBs (spec 8.6.4.2 ts branch)."""
    bd_shift2 = 20 - bit_depth
    r = (dequant.astype(np.int64) << 7)
    r = (r + (1 << (bd_shift2 - 1))) >> bd_shift2
    return np.clip(r, -32768, 32767).astype(np.int32)


def rate_bins(l: np.ndarray) -> np.ndarray:
    """Static bin-count rate model shared by RDOQ and the transform-skip
    decision (sig + gt1 + sign, plus golomb-ish tail for l > 1)."""
    l = np.abs(l).astype(np.int64)
    r = np.where(l > 0, 3, 1).astype(np.int64)
    lg = np.zeros_like(l)
    mask = l > 1
    lg[mask] = np.floor(np.log2(l[mask].astype(np.float64))).astype(np.int64)
    return r + np.where(mask, 2 + 2 * lg, 0)


def tb_cost32(resi: np.ndarray, rres: np.ndarray, level: np.ndarray,
              qp: int) -> int:
    """Pixel-domain integer RD cost of one coded TB:
    32*SSE + RDOQ_LAM32[qp]*rate (the same fixed-point lambda the RDOQ
    uses, so native/oracle/device rank candidates identically)."""
    from encbench.reference.tables import RDOQ_LAM32
    e = resi.astype(np.int64) - rres.astype(np.int64)
    nz = level.any()
    rate = int(rate_bins(level).sum()) if nz else 0
    return 32 * int((e * e).sum()) + int(RDOQ_LAM32[qp]) * rate


def forward_transform_skip(resi: np.ndarray, bit_depth: int = 8) -> np.ndarray:
    """Forward path of a transform-skip 4x4 TB (quant.cpp transformNxN
    tskip branch): coeff = resi << trShift, the same gain the DCT stage
    shifts produce."""
    return (resi.astype(np.int32) << (13 - bit_depth))


