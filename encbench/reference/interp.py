"""HEVC fractional-sample interpolation (spec 8.5.4.2.2; x265 analog:
the ipfilter primitive family, common/ipfilter.cpp + ~26K lines of asm,
SURVEY.md §2.3 `pu[].luma_hpp/...` / `chroma.filter_*`).

Exact-spec reference implementation (numpy): 8-tap luma at quarter-pel,
4-tap chroma at eighth-pel, with the normative intermediate precision:

    shift1 = BitDepth - 8   (after horizontal pass)
    shift2 = 6              (after vertical pass on intermediates)
    pred is kept at 14-bit; uni-prediction rounds with
    shift = 14 - BitDepth (8.5.4.2.3.1 default weighted prediction).

The TPU path mirrors this as separable convolutions producing per-phase
planes (ops/interp_tpu once ME needs them); this module is the bit-exact
oracle and the writer/decoder MC engine.
"""
from __future__ import annotations

import numpy as np

# Table 8-11: luma interpolation filter coefficients fL[frac][tap]
LUMA_FILTERS = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], dtype=np.int32)

# Table 8-13: chroma interpolation filter coefficients fC[frac][tap]
CHROMA_FILTERS = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2],
], dtype=np.int32)


def _filt_h(block: np.ndarray, coeffs: np.ndarray, ntaps: int) -> np.ndarray:
    """Horizontal FIR: block [h, w+ntaps-1] -> [h, w]."""
    w = block.shape[1] - ntaps + 1
    acc = np.zeros((block.shape[0], w), dtype=np.int64)
    for t in range(ntaps):
        acc += coeffs[t] * block[:, t:t + w].astype(np.int64)
    return acc


def _filt_v(block: np.ndarray, coeffs: np.ndarray, ntaps: int) -> np.ndarray:
    """Vertical FIR: block [h+ntaps-1, w] -> [h, w]."""
    h = block.shape[0] - ntaps + 1
    acc = np.zeros((h, block.shape[1]), dtype=np.int64)
    for t in range(ntaps):
        acc += coeffs[t] * block[t:t + h, :].astype(np.int64)
    return acc


def _mc_14(ref_pad: np.ndarray, pad: int, x0: int, y0: int, w: int, h: int,
           mv: tuple, filters: np.ndarray, frac_bits: int, bd: int
           ) -> np.ndarray:
    """Core MC to 14-bit prediction samples. mv in 1/2**frac_bits pel."""
    ntaps = filters.shape[1]
    half = ntaps // 2
    fmask = (1 << frac_bits) - 1
    xi, xf = (x0 + (mv[0] >> frac_bits)), mv[0] & fmask
    yi, yf = (y0 + (mv[1] >> frac_bits)), mv[1] & fmask
    shift1 = bd - 8
    if xf == 0 and yf == 0:
        blk = ref_pad[pad + yi:pad + yi + h, pad + xi:pad + xi + w]
        return blk.astype(np.int64) << (14 - bd)
    if yf == 0:
        src = ref_pad[pad + yi:pad + yi + h,
                      pad + xi - half + 1:pad + xi + w + half]
        return _filt_h(src, filters[xf], ntaps) >> shift1
    if xf == 0:
        src = ref_pad[pad + yi - half + 1:pad + yi + h + half,
                      pad + xi:pad + xi + w]
        return _filt_v(src, filters[yf], ntaps) >> shift1
    src = ref_pad[pad + yi - half + 1:pad + yi + h + half,
                  pad + xi - half + 1:pad + xi + w + half]
    tmp = _filt_h(src, filters[xf], ntaps) >> shift1
    return _filt_v(tmp, filters[yf], ntaps) >> 6


def mc_luma_14(ref_pad, pad, x0, y0, w, h, mv, bd=8):
    """Luma MC to 14-bit intermediate (for bi-prediction). mv quarter-pel."""
    return _mc_14(ref_pad, pad, x0, y0, w, h, mv, LUMA_FILTERS, 2, bd)


def mc_chroma_14(ref_pad, pad, xc, yc, w, h, mv, bd=8):
    """Chroma MC to 14-bit. mv is the *luma* quarter-pel MV (chroma uses
    eighth-pel = same integer value reinterpreted, 8.5.4.2.2.2)."""
    return _mc_14(ref_pad, pad, xc, yc, w, h, mv, CHROMA_FILTERS, 3, bd)


def unipred(pred14: np.ndarray, bd: int = 8) -> np.ndarray:
    """Default uni weighted prediction (8.5.4.2.3.1): 14-bit -> pixels."""
    shift = 14 - bd
    off = 1 << (shift - 1)
    return np.clip((pred14 + off) >> shift, 0, (1 << bd) - 1).astype(np.int32)


def weighted_unipred(pred14: np.ndarray, w: int, off: int, denom: int,
                     bd: int = 8) -> np.ndarray:
    """Explicit weighted uni prediction (8.5.4.2.3.2): 14-bit -> pixels.

    log2Wd = denom + (14 - bd); offset is scaled by (bd - 8) per spec.
    Reference analog: x265 weightedPredictionUni (predict.cpp)."""
    log2wd = denom + 14 - bd
    o = off << (bd - 8)
    p32 = pred14.astype(np.int64)
    if log2wd >= 1:
        val = ((p32 * w + (1 << (log2wd - 1))) >> log2wd) + o
    else:
        val = p32 * w + o
    return np.clip(val, 0, (1 << bd) - 1).astype(np.int32)


def bipred(pred14_a: np.ndarray, pred14_b: np.ndarray, bd: int = 8):
    """Default bi weighted prediction: average of two 14-bit preds."""
    shift = 15 - bd
    off = 1 << (shift - 1)
    return np.clip((pred14_a + pred14_b + off) >> shift,
                   0, (1 << bd) - 1).astype(np.int32)


def mc_luma(ref_pad, pad, x0, y0, w, h, mv, bd=8):
    """Uni-pred luma block at quarter-pel mv -> pixel-domain int32 [h, w]."""
    return unipred(mc_luma_14(ref_pad, pad, x0, y0, w, h, mv, bd), bd)


def mc_chroma(ref_pad, pad, xc, yc, w, h, mv, bd=8):
    """Uni-pred chroma block; mv is the luma quarter-pel MV."""
    return unipred(mc_chroma_14(ref_pad, pad, xc, yc, w, h, mv, bd), bd)
