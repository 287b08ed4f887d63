"""Adaptive quantization (x265 analog: calcAdaptiveQuantFrame,
slicetype.cpp:444-717 — AQ modes; cuTree offsets land on the same
per-QG map).

Modes (x265.h:574-578):
  1 AQ_VARIANCE:        qp_off = strength * (log2(max(energy,1))
                                  - (modeOneConst + 2*(depth-8)))
  2 AQ_AUTO_VARIANCE:   per-frame renormalized activity
                        a = (energy*bdCorr + 1)^0.1;
                        qp_off = aqStrength*avg_a * (a - avg_a')
                        with avg_a' = avg_a - 0.5*(avg(a^2) - C2)/avg_a
  3 AQ_AUTO_VARIANCE_BIASED (slicetype.cpp:589):
                        mode-2 + aqStrength * (1 - C2 / a^2) dark/flat bias
  4 AQ_EDGE (slicetype.cpp:596): 5x5 Gaussian + Scharr Sobel edge map;
                        blocks with edges use edge density as activity;
                        edges inclined around 45/135 degrees get
                        (strength + AQ_EDGE_BIAS) when above average

The per-block "AC energy" matches x265's acEnergyCu (slicetype.cpp:256):
luma SxS variance + both chroma (S/2)x(S/2) variances, each computed as
ssd - sum^2 >> (2*log2(n)) in integers. S = 16 (qg-size >= 16) or 8
(qg-size 8).

The block energies are whole-frame integer reductions on the device
(counterpart of x265_tpu/engine/aq.py); the float part is host numpy in
float64, copied unchanged. Offsets come back as
FLOATS at QG granularity (the caller rounds once after adding cuTree /
ROI offsets — x265 keeps doubles in m_lowres.qpAqOffset too).
"""
from __future__ import annotations

import numpy as np
import torch

from x265_tpu_torch.utils.device import resolve_device

AQ_EDGE_BIAS = 0.5          # slicetype.h:43
EDGE_INCLINATION = 45       # slicetype.h:44


def _block_var_int(p, S):
    """x265 acEnergyVar analog: ssd - sum^2 >> (2*log2(S)) per SxS
    block, in int32: sum <= S*S*1023 < 2^20 and ssd <= S*S*1023^2 < 2^28
    fit. The square of the sum does NOT always fit: the JAX package asks
    for int64 there but runs without 64-bit types, so its product is
    int32 and wraps once the sum passes 46340 (a 16x16 block brighter
    than 181 on average). The same wrapping product is taken here, so
    that both packages give the same offsets and the same stream; the
    fault is listed in ROADMAP.md for both to fix together."""
    H, W = p.shape
    b = p.reshape(H // S, S, W // S, S).to(torch.int32)
    s = b.sum(dim=(1, 3), dtype=torch.int32)
    ss = (b * b).sum(dim=(1, 3), dtype=torch.int32)
    shift = 2 * (S.bit_length() - 1)
    return ss - ((s * s) >> shift)


def _frame_energies(y, cb, cr, S: int = 16):
    """acEnergyCu grid [nby,nbx] int32: luma SxS variance plus both
    chroma (S/2)x(S/2) variances."""
    e = _block_var_int(y, S)
    return e + _block_var_int(cb, S // 2) + _block_var_int(cr, S // 2)


def _conv_same(img, k):
    """Zero-padded 'SAME' correlation of an int32 image with a small
    integer kernel, as shifted-slice sums: exact, whatever the device."""
    kh, kw = len(k), len(k[0])
    H, W = img.shape
    p = torch.zeros((H + kh - 1, W + kw - 1), dtype=torch.int32,
                    device=img.device)
    p[kh // 2:kh // 2 + H, kw // 2:kw // 2 + W] = img
    out = torch.zeros((H, W), dtype=torch.int32, device=img.device)
    for i in range(kh):
        for j in range(kw):
            if k[i][j]:
                out += int(k[i][j]) * p[i:i + H, j:j + W]
    return out


def _edge_maps(y, S: int = 16):
    """x265 edgeFilter (slicetype.cpp:151): 5x5 Gaussian smooth, then
    the 3/10 Scharr-style Sobel; returns per-block edge density (the
    acEnergyVar of the thresholded magnitude bitmap) and the average
    gradient angle in degrees [0,180). The two filters are integer sums
    (the JAX package runs them as fp32 convolutions, whose sums of small
    integers are exact too); magnitude and angle are float32."""
    g = [[2, 4, 5, 4, 2],
         [4, 9, 12, 9, 4],
         [5, 12, 15, 12, 5],
         [4, 9, 12, 9, 4],
         [2, 4, 5, 4, 2]]
    sm = _conv_same(y.to(torch.int32), g)
    # x265 truncates: pixel ((sum)/159), through a float32 division as
    # the reference does it
    sm = torch.floor(sm.to(torch.float32) / 159.0).to(torch.int32)
    # border pixels keep the source (edgeFilter only smooths the
    # interior); close enough at block granularity to use sm everywhere
    gh = _conv_same(sm, [[-3, 0, 3], [-10, 0, 10], [-3, 0, 3]]).to(
        torch.float32)
    gv = _conv_same(sm, [[-3, -10, -3], [0, 0, 0], [3, 10, 3]]).to(
        torch.float32)
    mag = torch.sqrt(gh * gh + gv * gv)
    edge = torch.where(mag >= 255.0, 255.0, 0.0).to(torch.float32)
    theta = torch.rad2deg(torch.atan2(gv, gh))
    theta = torch.where(theta < 0, 180.0 + theta, theta)
    H, W = y.shape
    eb = edge.reshape(H // S, S, W // S, S)
    s = eb.sum(dim=(1, 3))
    ss = (eb * eb).sum(dim=(1, 3))
    density = ss - s * s / (S * S)                 # variance-form density
    angle = theta.reshape(H // S, S, W // S, S).mean(dim=(1, 3))
    return density.to(torch.float32), angle


def aq_field(y, cb, cr, mode: int, strength: float, qg_size: int = 32,
             bit_depth: int = 8, hdr10_opt: bool = False, device=None):
    """Float per-block qp offsets at acEnergy granularity (16x16, or
    8x8 for qg-size 8) — the m_lowres.qpAqOffset analog. The caller
    aggregates to its QG/CTB grid and rounds once."""
    S = 8 if qg_size == 8 else 16
    modeOneConst = 11.427 if S == 8 else 14.427
    modeTwoConst = 8.0 if S == 8 else 11.0
    H, W = y.shape
    ph, pw = -(-H // S) * S, -(-W // S) * S
    y, cb, cr = (np.asarray(a) for a in (y, cb, cr))
    yp = np.pad(y if y.dtype in (np.uint8, np.int16, np.uint16)
                else y.astype(np.int16),
                ((0, ph - H), (0, pw - W)), mode="edge")
    hc, wc = cb.shape
    cbp = np.pad(cb if cb.dtype in (np.uint8, np.int16, np.uint16)
                 else cb.astype(np.int16),
                 ((0, ph // 2 - hc), (0, pw // 2 - wc)), mode="edge")
    crp = np.pad(cr if cr.dtype in (np.uint8, np.int16, np.uint16)
                 else cr.astype(np.int16),
                 ((0, ph // 2 - hc), (0, pw // 2 - wc)), mode="edge")
    dev = resolve_device(device)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(
            a if a.dtype != np.uint16 else a.astype(np.int32))).to(dev)
    yd = up(yp)
    energy = _frame_energies(yd, up(cbp), up(crp),
                             S=S).cpu().numpy().astype(np.float64)
    bd_corr = 1.0 / (1 << (2 * (bit_depth - 8)))
    if mode in (2, 3, 4):
        act = np.power(energy * bd_corr + 1.0, 0.1)
        inclined = None
        if mode == 4:
            density, angle = (a.cpu().numpy() for a in
                              _edge_maps(yd, S=S))
            has_edge = density > 0
            act = np.where(has_edge,
                           np.power(density * bd_corr + 1.0, 0.1), act)
            a = angle
            inclined = has_edge & (
                ((a >= EDGE_INCLINATION - 15) & (a <= EDGE_INCLINATION + 15))
                | ((a >= EDGE_INCLINATION + 75)
                   & (a <= EDGE_INCLINATION + 105)))
        avg = float(act.mean())
        avg2 = float((act * act).mean())
        s_norm = strength * avg
        avg_c = avg - 0.5 * (avg2 - modeTwoConst) / max(avg, 1e-9)
        off = s_norm * (act - avg_c)
        if mode == 3:
            off = off + strength * (1.0 - modeTwoConst
                                    / np.maximum(act * act, 1e-9))
        elif mode == 4 and inclined is not None:
            boosted = (s_norm + AQ_EDGE_BIAS) * (act - avg_c)
            off = np.where(inclined & (act - avg_c > 0), boosted, off)
    else:
        off = (strength * 1.0397) * (
            np.log2(np.maximum(energy, 1.0))
            - (modeOneConst + 2 * (bit_depth - 8)))
    if hdr10_opt:
        # HDR10 luma-banded QP biasing (slicetype.cpp:645 bHDR10Opt):
        # darker blocks get coarser QPs, brighter blocks finer (PQ
        # curve perceptual weighting); thresholds are 10-bit codewords
        ls = yp.astype(np.int64)
        if bit_depth == 8:
            ls = ls << 2
        lum = ls.reshape(ph // S, S, pw // S, S).mean(axis=(1, 3))
        adj = np.zeros_like(off)
        for lo, hi, d in ((0, 301, 3), (301, 367, 2), (367, 434, 1),
                          (501, 567, -1), (567, 634, -2), (634, 701, -3),
                          (701, 767, -4), (767, 1024, -5)):
            adj = np.where((lum >= lo) & (lum < hi), float(d), adj)
        off = off + adj
    return off


def aq_qp_offsets(y: np.ndarray, ctb_log2: int, mode: int,
                  strength: float, cb=None, cr=None, bit_depth: int = 8,
                  qg_log2: int | None = None,
                  hdr10_opt: bool = False, device=None) -> np.ndarray:
    """Per-QG FLOAT qp offsets for one frame ([qy, qx], QG = 1<<qg_log2,
    default QG == CTB). The caller adds cuTree/ROI floats and rounds
    once (x265 keeps qpAqOffset as double until calcQpForCu).
    device=None means the CUDA device."""
    ctb = 1 << ctb_log2
    qg = ctb if qg_log2 is None else (1 << qg_log2)
    H, W = y.shape
    if cb is None:
        cb = np.full((H // 2, W // 2), 1 << (bit_depth - 1), np.int16)
    if cr is None:
        cr = cb
    off = aq_field(y, cb, cr, mode, strength, qg_size=qg,
                   bit_depth=bit_depth, hdr10_opt=hdr10_opt, device=device)
    S = 8 if qg == 8 else 16
    r = max(1, qg // S)
    qy, qx = -(-H // qg), -(-W // qg)
    pad_y = qy * r - off.shape[0]
    pad_x = qx * r - off.shape[1]
    if pad_y or pad_x:
        off = np.pad(off, ((0, pad_y), (0, pad_x)), mode="edge")
    return off.reshape(qy, r, qx, r).mean(axis=(1, 3))
