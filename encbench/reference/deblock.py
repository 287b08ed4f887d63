"""HEVC deblocking filter (spec 8.7.2; x265 analog common/deblock.cpp:37-571
``deblockCTU``/``edgeFilterLuma``/``edgeFilterChroma`` and the per-row loop
framefilter.cpp:564).

Design (SURVEY.md §7.1): x265 filters CTU-by-CTU inside the wavefront; here
the whole frame's edges of one direction are *independent* (vertical edges
are 8 luma samples apart, each filter touches <=4 samples per side), so the
filter is two fully-vectorized passes — all vertical edges, then all
horizontal edges — expressed as dense array ops that map 1:1 onto jnp for
the TPU path.

State model: per-4x4-block maps (the CUData analog) —
  edge_v/edge_h : transform/prediction-block boundary flags
  cbf4          : luma cbf of the TU covering the block
  bypass4       : cu_transquant_bypass (lossless CUs are not filtered)
  is_intra4, mv4, ref4 : for boundary-strength derivation (8.7.2.4)
Uniform slice QP for now (per-CU QP maps plug in where `qp` is used).

Limitation: a single edge-flag map serves both TU edges (cbf term) and PU
edges (MV term) of the bS derivation — exact while partitions are 2Nx2N
(TU boundary set == PU boundary set), revisit with rect/AMP partitions.
"""
from __future__ import annotations

import numpy as np

from encbench.reference.tables import chroma_qp

# Table 8-12 (spec) / HM sm_betaTable, sm_tcTable
BETA_TABLE = np.array(
    [0] * 16 +
    [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28,
     30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64],
    dtype=np.int32)
TC_TABLE = np.array(
    [0] * 18 +
    [1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5,
     6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24],
    dtype=np.int32)


class DeblockState:
    """Per-picture boundary/cbf/bypass maps at 4x4 granularity, filled by
    the syntax writer or decoder as CUs/TUs are processed."""

    def __init__(self, height: int, width: int):
        h4, w4 = (height + 3) // 4, (width + 3) // 4
        self.edge_v = np.zeros((h4, w4), dtype=bool)
        self.edge_h = np.zeros((h4, w4), dtype=bool)
        self.cbf4 = np.zeros((h4, w4), dtype=bool)
        self.bypass4 = np.zeros((h4, w4), dtype=bool)

    def mark_block(self, x0: int, y0: int, size: int) -> None:
        """Mark the left/top boundaries of a TU/PU/CU."""
        self.edge_v[y0 >> 2:(y0 + size) >> 2, x0 >> 2] = True
        self.edge_h[y0 >> 2, x0 >> 2:(x0 + size) >> 2] = True

    def set_tu(self, x0: int, y0: int, size: int, cbf_luma: bool,
               bypass: bool) -> None:
        s = (slice(y0 >> 2, (y0 + size) >> 2),
             slice(x0 >> 2, (x0 + size) >> 2))
        self.cbf4[s] = cbf_luma
        self.bypass4[s] = bypass


NOPOC = -(1 << 20)   # sentinel POC for an unused reference list


def derive_bs(edge: np.ndarray, is_intra4: np.ndarray, cbf4: np.ndarray,
              mv4: np.ndarray, refpoc4: np.ndarray,
              vertical: bool) -> np.ndarray:
    """Boundary strength per 4x4 edge segment (spec 8.7.2.4; x265
    getBoundaryStrength deblock.cpp:191). Returns [h4, w4] int array:
    bS of the edge at the left (vertical) / top (horizontal) of each block.

    mv4 [h4,w4,2(list),2(xy)] quarter-pel; refpoc4 [h4,w4,2] POC of the
    reference picture per list, NOPOC where the list is unused. The MV
    term compares reference *pictures* and handles the bi-pred
    both-orderings rule.
    """
    ax = 1 if vertical else 0
    q_intra = is_intra4
    p_intra = np.roll(is_intra4, 1, axis=ax)
    q_cbf = cbf4
    p_cbf = np.roll(cbf4, 1, axis=ax)

    qmv, pmv = mv4, np.roll(mv4, 1, axis=ax)
    qpoc, ppoc = refpoc4, np.roll(refpoc4, 1, axis=ax)
    q_used = qpoc != NOPOC
    p_used = ppoc != NOPOC
    q_n = q_used.sum(-1)
    p_n = p_used.sum(-1)

    # uni-pred sides: collapse to the single used list
    def _uni(poc, mv, used):
        sel = np.where(used[..., 0:1], poc[..., 0:1], poc[..., 1:2])[..., 0]
        selmv = np.where(used[..., 0:1, None], mv[..., 0:1, :],
                         mv[..., 1:2, :])[..., 0, :]
        return sel, selmv

    p1poc, p1mv = _uni(ppoc, pmv, p_used)
    q1poc, q1mv = _uni(qpoc, qmv, q_used)
    uni_bs1 = (p1poc != q1poc) | \
        (np.abs(p1mv - q1mv).max(-1) >= 4)

    # bi-pred sides: straight and crossed matchings
    def _match(pi, qi, pj, qj):
        refs_ok = (ppoc[..., pi] == qpoc[..., qi]) & \
                  (ppoc[..., pj] == qpoc[..., qj])
        mv_ok = (np.abs(pmv[..., pi, :] - qmv[..., qi, :]).max(-1) < 4) & \
                (np.abs(pmv[..., pj, :] - qmv[..., qj, :]).max(-1) < 4)
        return refs_ok & mv_ok
    bi_ok = _match(0, 0, 1, 1) | _match(0, 1, 1, 0)

    both_uni = (p_n == 1) & (q_n == 1)
    both_bi = (p_n == 2) & (q_n == 2)
    mv_bs1 = np.where(both_uni, uni_bs1,
                      np.where(both_bi, ~bi_ok, True))  # count mismatch -> 1

    bs = np.where(p_intra | q_intra, 2,
                  np.where(p_cbf | q_cbf | mv_bs1, 1, 0))
    bs = np.where(edge, bs, 0)
    # picture boundary: no edge at x==0 / y==0
    if vertical:
        bs[:, 0] = 0
    else:
        bs[0, :] = 0
    return bs.astype(np.int32)


def _filter_luma_vertical(y: np.ndarray, bs4: np.ndarray, qp,
                          beta_off: int, tc_off: int,
                          bypass4: np.ndarray, bd: int) -> np.ndarray:
    """Filter all vertical luma edges of the plane (in place on a copy).

    bs4[y4, x4] is the bS of the 4-row segment at luma column x4*4; only
    columns on the 8-sample grid (x4 even) are edges (8.7.2.2).
    qp: scalar slice QP or a per-4x4 QP map [h4, w4] (cu_qp_delta); the
    edge QP is the p/q average (8.7.2.5.3 qPL).
    """
    H, W = y.shape
    if W < 16:
        return y
    cols4 = np.arange(2, W // 4, 2)          # 4x4-block cols on the 8-grid, >0
    xs = cols4 * 4                            # luma edge x positions
    nE = len(xs)
    H4 = H // 4
    y = y.astype(np.int32)

    # gather p3..p0 / q0..q3 for every edge: [H, nE, 4]
    pi = xs[:, None] + np.arange(-4, 0)[None, :]
    qi = xs[:, None] + np.arange(0, 4)[None, :]
    P = y[:, pi].reshape(H4, 4, nE, 4)
    Q = y[:, qi].reshape(H4, 4, nE, 4)

    bs = bs4[:, cols4]                                   # [H4, nE]
    if np.isscalar(qp) or np.ndim(qp) == 0:
        qpl = np.full((H4, nE), int(qp), dtype=np.int32)
    else:
        qpl = ((qp[:, cols4 - 1] + qp[:, cols4] + 1) >> 1).astype(np.int32)
    qb = np.clip(qpl + (beta_off << 1), 0, 51)
    beta = (BETA_TABLE[qb] << (bd - 8)).astype(np.int32)  # [H4, nE]
    tq = np.clip(qpl + 2 * (bs - 1) + (tc_off << 1), 0, 53)
    tc = (TC_TABLE[tq] << (bd - 8)).astype(np.int32)     # [H4, nE]

    # decision on segment lines 0 and 3 (8.7.2.5.3)
    dp = np.abs(P[:, :, :, 1] - 2 * P[:, :, :, 2] + P[:, :, :, 3])
    dq = np.abs(Q[:, :, :, 2] - 2 * Q[:, :, :, 1] + Q[:, :, :, 0])
    dp0, dp3 = dp[:, 0], dp[:, 3]
    dq0, dq3 = dq[:, 0], dq[:, 3]
    d = dp0 + dp3 + dq0 + dq3
    do_filter = (bs > 0) & (d < beta) & (tc > 0)

    def _strong_line(k):
        sp = np.abs(P[:, k, :, 0] - P[:, k, :, 3])
        sq = np.abs(Q[:, k, :, 0] - Q[:, k, :, 3])
        pq = np.abs(P[:, k, :, 3] - Q[:, k, :, 0])
        return ((2 * (dp[:, k] + dq[:, k]) < (beta >> 2)) &
                (sp + sq < (beta >> 3)) & (pq < ((5 * tc + 1) >> 1)))

    strong = do_filter & _strong_line(0) & _strong_line(3)
    weak = do_filter & ~strong
    dEp1 = (dp0 + dp3) < ((beta + (beta >> 1)) >> 3)
    dEq1 = (dq0 + dq3) < ((beta + (beta >> 1)) >> 3)

    # broadcast segment masks to all 4 lines: [H4, 4, nE]
    def b4(a):
        return np.broadcast_to(a[:, None, :], (H4, 4, nE))

    tc4 = b4(tc)
    strong4, weak4 = b4(strong), b4(weak)

    p3, p2, p1, p0 = (P[:, :, :, i] for i in range(4))
    q0, q1, q2, q3 = (Q[:, :, :, i] for i in range(4))
    maxv = (1 << bd) - 1

    def clip3(lo, hi, v):
        return np.minimum(np.maximum(v, lo), hi)

    # strong filter (8.7.2.5.7, dE==2)
    sp0 = clip3(p0 - 2 * tc4, p0 + 2 * tc4,
                (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3)
    sp1 = clip3(p1 - 2 * tc4, p1 + 2 * tc4, (p2 + p1 + p0 + q0 + 2) >> 2)
    sp2 = clip3(p2 - 2 * tc4, p2 + 2 * tc4,
                (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3)
    sq0 = clip3(q0 - 2 * tc4, q0 + 2 * tc4,
                (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3)
    sq1 = clip3(q1 - 2 * tc4, q1 + 2 * tc4, (p0 + q0 + q1 + q2 + 2) >> 2)
    sq2 = clip3(q2 - 2 * tc4, q2 + 2 * tc4,
                (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3)

    # weak filter (dE==1)
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    wactive = weak4 & (np.abs(delta) < 10 * tc4)
    d1 = clip3(-tc4, tc4, delta)
    wp0 = np.clip(p0 + d1, 0, maxv)
    wq0 = np.clip(q0 - d1, 0, maxv)
    tch = tc4 >> 1
    dpv = clip3(-tch, tch, (((p2 + p0 + 1) >> 1) - p1 + d1) >> 1)
    wp1 = np.clip(p1 + dpv, 0, maxv)
    dqv = clip3(-tch, tch, (((q2 + q0 + 1) >> 1) - q1 - d1) >> 1)
    wq1 = np.clip(q1 + dqv, 0, maxv)
    wEp1 = wactive & b4(dEp1)
    wEq1 = wactive & b4(dEq1)

    np0 = np.where(strong4, sp0, np.where(wactive, wp0, p0))
    np1 = np.where(strong4, sp1, np.where(wEp1, wp1, p1))
    np2 = np.where(strong4, sp2, p2)
    nq0 = np.where(strong4, sq0, np.where(wactive, wq0, q0))
    nq1 = np.where(strong4, sq1, np.where(wEq1, wq1, q1))
    nq2 = np.where(strong4, sq2, q2)

    # cu_transquant_bypass: suppress the side whose CU is bypassed (8.7.2)
    byp_p = b4(bypass4[:, cols4 - 1])
    byp_q = b4(bypass4[:, cols4])
    np0 = np.where(byp_p, p0, np0)
    np1 = np.where(byp_p, p1, np1)
    np2 = np.where(byp_p, p2, np2)
    nq0 = np.where(byp_q, q0, nq0)
    nq1 = np.where(byp_q, q1, nq1)
    nq2 = np.where(byp_q, q2, nq2)

    out = y.copy()
    newP = np.stack([P[:, :, :, 0], np2, np1, np0], axis=-1).reshape(H, nE, 4)
    newQ = np.stack([nq0, nq1, nq2, Q[:, :, :, 3]], axis=-1).reshape(H, nE, 4)
    out[:, pi] = newP
    out[:, qi] = newQ
    return out


def _filter_chroma_vertical(c: np.ndarray, bs4: np.ndarray, qp_c,
                            tc_off: int, bypass4: np.ndarray,
                            bd: int, lut=None) -> np.ndarray:
    """Filter all vertical chroma edges (bS==2 only; 8.7.2.5.5).

    c is one chroma plane [Hc, Wc]; edges at chroma x multiple of 8
    (luma 16). bs4/bypass4 are the *luma* 4x4-granularity maps.
    qp_c: scalar chroma QP, or the per-4x4 *luma* QP map together with
    `lut` mapping averaged luma QP -> chroma QP (8.7.2.5.5 QpC order:
    average first, then the chroma table).
    """
    Hc, Wc = c.shape
    if Wc < 16:
        return c
    xs = np.arange(8, Wc, 8)                 # chroma edge columns
    nE = len(xs)
    Hc4 = Hc // 4
    c = c.astype(np.int32)

    # bS of a 4-chroma-row segment at (seg s, chroma col xc): luma block
    # (row 2s, col xc*2/4 = xc>>1)
    bs = bs4[::2, :][:Hc4, (xs >> 1)]        # [Hc4, nE]
    mask_seg = bs == 2

    if np.isscalar(qp_c) or np.ndim(qp_c) == 0:
        qpl = np.full((Hc4, nE), int(qp_c), dtype=np.int32)
    else:
        qgrid = qp_c[::2, :][:Hc4]
        qpl = ((qgrid[:, (xs >> 1) - 1] + qgrid[:, (xs >> 1)] + 1) >> 1)
        qpl = lut[np.clip(qpl, 0, 51)]
    tq = np.clip(qpl + 2 + (tc_off << 1), 0, 53)
    tc = (TC_TABLE[tq] << (bd - 8)).astype(np.int32)     # [Hc4, nE]
    if not (tc > 0).any():
        return c

    pi = xs[:, None] + np.arange(-2, 0)[None, :]
    qi = xs[:, None] + np.arange(0, 2)[None, :]
    P = c[:, pi].reshape(Hc4, 4, nE, 2)
    Q = c[:, qi].reshape(Hc4, 4, nE, 2)
    p1, p0 = P[:, :, :, 0], P[:, :, :, 1]
    q0, q1 = Q[:, :, :, 0], Q[:, :, :, 1]

    tc3 = tc[:, None, :]
    delta = np.clip((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc3, tc3)
    maxv = (1 << bd) - 1
    m = np.broadcast_to(mask_seg[:, None, :], (Hc4, 4, nE))
    byp_p = np.broadcast_to(bypass4[::2, :][:Hc4, (xs >> 1) - 1][:, None, :],
                            (Hc4, 4, nE))
    byp_q = np.broadcast_to(bypass4[::2, :][:Hc4, (xs >> 1)][:, None, :],
                            (Hc4, 4, nE))
    np0 = np.where(m & ~byp_p, np.clip(p0 + delta, 0, maxv), p0)
    nq0 = np.where(m & ~byp_q, np.clip(q0 - delta, 0, maxv), q0)

    out = c.copy()
    out[:, xs - 1] = np0.reshape(Hc, nE)
    out[:, xs] = nq0.reshape(Hc, nE)
    return out


def deblock_frame(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                  st: DeblockState, is_intra4: np.ndarray,
                  mv4: np.ndarray, refpoc4: np.ndarray, qp: int,
                  beta_off: int = 0, tc_off: int = 0,
                  cb_qp_off: int = 0, cr_qp_off: int = 0, bd: int = 8):
    """Full-frame deblock: vertical edges first, then horizontal (8.7.2.1).

    Returns new (y, cb, cr) int32 planes.
    """
    if mv4 is None:
        mv4 = np.zeros((*is_intra4.shape, 2, 2), dtype=np.int32)
    if refpoc4 is None:
        refpoc4 = np.full((*is_intra4.shape, 2), NOPOC, dtype=np.int64)

    bs_v = derive_bs(st.edge_v, is_intra4, st.cbf4, mv4, refpoc4,
                     vertical=True)
    bs_h = derive_bs(st.edge_h, is_intra4, st.cbf4, mv4, refpoc4,
                     vertical=False)

    # deblock QpC stays in the 0..51 domain (8.7.2.5.5): the chroma table
    # WITHOUT the QpBdOffset that quantization's Qp'C carries
    def _qpc_tab(qpl, off):
        from encbench.reference.tables import CHROMA_QP_TABLE
        q = min(max(0, qpl + off), 57)
        return int(CHROMA_QP_TABLE[q])

    scalar_qp = np.isscalar(qp) or np.ndim(qp) == 0
    if scalar_qp:
        qp_cb = _qpc_tab(int(qp), cb_qp_off)
        qp_cr = _qpc_tab(int(qp), cr_qp_off)
        lut_cb = lut_cr = None
        qp_t = qp
    else:
        lut_cb = np.array([_qpc_tab(q, cb_qp_off) for q in range(52)],
                          dtype=np.int32)
        lut_cr = np.array([_qpc_tab(q, cr_qp_off) for q in range(52)],
                          dtype=np.int32)
        qp_cb = qp_cr = qp          # luma map; chroma funcs apply the LUT
        qp_t = qp.T

    y = _filter_luma_vertical(y, bs_v, qp, beta_off, tc_off, st.bypass4, bd)
    cb1 = _filter_chroma_vertical(cb, bs_v, qp_cb, tc_off, st.bypass4, bd,
                                  lut_cb)
    cr1 = _filter_chroma_vertical(cr, bs_v, qp_cr, tc_off, st.bypass4, bd,
                                  lut_cr)

    # horizontal pass == vertical pass on the transpose
    y = _filter_luma_vertical(y.T, bs_h.T, qp_t, beta_off, tc_off,
                              st.bypass4.T, bd).T
    cb1 = _filter_chroma_vertical(cb1.T, bs_h.T,
                                  qp_cb if scalar_qp else qp_t, tc_off,
                                  st.bypass4.T, bd, lut_cb).T
    cr1 = _filter_chroma_vertical(cr1.T, bs_h.T,
                                  qp_cr if scalar_qp else qp_t, tc_off,
                                  st.bypass4.T, bd, lut_cr).T
    return y, cb1, cr1
