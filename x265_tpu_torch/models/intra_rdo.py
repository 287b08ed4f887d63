"""Recon-in-the-loop RD promotion of intra CUs to 32x32.

x265 analog: Analysis::compressIntraCU recurses depths 0..3 with full
per-depth RDO (analysis.cpp:514) via Search::estIntraPredQT
(search.cpp:1509): a 35-mode SATD scan builds a candidate list, each
candidate is fully coded (predict, transform, quantize, reconstruct)
and the cheapest tree level wins. The base analysis tops out at 16x16
(models/intra_frame.py); on flat/gradient content four 16-CU mode
signals + four small TBs are a pure syntax floor vs one 32 CU with one
32x32 TB.

Every eligible 32-aligned group of the frame is evaluated in one batched
device pass. Predictions come from the linear intra operator bank
(ops/intra_matrix.py) with source-pixel neighbors — the same
decision-only approximation the 16x16 analysis uses (the CABAC writer
re-derives normative predictions from recon neighbors, so any outcome is
a legal bitstream). The bank's weights are dyadic fractions, so its
products with 8-bit samples are exact in float32 in any summation order.

Cost domain matches models/rdo.py: 32*SSE + lam_full[qp] * (rate bits
+ syntax-bit estimates) + sqrt(32*lam)*psy_rd*|energy diff|, summed over
all three planes (chroma rides DM mode).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from x265_tpu_torch.models.inter_residual import gather_src_blocks
from x265_tpu_torch.models.intra_frame import _hadamard, first_argmin
from x265_tpu_torch.models.rdo import (_chroma_qp_vec, _lam_full, _rd_cost,
                                       _tb_costs)
from x265_tpu_torch.ops.intra_matrix import intra_weight_matrices
from x265_tpu_torch.utils import profiling
from x265_tpu_torch.utils.device import resolve_device

# static syntax estimates (bin-count scale, see models/rdo.py):
# per-CU overhead (skip/pred_mode/part/cbf bins) and the split flag
INTRA_CU_OH = 5.0
SPLIT_BIN = 1.0


def _mode_bits(m):
    """Approximate mode-signalling bins: planar/DC often hit the MPM
    list (x265 codes MPM idx in 1-2 EP bins), angular modes usually pay
    the 5-bin rem_intra_luma_pred_mode path."""
    m = np.asarray(m)
    return np.where(m == 0, 2.0, np.where(m == 1, 3.0, 7.0)) \
        .astype(np.float32)


def _refs_of(plane_p, x0, y0, s):
    """Reference vectors [N, 4s+1] for blocks at (x0, y0) of a padded
    plane (1 left/top, 2s right/bottom edge pad). Layout matches
    ops.ref.intra / intra_weight_matrices: left bottom-up, corner, top.
    Slice origins clamp into the plane (dynamic_slice semantics)."""
    Hp, Wp = plane_p.shape
    x0 = x0.long()
    y0 = y0.long()
    offs = torch.arange(2 * s, device=plane_p.device)
    ty = y0.clamp(0, Hp - 1)
    tx = (x0 + 1).clamp(0, Wp - 2 * s)
    top = plane_p[ty[:, None], tx[:, None] + offs[None, :]]
    ly = (y0 + 1).clamp(0, Hp - 2 * s)
    lx = x0.clamp(0, Wp - 1)
    left = plane_p[ly[:, None] + offs[None, :], lx[:, None]]
    corner = plane_p[y0.clamp(0, Hp - 1), x0.clamp(0, Wp - 1)]
    return torch.cat([left.flip(1), corner[:, None], top], dim=1)


def _blks(plane, xv, yv, s):
    """[N, s, s] int32 tiles of an int16 plane (the gather kernel)."""
    return gather_src_blocks(plane, yv, xv, s)


def _satd8(resid):
    """SATD over 8x8 tiles of [..., S, S] float residuals: a float32
    Hadamard and one /4 at the end."""
    S = resid.shape[-1]
    h = torch.from_numpy(_hadamard(8).astype(np.float32)).to(resid.device)
    r = resid.reshape(resid.shape[:-2] + (S // 8, 8, S // 8, 8))
    r = r.transpose(-3, -2)
    t = torch.matmul(torch.matmul(h, r), h)
    return t.abs().sum(dim=(-1, -2, -3, -4)) / 4.0


@lru_cache(maxsize=8)
def _bank(S: int, c_idx: int, device: str) -> torch.Tensor:
    """[35*S*S, 4S+1] float32 prediction bank on the device."""
    Wm = np.asarray(intra_weight_matrices(S, c_idx=c_idx), np.float32)
    return torch.from_numpy(np.ascontiguousarray(
        Wm.reshape(35 * S * S, -1))).to(device)


def _preds35(refs, S, c_idx):
    """All 35 float32 predictions [G, 35, S*S] of reference vectors."""
    W = _bank(S, c_idx, str(refs.device))
    return torch.matmul(refs, W.t()).reshape(refs.shape[0], 35, S * S)


def _pick(preds, modes):
    """preds [G, 35, P], modes [G, K] -> [G, K, P]."""
    return torch.gather(preds, 1, modes.long()[:, :, None].expand(
        -1, -1, preds.shape[2]))


def _intra32_costs(y, cb, cr, xy, m4, mbits4, qp, rk,
                   bd, sdh, do_rdoq, scaling, cb_off, cr_off, psy=0.0):
    """RD costs of G candidate 32x32 intra regions:
    ONE 32-CU (best of seven candidate modes: planar, DC, the four
    sub-CU modes and the group's own 35-mode SATD winner) vs FOUR 16-CUs
    at their analysed modes.

    y/cb/cr: int16 source planes on the device; xy [G,2] (x0,y0) luma
    coords; m4 [G,4] z-order sub-block modes; mbits4 [G] summed sub-mode
    bins; qp [G]. Returns (cost_one [G], mode_one [G], cost_four [G])."""
    from x265_tpu_torch.engine.planes import pad_dev
    G = xy.shape[0]
    S = 32
    maxv = (1 << bd) - 1
    x0, y0 = xy[:, 0], xy[:, 1]
    dev = xy.device

    yp = pad_dev(y, (1, 2 * S, 1, 2 * S), torch.float32)
    cbp = pad_dev(cb, (1, S, 1, S), torch.float32)
    crp = pad_dev(cr, (1, S, 1, S), torch.float32)

    qpy = qp + 6 * (bd - 8)
    # estBit rates are real bits -> full lambda2 (rate_model.py)
    lam = _lam_full(qpy)
    psylam = torch.sqrt(32.0 * lam) * psy
    qpc_cb = _chroma_qp_vec(qp, bd, cb_off) + 6 * (bd - 8)
    qpc_cr = _chroma_qp_vec(qp, bd, cr_off) + 6 * (bd - 8)

    def tb_cost(src, pred, qvec, size, want_psy, krow):
        """(sse, rate_bits, psy) of TBs coded from float predictions."""
        predi = torch.round(pred).clamp(0, maxv).to(torch.int32)
        return _tb_costs(src, predi, qvec, krow, size, True, want_psy, bd,
                         sdh, do_rdoq, scaling)

    # ---- ONE 32-CU: all-35 prediction bank, SATD-shortlist K candidates,
    # full T/Q/recon cost on each, min wins -------------------------------
    preds35 = _preds35(_refs_of(yp, x0, y0, S), S, 0)     # [G,35,S*S]
    src32 = _blks(y, x0, y0, S)                           # [G,S,S]
    satd = _satd8(preds35.reshape(G, 35, S, S)
                  - src32.to(torch.float32)[:, None])     # [G,35]
    mb35 = torch.from_numpy(_mode_bits(np.arange(35))).to(dev)
    best35 = first_argmin(satd + lam[:, None] * mb35[None, :], 1)
    cand = torch.cat(
        [torch.zeros((G, 1), dtype=torch.int32, device=dev),   # planar
         torch.ones((G, 1), dtype=torch.int32, device=dev),    # DC
         m4.to(torch.int32),                                   # the subs'
         best35.to(torch.int32)[:, None]], dim=1)              # SATD winner
    K = cand.shape[1]
    pred1 = _pick(preds35, cand).reshape(G * K, S, S)
    sse1, rate1, psy1 = tb_cost(
        src32.repeat_interleave(K, 0), pred1, qpy.repeat_interleave(K), S,
        psy > 0, rk[0])

    # chroma (DM = candidate luma mode): 16x16 TBs
    xc, yc = x0 >> 1, y0 >> 1
    for (plane_p, plane, qv) in ((cbp, cb, qpc_cb), (crp, cr, qpc_cr)):
        cpred = _pick(_preds35(_refs_of(plane_p, xc, yc, 16), 16, 1), cand)
        csrc = _blks(plane, xc, yc, 16)
        sc, rc, _pc = tb_cost(csrc.repeat_interleave(K, 0),
                              cpred.reshape(G * K, 16, 16),
                              qv.repeat_interleave(K), 16, False, rk[1])
        sse1 = sse1 + sc
        rate1 = rate1 + rc

    mbits1 = mb35[cand.long()].reshape(G * K)
    cost1 = _rd_cost(sse1, lam.repeat_interleave(K),
                     rate1 + INTRA_CU_OH + mbits1,
                     psylam.repeat_interleave(K), psy1).reshape(G, K)
    ksel = first_argmin(cost1, 1)
    cost_one = torch.gather(cost1, 1, ksel[:, None])[:, 0]
    mode_one = torch.gather(cand, 1, ksel[:, None])[:, 0]

    # ---- FOUR 16-CUs at their analysed modes ----------------------------
    qq = torch.arange(4, dtype=torch.int32, device=dev)
    x4 = (x0[:, None] + (qq % 2)[None, :] * 16).reshape(-1)
    y4 = (y0[:, None] + (qq // 2)[None, :] * 16).reshape(-1)
    m4f = m4.reshape(-1, 1).to(torch.int32)
    pred4 = _pick(_preds35(_refs_of(yp, x4, y4, 16), 16, 0), m4f)
    src16 = _blks(y, x4, y4, 16)
    sse4, rate4, psy4 = tb_cost(src16, pred4.reshape(-1, 16, 16),
                                qpy.repeat_interleave(4), 16, psy > 0,
                                rk[0])
    for (plane_p, plane, qv) in ((cbp, cb, qpc_cb), (crp, cr, qpc_cr)):
        cpred = _pick(_preds35(_refs_of(plane_p, x4 >> 1, y4 >> 1, 8), 8,
                               1), m4f)
        csrc = _blks(plane, x4 >> 1, y4 >> 1, 8)
        sc, rc, _pc = tb_cost(csrc, cpred.reshape(-1, 8, 8),
                              qv.repeat_interleave(4), 8, False, rk[1])
        sse4 = sse4 + sc
        rate4 = rate4 + rc

    sse4 = sse4.reshape(G, 4).sum(dim=1)
    rate4 = rate4.reshape(G, 4).sum(dim=1)
    psy4 = psy4.reshape(G, 4).sum(dim=1)
    cost_four = _rd_cost(sse4, lam,
                         rate4 + 4 * INTRA_CU_OH + SPLIT_BIN + mbits4,
                         psylam, psy4)
    return cost_one, mode_one.to(torch.int32), cost_four


def rd_intra_promote32(frame, dec, qp, p, min_groups=1, init_type=0,
                       device=None):
    """Promote eligible 2x2 groups of 16x16 intra CUs to one 32x32 intra
    CU where the recon-in-loop RD cost wins (mutates dec in place;
    returns the number of promoted groups).

    Eligible: 32-aligned, fully inside the picture, all sixteen 8-cells
    at cu_log2_map == 4 and intra (inter8 None or False)."""
    from x265_tpu_torch.hevc.rate_model import rdoq_rate_consts
    from x265_tpu_torch.utils import devcache
    dev = resolve_device(device)
    if p.ctb_log2 < 5 or p.lossless:
        return 0
    h8, w8 = dec.cu_log2_map.shape
    h32, w32 = h8 // 4, w8 // 4
    if h32 == 0 or w32 == 0:
        return 0

    def grp(m):
        t = m[:h32 * 4, :w32 * 4]
        t = t.reshape(h32, 4, w32, 4, *m.shape[2:])
        return np.moveaxis(t, 1, 2).reshape(h32, w32, 16, *m.shape[2:])

    elig = (grp(dec.cu_log2_map) == 4).all(axis=2)
    if dec.inter8 is not None:
        elig &= ~grp(dec.inter8.astype(bool)).any(axis=2)
    # fully inside (partial edge groups keep the finer tree)
    ys32 = np.arange(h32) * 32
    xs32 = np.arange(w32) * 32
    elig &= ((ys32[:, None] + 32) <= p.height) \
        & ((xs32[None, :] + 32) <= p.width)
    if not elig.any():
        return 0
    ys, xs = np.nonzero(elig)
    G = len(ys)
    # z-order sub modes from the 8-block corners of each 16 sub-CU
    modes = grp(dec.luma_mode8)
    sub = np.array([0, 2, 8, 10])
    m4 = modes[ys, xs][:, sub].astype(np.int32)           # [G,4]
    mbits4 = _mode_bits(m4).sum(axis=1).astype(np.float32)

    def t32(a):
        return torch.from_numpy(np.array(a, np.int32)).to(dev)

    xy = np.stack([xs * 32, ys * 32], 1)
    c1, mode1, c4 = _intra32_costs(
        *(devcache.src_plane(np.asarray(pl), p.bit_depth, dev)
          for pl in frame),
        t32(xy), t32(m4), torch.from_numpy(mbits4).to(dev),
        t32(np.full(G, int(qp))), t32(rdoq_rate_consts(init_type, int(qp))),
        bd=p.bit_depth, sdh=bool(p.sign_hide),
        do_rdoq=p.rdoq_level > 0, scaling=bool(p.scaling_lists),
        cb_off=int(p.cb_qp_offset), cr_off=int(p.cr_qp_offset),
        psy=round(float(getattr(p, "psy_rd", 0.0)), 2))
    promote = (c1 <= c4).cpu().numpy()
    mode1 = mode1.cpu().numpy()
    n = int(promote.sum())
    profiling.count("rd.intra32.tried", G)
    if n < min_groups:
        return 0
    profiling.count("rd.intra32.won", n)
    for gy, gx, m in zip(ys[promote], xs[promote], mode1[promote]):
        dec.cu_log2_map[gy * 4:gy * 4 + 4, gx * 4:gx * 4 + 4] = 5
        dec.luma_mode8[gy * 4:gy * 4 + 4, gx * 4:gx * 4 + 4] = int(m)
        if dec.chroma_mode8 is not None:
            dec.chroma_mode8[gy * 4:gy * 4 + 4, gx * 4:gx * 4 + 4] = int(m)
        if getattr(dec, "nxn8", None) is not None:
            dec.nxn8[gy * 4:gy * 4 + 4, gx * 4:gx * 4 + 4] = False
    return n
