"""Device loop filter: whole-frame deblock (+ SAO statistics) and the SAO
apply, as dense tensor code.

Counterpart of x265_tpu/models/loopfilter.py. The filter math is that of
the numpy reference in hevc/deblock.py (spec 8.7.2; x265 deblock.cpp
pelFilterLumaStrong/pelFilterChroma recast as whole-frame array ops),
and the SAO EO/BO statistics of the deblocked output (sao.cpp:735
calcSaoStatsCTU) are taken right behind it, so the deblocked planes
never leave the device: with keep_device they become the next pictures'
reference and only the statistics are downloaded.

The boundary strengths are derived on the device too, from the 4x4
maps the host builds (ops.cuda_kernels.deblock_bs: one launch for both
directions, csrc/deblock_bs.cu on the card, the plain version on the
CPU); hevc/deblock.derive_bs stays their numpy reference. Only the
compact inputs cross the bus: a flag byte, int16 motion vectors and
int32 reference POCs a block, in one copy from page-locked memory.

All integer, int32 inside and int16 on return: bit-exact against
hevc/deblock.py and against the JAX package
(tests/test_torch_loopfilter.py). Tensors are updated in place only
where the function made them itself.
"""
from __future__ import annotations

import numpy as np
import torch

from x265_tpu_torch.hevc.deblock import BETA_TABLE, TC_TABLE
from x265_tpu_torch.ops.cuda_kernels import deblock_bs, deblock_bs_flags
from x265_tpu_torch.utils.device import resolve_device
from x265_tpu_torch.utils.profiling import scope


def _table(t, dev):
    return torch.from_numpy(np.asarray(t, np.int32)).to(dev)


def _idx(a, dev):
    return torch.from_numpy(np.asarray(a, np.int64)).to(dev)


def _luma_pass(y, bs4, qp4, beta_off, tc_off, bypass4, bd):
    """All vertical luma edges (call on transposed, contiguous planes for
    the horizontal pass). Mirrors _filter_luma_vertical exactly; returns
    a new int32 plane."""
    H, W = y.shape
    if W < 16:
        return y
    dev = y.device
    cols4 = np.arange(2, W // 4, 2)
    xs = cols4 * 4
    nE = len(xs)
    H4 = H // 4
    y = y.to(torch.int32)

    pi = _idx(xs[:, None] + np.arange(-4, 0)[None, :], dev)
    qi = _idx(xs[:, None] + np.arange(0, 4)[None, :], dev)
    c4 = _idx(cols4, dev)
    P = y[:, pi].reshape(H4, 4, nE, 4)
    Q = y[:, qi].reshape(H4, 4, nE, 4)

    bs = bs4[:, c4]
    qpl = (qp4[:, c4 - 1] + qp4[:, c4] + 1) >> 1
    qb = (qpl + (beta_off << 1)).clamp(0, 51)
    beta = _table(BETA_TABLE, dev)[qb.to(torch.int64)] << (bd - 8)
    tq = (qpl + 2 * (bs - 1) + (tc_off << 1)).clamp(0, 53)
    tc = _table(TC_TABLE, dev)[tq.to(torch.int64)] << (bd - 8)

    dp = (P[:, :, :, 1] - 2 * P[:, :, :, 2] + P[:, :, :, 3]).abs()
    dq = (Q[:, :, :, 2] - 2 * Q[:, :, :, 1] + Q[:, :, :, 0]).abs()
    dp0, dp3 = dp[:, 0], dp[:, 3]
    dq0, dq3 = dq[:, 0], dq[:, 3]
    d = dp0 + dp3 + dq0 + dq3
    do_filter = (bs > 0) & (d < beta) & (tc > 0)

    def _strong_line(k):
        sp = (P[:, k, :, 0] - P[:, k, :, 3]).abs()
        sq = (Q[:, k, :, 0] - Q[:, k, :, 3]).abs()
        pq = (P[:, k, :, 3] - Q[:, k, :, 0]).abs()
        return ((2 * (dp[:, k] + dq[:, k]) < (beta >> 2)) &
                (sp + sq < (beta >> 3)) & (pq < ((5 * tc + 1) >> 1)))

    strong = do_filter & _strong_line(0) & _strong_line(3)
    weak = do_filter & ~strong
    dEp1 = (dp0 + dp3) < ((beta + (beta >> 1)) >> 3)
    dEq1 = (dq0 + dq3) < ((beta + (beta >> 1)) >> 3)

    def b4(a):
        return a[:, None, :].expand(H4, 4, nE)

    tc4 = b4(tc)
    strong4, weak4 = b4(strong), b4(weak)

    p3, p2, p1, p0 = (P[:, :, :, i] for i in range(4))
    q0, q1, q2, q3 = (Q[:, :, :, i] for i in range(4))
    maxv = (1 << bd) - 1

    def clip3(lo, hi, v):
        return torch.minimum(torch.maximum(v, lo), hi)

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

    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    wactive = weak4 & (delta.abs() < 10 * tc4)
    d1 = clip3(-tc4, tc4, delta)
    wp0 = (p0 + d1).clamp(0, maxv)
    wq0 = (q0 - d1).clamp(0, maxv)
    tch = tc4 >> 1
    dpv = clip3(-tch, tch, (((p2 + p0 + 1) >> 1) - p1 + d1) >> 1)
    wp1 = (p1 + dpv).clamp(0, maxv)
    dqv = clip3(-tch, tch, (((q2 + q0 + 1) >> 1) - q1 - d1) >> 1)
    wq1 = (q1 + dqv).clamp(0, maxv)
    wEp1 = wactive & b4(dEp1)
    wEq1 = wactive & b4(dEq1)

    np0 = torch.where(strong4, sp0, torch.where(wactive, wp0, p0))
    np1 = torch.where(strong4, sp1, torch.where(wEp1, wp1, p1))
    np2 = torch.where(strong4, sp2, p2)
    nq0 = torch.where(strong4, sq0, torch.where(wactive, wq0, q0))
    nq1 = torch.where(strong4, sq1, torch.where(wEq1, wq1, q1))
    nq2 = torch.where(strong4, sq2, q2)

    byp_p = b4(bypass4[:, c4 - 1])
    byp_q = b4(bypass4[:, c4])
    np0 = torch.where(byp_p, p0, np0)
    np1 = torch.where(byp_p, p1, np1)
    np2 = torch.where(byp_p, p2, np2)
    nq0 = torch.where(byp_q, q0, nq0)
    nq1 = torch.where(byp_q, q1, nq1)
    nq2 = torch.where(byp_q, q2, nq2)

    newP = torch.stack([P[:, :, :, 0], np2, np1, np0],
                       dim=-1).reshape(H, nE, 4)
    newQ = torch.stack([nq0, nq1, nq2, Q[:, :, :, 3]],
                       dim=-1).reshape(H, nE, 4)
    # P, Q and everything derived were gathered (copies) before this
    # point, so writing into a clone cannot feed back into the filter
    out = y.clone()
    out[:, pi] = newP
    out[:, qi] = newQ
    return out


def _chroma_pass(c, bs4, qp4, lut, tc_off, bypass4, bd):
    """All vertical chroma edges (bS==2 only); mirrors
    _filter_chroma_vertical with the qp-map+LUT path."""
    Hc, Wc = c.shape
    if Wc < 16:
        return c
    dev = c.device
    xs = np.arange(8, Wc, 8)
    nE = len(xs)
    Hc4 = Hc // 4
    c = c.to(torch.int32)
    e = _idx(xs >> 1, dev)

    bs = bs4[::2, :][:Hc4][:, e]
    mask_seg = bs == 2
    qgrid = qp4[::2, :][:Hc4]
    qpl = (qgrid[:, e - 1] + qgrid[:, e] + 1) >> 1
    qpl = lut[qpl.clamp(0, 51).to(torch.int64)]
    tq = (qpl + 2 + (tc_off << 1)).clamp(0, 53)
    tc = _table(TC_TABLE, dev)[tq.to(torch.int64)] << (bd - 8)

    xi = _idx(xs, dev)
    p1 = c[:, xi - 2].reshape(Hc4, 4, nE)
    p0 = c[:, xi - 1].reshape(Hc4, 4, nE)
    q0 = c[:, xi].reshape(Hc4, 4, nE)
    q1 = c[:, xi + 1].reshape(Hc4, 4, nE)

    tc3 = tc[:, None, :]
    delta = torch.minimum(torch.maximum(
        (((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc3), tc3)
    maxv = (1 << bd) - 1
    m = mask_seg[:, None, :].expand(Hc4, 4, nE)
    byp = bypass4[::2, :][:Hc4]
    byp_p = byp[:, e - 1][:, None, :].expand(Hc4, 4, nE)
    byp_q = byp[:, e][:, None, :].expand(Hc4, 4, nE)
    np0 = torch.where(m & ~byp_p, (p0 + delta).clamp(0, maxv), p0)
    nq0 = torch.where(m & ~byp_q, (q0 - delta).clamp(0, maxv), q0)

    out = c.clone()
    out[:, xi - 1] = np0.reshape(Hc, nE)
    out[:, xi] = nq0.reshape(Hc, nE)
    return out


def _deblock_body(y, cb, cr, bs_v, bs_h, qp4, bypass4, lut_cb, lut_cr,
                  beta_off, tc_off, bd):
    """Vertical edges of all planes, then horizontal edges on the
    transposed planes. A transpose is a strided view in torch; each is
    made contiguous on purpose, so the gathers run along rows."""
    def t(a):
        return a.t().contiguous()

    y = _luma_pass(y, bs_v, qp4, beta_off, tc_off, bypass4, bd)
    cb = _chroma_pass(cb, bs_v, qp4, lut_cb, tc_off, bypass4, bd)
    cr = _chroma_pass(cr, bs_v, qp4, lut_cr, tc_off, bypass4, bd)
    bs_ht, qp4t, bypt = t(bs_h), t(qp4), t(bypass4)
    y = t(_luma_pass(t(y), bs_ht, qp4t, beta_off, tc_off, bypt, bd))
    cb = t(_chroma_pass(t(cb), bs_ht, qp4t, lut_cb, tc_off, bypt, bd))
    cr = t(_chroma_pass(t(cr), bs_ht, qp4t, lut_cr, tc_off, bypt, bd))
    return y, cb, cr


def _deblock(y, cb, cr, bs_v, bs_h, qp4, bypass4, lut_cb, lut_cr,
             beta_off, tc_off, bd):
    """Deblocked (y, cb, cr), int16 (counterpart of _deblock_jit)."""
    y, cb, cr = (p.to(torch.int32) for p in (y, cb, cr))
    y, cb, cr = _deblock_body(y, cb, cr, bs_v, bs_h, qp4, bypass4,
                              lut_cb, lut_cr, beta_off, tc_off, bd)
    return y.to(torch.int16), cb.to(torch.int16), cr.to(torch.int16)


def _deblock_sao(y, cb, cr, src_y, src_cb, src_cr, bs_v, bs_h, qp4,
                 bypass4, lut_cb, lut_cr, beta_off, tc_off, bd, ctb, cy, cx):
    """Deblock + SAO statistics of the deblocked recon (counterpart of
    _deblock_sao_jit)."""
    from x265_tpu_torch.hevc.sao import _plane_stats_dev
    y, cb, cr = (p.to(torch.int32) for p in (y, cb, cr))
    y, cb, cr = _deblock_body(y, cb, cr, bs_v, bs_h, qp4, bypass4,
                              lut_cb, lut_cr, beta_off, tc_off, bd)
    stats = (_plane_stats_dev(src_y, y, cy, cx, ctb, bd),
             _plane_stats_dev(src_cb, cb, cy, cx, ctb >> 1, bd),
             _plane_stats_dev(src_cr, cr, cy, cx, ctb >> 1, bd))
    return (y.to(torch.int16), cb.to(torch.int16), cr.to(torch.int16),
            stats)


def _sao_apply_plane(rec, typ, cls, offs, ctb, bd):
    """Device SAO apply for one int32 plane — bit-exact vs
    hevc.sao.apply_plane (spec 8.7.3; x265 applyPixelOffsets,
    sao.cpp:274)."""
    from x265_tpu_torch.hevc.sao import SAO_BO, SAO_EO, _eo_category_dev
    H, W = rec.shape
    cy, cx = typ.shape
    dev = rec.device
    maxv = (1 << bd) - 1
    iy = (torch.arange(H, device=dev) // ctb).clamp(max=cy - 1)
    ix = (torch.arange(W, device=dev) // ctb).clamp(max=cx - 1)
    ptyp = typ[iy][:, ix]
    pcls = cls[iy][:, ix]
    poffs = offs[iy][:, ix]                        # [H, W, 4]

    add = torch.zeros((H, W), dtype=torch.int32, device=dev)
    for eo in range(4):
        cat = _eo_category_dev(rec, eo)
        sel = (ptyp == SAO_EO) & (pcls == eo)
        for c in range(1, 5):
            add += torch.where(sel & (cat == c), poffs[..., c - 1], 0)
    band = rec >> (bd - 5)
    selb = ptyp == SAO_BO
    for i in range(4):
        add += torch.where(selb & (band == ((pcls + i) % 32)),
                           poffs[..., i], 0)
    return (rec + add).clamp(0, maxv)


def sao_apply_device(rec_dev, sp, ctb_log2: int, bd: int = 8):
    """Apply SAO to device-resident recon planes from a SaoParams; the
    parameter maps (a few KB) are the only upload and the result stays on
    the device (the post-SAO recon is the next pictures' reference).
    Returns (y, cb, cr) int16 device planes."""
    ctb = 1 << ctb_log2
    dev = rec_dev[0].device

    def up(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

    y, cb, cr = (p.to(torch.int32) for p in rec_dev)
    type_c = up(sp.type_c)
    y = _sao_apply_plane(y, up(sp.type_y), up(sp.class_y), up(sp.off_y),
                         ctb, bd)
    cb = _sao_apply_plane(cb, type_c, up(sp.class_cb), up(sp.off_cb),
                          ctb >> 1, bd)
    cr = _sao_apply_plane(cr, type_c, up(sp.class_cr), up(sp.off_cr),
                          ctb >> 1, bd)
    return y.to(torch.int16), cb.to(torch.int16), cr.to(torch.int16)


def _chroma_luts(cb_qp_off, cr_qp_off):
    from x265_tpu_torch.hevc.tables import CHROMA_QP_TABLE

    def lut(off):
        return np.array(
            [int(CHROMA_QP_TABLE[min(max(0, q + off), 57)])
             for q in range(52)], np.int32)

    return lut(cb_qp_off), lut(cr_qp_off)


def _boundary_strengths(st, is_intra4, mv4, refpoc4, dev):
    """(bs_v, bs_h) int32 [h4, w4] on `dev`. The inputs are packed into
    one host buffer, page-locked for a CUDA device so that the copy is
    queued without waiting for the work ahead of it: the refpoc4 int32s,
    the mv4 int16s (HEVC motion vectors are 16-bit), then the flag bytes,
    each part 8-byte aligned."""
    h4, w4 = st.cbf4.shape
    n = h4 * w4
    host = torch.empty(17 * n, dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")
    buf = host.numpy()
    buf[:8 * n].view(np.int32).reshape(h4, w4, 2)[...] = refpoc4
    buf[8 * n:16 * n].view(np.int16).reshape(h4, w4, 2, 2)[...] = mv4
    deblock_bs_flags(st.edge_v, st.edge_h, is_intra4, st.cbf4,
                     out=buf[16 * n:].reshape(h4, w4))
    wire = host.to(dev, non_blocking=True)
    return deblock_bs(wire[16 * n:].view(h4, w4),
                      wire[8 * n:16 * n].view(torch.int16).view(h4, w4, 2, 2),
                      wire[:8 * n].view(torch.int32).view(h4, w4, 2))


def deblock_frame_device(recon, st, is_intra4, mv4, refpoc4, qp,
                         beta_off=0, tc_off=0, cb_qp_off=0, cr_qp_off=0,
                         bd=8, sao_src=None, ctb_log2=6, sync=True,
                         keep_device=False, device=None):
    """Device counterpart of hevc.deblock.deblock_frame (bit-exact).

    recon: host planes, or device tensors (which pass through). qp:
    scalar or per-4x4 luma QP map. When sao_src (the source planes) is
    given, the SAO statistics of the deblocked recon come with it:
    (y, cb, cr, stats); else (y, cb, cr), int32 numpy planes. With
    keep_device the planes stay on the device as int16 tensors and the
    result is (y, cb, cr) or ((y, cb, cr), stats).

    sync=False: the work is enqueued and a zero-argument finisher is
    returned; calling it downloads what the caller asked for. On a CUDA
    device the filter runs while the host goes on.
    device=None means the CUDA device.
    """
    y, cb, cr = recon
    dev = y.device if isinstance(y, torch.Tensor) else resolve_device(device)
    h4, w4 = st.cbf4.shape
    with scope("lf.bs"):
        bs_v, bs_h = _boundary_strengths(st, is_intra4, mv4, refpoc4, dev)
    if np.isscalar(qp) or np.ndim(qp) == 0:
        qp4 = np.full((h4, w4), int(qp), np.int32)
    else:
        qp4 = np.asarray(qp, np.int32)
    lut_cb, lut_cr = _chroma_luts(cb_qp_off, cr_qp_off)
    # narrow wire: recon fits uint8 at 8-bit depth
    wire = np.uint8 if bd == 8 else np.int16

    def up(p):
        if isinstance(p, torch.Tensor):
            return p
        return torch.from_numpy(np.asarray(p, wire)).to(dev)

    def small(a, dt=np.int32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(dev)

    with scope("lf.upload"):
        maps = (bs_v, bs_h, small(qp4),
                small(st.bypass4, np.bool_), small(lut_cb), small(lut_cr),
                int(beta_off), int(tc_off), int(bd))
        planes = (up(y), up(cb), up(cr))
        if sao_src is not None:
            from x265_tpu_torch.utils import devcache
            planes += tuple(devcache.src_plane(s, bd, dev) for s in sao_src)

    def down(planes):
        # int32 to the caller (SAO/metrics code uses a 1<<20
        # out-of-picture sentinel that int16 would wrap)
        return tuple(o.cpu().numpy().astype(np.int32) for o in planes)

    if sao_src is None:
        with scope("lf.deblock"):
            out = _deblock(*planes, *maps)

        def finish():
            with scope("lf.finish"):
                return out if keep_device else down(out)
    else:
        from x265_tpu_torch.hevc.sao import stats_to_host
        ctb = 1 << ctb_log2
        H, W = y.shape
        cy, cx = -(-H // ctb), -(-W // ctb)
        with scope("lf.deblock"):
            out = _deblock_sao(*planes, *maps, ctb, cy, cx)

        def finish():
            with scope("lf.finish"):
                stats = stats_to_host(out[3])
                if keep_device:
                    return out[:3], stats
                return (*down(out[:3]), stats)
    return finish if not sync else finish()
