"""Recon-in-the-loop RD evaluation for quadtree promotions and merge
adoption.

x265 analog: Analysis::compressInterCU_rd0_4's bottom-up merge
(analysis.cpp:1146) and checkMerge2Nx2N (analysis.cpp:1914) — each
candidate is coded (predict, transform, quantize, reconstruct), its
distortion measured against the source and its rate estimated, and the
cheaper one wins. Every candidate of a frame is evaluated in one batched
device pass: the predictions are the MC kernel (models.inter_residual
._mc_gather), the source tiles the gather kernel, the transform chain
models/residual.py.

Cost domain: 32*SSE + lam_full[qp] * (rate bits + header bits) +
sqrt(32*lam)*psy_rd*|AC-energy difference|, over all three planes.

Exactness against the JAX package: SSE, psy energies and rates are
summed as integers (rates in Q15 fixed point) and converted to float32
once, which equals the reference's float32 sums whenever those are exact
(SSE below 2^24, a TB's rate below 512 bits). The three-term cost is
formed as the reference's compiled CPU code forms it (_rd_cost).
"""
from __future__ import annotations

import numpy as np
import torch

from x265_tpu_torch.hevc.tables import RDOQ_LAM32_FULL
from x265_tpu_torch.models.inter_residual import (_const_dev, _mc_gather,
                                                  gather_src_blocks)
from x265_tpu_torch.models.residual import _tq_chain
from x265_tpu_torch.utils.device import resolve_device

# CU-level syntax estimates (static bin-count scale): a merge/skip CU
# header, and the extra AMVP cost of a sub-CU whose MV differs from the
# group's unified motion (ref idx + mvp idx + mvd exp-golomb)
CU_OH_BITS = 6
AMVP_EXTRA_BITS = 10

def _tb_rate_bits_j(lvl: torch.Tensor, kk: torch.Tensor) -> torch.Tensor:
    """TB rate in BITS under the estBit fractional-bit model
    (hevc/rate_model.py) with coded_sub_block_flag structure: significant
    4x4 groups pay csbf(1) + their coefficients' estBit costs; zero groups
    before the last significant one (raster order) pay csbf(0); groups
    after it nothing; plus a last-position prefix estimate.

    lvl [N,S,S] int; kk [8] int32 consts row. Returns [N] float32 bits
    (the caller still gates on cbf). The sum is taken in Q15 integers and
    converted once."""
    from x265_tpu_torch.hevc.rate_model import CG0, CG1, rate_fx_t
    S = lvl.shape[-1]
    lastpos = 2.0 * (float(np.log2(S)) + 1.0)
    if S == 4:
        fx = rate_fx_t(lvl, kk).sum(dim=(1, 2), dtype=torch.int64)
        return fx.to(torch.float32) * (1.0 / 32768.0) + lastpos
    nc = S // 4
    cg = (lvl.reshape(-1, nc, 4, nc, 4).permute(0, 1, 3, 2, 4)
          .reshape(-1, nc * nc, 16))
    per = rate_fx_t(cg, kk).sum(dim=2, dtype=torch.int64)    # [N, nCG]
    nz = (cg != 0).any(dim=2)
    idx = torch.arange(nc * nc, device=lvl.device)
    last = torch.where(nz, idx[None, :], -1).amax(dim=1)
    active = idx[None, :] <= last[:, None]
    kk = kk.to(torch.int64)
    fx = torch.where(nz, kk[CG1] + per,
                     torch.where(active, kk[CG0], 0)).sum(dim=1)
    return fx.to(torch.float32) * (1.0 / 32768.0) + lastpos


def _psy_energy8(blocks: torch.Tensor) -> torch.Tensor:
    """Per-8x8 AC energy of pixel blocks (x265 pixel.cpp:727 psyCost_pp):
    sa8d against zero (sum |H8 b H8^T| / 4) minus the DC term
    (sum(pixels) >> 2). blocks [N, S, S] int32 -> [N, S/8 * S/8] int32.
    The products run in float32, exact: every entry is an integer below
    64 * 2^12."""
    from x265_tpu_torch.ops.cuda_kernels import _H8
    N, S, _ = blocks.shape
    b = blocks.reshape(N, S // 8, 8, S // 8, 8).permute(0, 1, 3, 2, 4)
    b = b.reshape(-1, 8, 8)
    h = torch.from_numpy(_H8).to(blocks.device, torch.float32)
    t = torch.matmul(torch.matmul(h, b.to(torch.float32)), h.t())
    sa8d = t.abs().sum(dim=(1, 2)).to(torch.int32) // 4
    dc = b.sum(dim=(1, 2), dtype=torch.int32) >> 2
    return (sa8d - dc).reshape(N, -1)


def _psy_cost(src, recon):
    """Summed |AC-energy(src) - AC-energy(recon)| over the 8x8 tiling of
    [N, S, S] blocks (abs at 8x8 granularity, as in psyCost_pp)."""
    return (_psy_energy8(src) - _psy_energy8(recon)).abs().sum(
        dim=1, dtype=torch.int64).to(torch.float32)


def _chroma_qp_vec(qp, bd, off):
    """Qp'C for a QP vector (8.6.1 via table + offset)."""
    bdo = 6 * (bd - 8)
    q = (qp + off).clamp(-bdo, 57)
    tab = _const_dev("cqp", str(qp.device))
    return torch.where(q < 0, q + bdo, tab[q.clamp(min=0).long()] + bdo)


def _lam_full(qpy: torch.Tensor) -> torch.Tensor:
    """RDOQ_LAM32_FULL[qpy] as float32 (estBit rates are real bits)."""
    tab = torch.from_numpy(np.asarray(RDOQ_LAM32_FULL, np.int64)).to(
        qpy.device)
    return tab[qpy.long()].to(torch.float32)


def _fma32(a, b, c):
    """float32 a*b + c with ONE rounding (a fused multiply-add): the
    product of two float32 is exact in float64; the float64 sum is
    rounded once more to float32."""
    return (a.to(torch.float64) * b.to(torch.float64)
            + c.to(torch.float64)).to(torch.float32)


def _rd_cost(sse, lam, bits, psylam, psy):
    """32*sse + lam*bits + psylam*psy in float32, as the reference's
    compiled CPU code evaluates it: the psy product fused into the last
    add, the rate product rounded on its own (found by holding both forms
    against it, tests/test_torch_rdo.py)."""
    return _fma32(psylam, psy, 32.0 * sse + lam * bits)


def _sse(r, rres):
    """Per-block sum of squared reconstruction errors, summed as integers
    and converted to float32 once."""
    e = (r - rres).to(torch.int64)
    return (e * e).sum(dim=(1, 2)).to(torch.float32)


def _predict(planes0, planes1, x, y, mv, size, use0, dirv, refv, chroma,
             pad, bd):
    """Motion-compensated prediction of one plane for a batch of blocks
    (chroma at half geometry with the 4-tap filters and eighth-pel phases,
    8.5.4.2.2). planes1 None: list 1 is empty, its prediction is zero (a
    zero plane interpolates to zero)."""
    dev = x.device
    maxv = (1 << bd) - 1
    if chroma:
        filt, fb, taps, pd = _const_dev("chroma", str(dev)), 3, 4, pad >> 1
        x, y, size = x >> 1, y >> 1, size // 2
    else:
        filt, fb, taps, pd = _const_dev("luma", str(dev)), 2, 8, pad
    p0 = _mc_gather(planes0, torch.where(use0, refv, 0), x, y,
                    mv[:, 0, 0], mv[:, 0, 1], filt, fb, size, taps, pd, bd)
    if planes1 is None:
        p1 = torch.zeros_like(p0)
    else:
        p1 = _mc_gather(planes1, torch.zeros_like(refv), x, y,
                        mv[:, 1, 0], mv[:, 1, 1], filt, fb, size, taps, pd,
                        bd)
    sh_bi = 15 - bd
    bi = ((p0 + p1 + (1 << (sh_bi - 1))) >> sh_bi).clamp(0, maxv)
    p14 = torch.where(use0[:, None, None], p0, p1)
    sh_u = 14 - bd
    uni = ((p14 + (1 << (sh_u - 1))) >> sh_u).clamp(0, maxv)
    return torch.where((dirv == 3)[:, None, None], bi, uni)


def _promo_costs(src_y, src_cb, src_cr, r0y, r0cb, r0cr,
                 r1y, r1cb, r1cr, xy, mv4, mv1, dirm, ref_i, qp,
                 oh_one, oh_four, rk,
                 n, bd, sdh, do_rdoq, scaling, pad, cb_off, cr_off,
                 psy=0.0):
    """RD costs of G candidate n x n regions:
    ONE n-CU at the unified motion mv1 vs FOUR (n/2)-CUs at their own
    motions mv4.

    src_* [H,W] int16 device planes; r0*/r1* [R,Hp,Wp] padded int16 ref
    stacks (r1* None: list 1 is empty); xy [G,2] (x0,y0); mv4 [G,4,2,2]
    qpel per z-order sub-block; mv1 [G,2,2]; dirm [G] 1/2/3; ref_i [G]
    L0 idx; qp [G]; oh_one/oh_four [G] header-bit estimates; rk [2,8].
    Returns (cost_one [G], cost_four [G]) float32.
    """
    G = xy.shape[0]
    m = n // 2
    x0, y0 = xy[:, 0], xy[:, 1]
    use0_g = (dirm & 1) > 0
    srcs = (src_y, src_cb, src_cr)
    r0 = (r0y, r0cb, r0cr)
    r1 = (r1y, r1cb, r1cr)

    qpy = qp + 6 * (bd - 8)
    lam = _lam_full(qpy)
    # psy-rd lambda: cost domain is 32*SSE, so the sqrt-lambda psy term
    # (rdcost.h calcPsyRdCost: dist + sqrt_lam*psyRd*energyDiff) scales
    # as 32*sqrt(lam/32) = sqrt(32*lam)
    psylam = torch.sqrt(32.0 * lam) * psy

    def cfg_cost(r, pred, qvec, size, want_psy, krow):
        # TBs larger than 32 ride the implicit RQT split (7.3.8.8):
        # transform in 32x32 quads, aggregate the costs back per region
        if size > 32:
            gq = r.shape[0]
            h = size // 2

            def quads(a):
                return (a.reshape(gq, 2, h, 2, h).permute(0, 1, 3, 2, 4)
                        .reshape(gq * 4, h, h))
            sse, rate, pc = cfg_cost(quads(r), quads(pred),
                                     qvec.repeat_interleave(4), h,
                                     want_psy, krow)
            return (sse.reshape(gq, 4).sum(dim=1),
                    rate.reshape(gq, 4).sum(dim=1),
                    pc.reshape(gq, 4).sum(dim=1))
        lvl, rres, cbf = _tq_chain(
            r, qvec, torch.zeros((r.shape[0],), dtype=torch.int32,
                                 device=r.device),
            size, False, False, bd, sdh, do_rdoq, False, scaling)
        sse = _sse(r, rres)
        rate = torch.where(cbf, _tb_rate_bits_j(lvl, krow), 0.0)
        if want_psy:
            maxv_ = (1 << bd) - 1
            pc = _psy_cost(pred + r, (pred + rres).clamp(0, maxv_))
        else:
            pc = torch.zeros_like(sse)
        return sse, rate, pc

    qpc_cb = _chroma_qp_vec(qp, bd, cb_off) + 6 * (bd - 8)
    qpc_cr = _chroma_qp_vec(qp, bd, cr_off) + 6 * (bd - 8)

    def plane_cost(pl, xv, yv, mv, size, use0, dirv, refv, qv):
        xs, ys, sz = ((xv, yv, size) if pl == 0
                      else (xv >> 1, yv >> 1, size // 2))
        srcp = gather_src_blocks(srcs[pl], ys, xs, sz)
        pred = _predict(r0[pl], r1[pl], xv, yv, mv, size, use0, dirv, refv,
                        pl > 0, pad, bd)
        # psy energy is a luma-plane cost (pixel.cpp psyCost_pp usage)
        return cfg_cost(srcp - pred, pred, qv, sz, psy > 0 and pl == 0,
                        rk[min(pl, 1)])

    # --- one n-CU at the unified motion ---
    sse1, rate1, psy1 = plane_cost(0, x0, y0, mv1, n, use0_g, dirm,
                                   ref_i, qpy)
    for pl, qv in ((1, qpc_cb), (2, qpc_cr)):
        sc, rc, _pc = plane_cost(pl, x0, y0, mv1, n, use0_g, dirm, ref_i,
                                 qv)
        sse1 = sse1 + sc
        rate1 = rate1 + rc
    cost_one = _rd_cost(sse1, lam, rate1 + oh_one, psylam, psy1)

    # --- four (n/2)-CUs at their own motions ---
    # z-order sub-block q: (dy, dx) = (q // 2, q % 2)
    qq = torch.arange(4, dtype=torch.int32, device=xy.device)
    x4 = (x0[:, None] + (qq % 2)[None, :] * m).reshape(-1)
    y4 = (y0[:, None] + (qq // 2)[None, :] * m).reshape(-1)
    mv4f = mv4.reshape(G * 4, 2, 2)
    # per-sub dir/ref follow the group (eligibility requires same dir/ref)
    use0_4 = use0_g.repeat_interleave(4)
    dirm_4 = dirm.repeat_interleave(4)
    ref_4 = ref_i.repeat_interleave(4)
    sse4, rate4, psy4 = plane_cost(0, x4, y4, mv4f, m, use0_4, dirm_4,
                                   ref_4, qpy.repeat_interleave(4))
    for pl, qv in ((1, qpc_cb), (2, qpc_cr)):
        sc, rc, _pc = plane_cost(pl, x4, y4, mv4f, m, use0_4, dirm_4,
                                 ref_4, qv.repeat_interleave(4))
        sse4 = sse4 + sc
        rate4 = rate4 + rc
    sse4 = sse4.reshape(G, 4).sum(dim=1)
    rate4 = rate4.reshape(G, 4).sum(dim=1)
    psy4 = psy4.reshape(G, 4).sum(dim=1)
    cost_four = _rd_cost(sse4, lam, rate4 + oh_four, psylam, psy4)
    return cost_one, cost_four


def _plane_stacks(src_yuv, refs0_padded, refs1_padded, p, pad, device):
    """Device stacks for the RD passes: (src_y, src_cb, src_cr) and
    [r, Hp, Wp] per-plane reference stacks for each list (None for an
    empty list). refs*_padded: lists of FramePlanes (the encoder's
    anchors), padded on the device (pad luma, pad/2 chroma)."""
    from x265_tpu_torch.utils import devcache

    def stack(lst, pl):
        if not lst:
            return None
        # identity-keyed: anchors serve several frames and the three RD
        # passes of a frame reuse one stack
        key = ("rdstack", pl) + tuple(id(r) for r in lst)
        return devcache.get_or(
            key, lst[0],
            lambda: torch.stack([r.dev_padded(pad)[pl] for r in lst]))

    srcs = tuple(devcache.src_plane(np.asarray(pl_arr), p.bit_depth, device)
                 for pl_arr in src_yuv)
    r0s = tuple(stack(refs0_padded, pl) for pl in range(3))
    r1s = tuple(stack(refs1_padded, pl) for pl in range(3))
    return srcs, r0s, r1s


def _dev_i32(a, device):
    return torch.from_numpy(np.array(a, dtype=np.int32)).to(device)


def _dev_f32(a, device):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def rd_promote(src_yuv, refs0_padded, refs1_padded, cand_yx, mv4, dirm,
               ref_i, qp, p, n=32, mv_bias=None, bias_dir=None, mesh=None,
               device=None):
    """Decide per candidate group whether one n x n CU at the group's
    modal motion beats four (n/2)-CUs at their own motions.

    cand_yx [G,2] (yn, xn) indices on the n-grid; mv4 [G,4,2,2]
    z-order sub-block motions; dirm/ref_i [G]. Returns (promote [G]
    bool, mv_uni [G,2,2]). mesh (Encoder.attach_mesh) is accepted and not
    used: the pass runs unsharded on `device`, as the JAX package's."""
    from x265_tpu_torch.hevc.rate_model import rdoq_rate_consts
    dev = resolve_device(device)
    G = len(cand_yx)
    # unified candidate: the modal MV among the 4 sub-blocks (the member
    # minimizing summed L1 distance to the others — ties break low)
    d = np.abs(mv4[:, :, None] - mv4[:, None, :]).sum(axis=(3, 4))
    modal = d.sum(axis=2).argmin(axis=1)
    mv_uni = mv4[np.arange(G), modal]
    if mv_bias is not None:
        # bias toward the FRAME-dominant motion when the group's modal
        # is within a pel of it: adjacent groups then unify to the SAME
        # exact MV and the writer's merge/skip chains span group
        # boundaries
        near = (np.abs(mv_uni - mv_bias[None]).max(axis=(1, 2)) <= 4)
        if bias_dir is not None:
            near &= dirm == bias_dir
        mv_uni = np.where(near[:, None, None], mv_bias[None], mv_uni)

    # header estimates: the unified CU merges with its uniform
    # neighborhood (~CU_OH_BITS); each sub-CU pays a header plus AMVP
    # syntax when its MV differs from the unified one
    differs = (mv4 != mv_uni[:, None]).any(axis=(2, 3))
    oh_one = np.full(G, CU_OH_BITS, np.float32)
    oh_four = (4 * CU_OH_BITS
               + AMVP_EXTRA_BITS * differs.sum(axis=1)).astype(np.float32)

    xy = np.stack([cand_yx[:, 1] * n, cand_yx[:, 0] * n], 1)
    args = (_dev_i32(xy, dev), _dev_i32(mv4, dev), _dev_i32(mv_uni, dev),
            _dev_i32(dirm, dev), _dev_i32(ref_i, dev),
            _dev_i32(np.full(G, qp), dev), _dev_f32(oh_one, dev),
            _dev_f32(oh_four, dev),
            _dev_i32(rdoq_rate_consts(2, int(qp)), dev))
    pad = 80
    srcs, r0s, r1s = _plane_stacks(src_yuv, refs0_padded, refs1_padded,
                                   p, pad, dev)
    c1, c4 = _promo_costs(
        *srcs, *r0s, *r1s, *args,
        n=n, bd=p.bit_depth, sdh=bool(p.sign_hide),
        do_rdoq=p.rdoq_level > 0, scaling=bool(p.scaling_lists),
        pad=pad, cb_off=int(p.cb_qp_offset), cr_off=int(p.cr_qp_offset),
        psy=round(float(getattr(p, "psy_rd", 0.0)), 2))
    return (c1 <= c4).cpu().numpy(), mv_uni


def rd_promote32(*args, **kw):
    return rd_promote(*args, n=32, **kw)


def _adopt_costs(src_y, src_cb, src_cr, r0y, r0cb, r0cr,
                 r1y, r1cb, r1cr, xy, mv_all, dir_all, ref_all, qp,
                 hdr_all, rk, k, bd, sdh, do_rdoq, scaling, pad,
                 cb_off, cr_off, psy=0.0):
    """RD cost of coding every 16x16 block under each of k motion
    configurations (config 0 = the block's own refined motion, 1..k-1 =
    frame-dominant candidate tuples): 32*SSE(recon) + lam*(rate + hdr),
    summed over all three planes.

    xy [N,2]; mv_all [k*N,2,2]; dir_all/ref_all [k*N]; qp [N];
    hdr_all [k] header-bit estimates per config. Returns cost [k, N].
    """
    maxv = (1 << bd) - 1
    x0 = xy[:, 0].repeat(k)
    y0 = xy[:, 1].repeat(k)
    use0 = (dir_all & 1) > 0
    qpy = (qp + 6 * (bd - 8)).repeat(k)
    qpc = {1: (_chroma_qp_vec(qp, bd, cb_off) + 6 * (bd - 8)).repeat(k),
           2: (_chroma_qp_vec(qp, bd, cr_off) + 6 * (bd - 8)).repeat(k)}
    srcs = (src_y, src_cb, src_cr)
    r0 = (r0y, r0cb, r0cr)
    r1 = (r1y, r1cb, r1cr)

    def plane_cost(pl, qv):
        sz = 16 if pl == 0 else 8
        xs, ys = (x0, y0) if pl == 0 else (x0 >> 1, y0 >> 1)
        pred = _predict(r0[pl], r1[pl], x0, y0, mv_all, 16, use0, dir_all,
                        ref_all, pl > 0, pad, bd)
        src = gather_src_blocks(srcs[pl], ys, xs, sz)
        resi = src - pred
        lvl, rres, cbf = _tq_chain(
            resi, qv, torch.zeros((resi.shape[0],), dtype=torch.int32,
                                  device=resi.device),
            sz, False, False, bd, sdh, do_rdoq, False, scaling)
        sse = _sse(resi, rres)
        rate = torch.where(cbf, _tb_rate_bits_j(lvl, rk[min(pl, 1)]), 0.0)
        if psy > 0 and pl == 0:
            pc = _psy_cost(src, (pred + rres).clamp(0, maxv))
        else:
            pc = torch.zeros_like(sse)
        return sse, rate, pc

    sse, rate, psyc = plane_cost(0, qpy)
    for pl in (1, 2):
        sc, rc, _pc = plane_cost(pl, qpc[pl])
        sse = sse + sc
        rate = rate + rc
    # estBit rates are real bits -> full lambda2 (rate_model.py)
    lam = _lam_full(qpy)
    hdr = hdr_all.repeat_interleave(xy.shape[0])
    cost = _rd_cost(sse, lam, rate + hdr, torch.sqrt(32.0 * lam) * psy,
                    psyc)
    return cost.reshape(k, -1)


# header-bit estimates for the adoption configs (static bin scale):
# a block keeping its own motion pays AMVP syntax (mvp idx + mvd +
# ref idx); a block adopting a frame-dominant tuple codes merge/skip
OWN_HDR_BITS = 14.0
CAND_HDR_BITS = 5.0


def rd_adopt16(src_yuv, refs0_padded, refs1_padded, inter_blk, mv_blk,
               dir_blk, ref_blk, cands, qp, p, mesh=None, device=None):
    """Recon-in-the-loop merge adoption (x265 checkMerge2Nx2N with real
    RD, analysis.cpp:1914): every inter 16x16 block is coded under its
    own motion AND each frame-dominant candidate tuple (up to four); the
    cheapest configuration wins, the first on ties. mesh is accepted and
    not used, as by rd_promote.

    Returns updated (dir_blk, mv_blk, ref_blk, adopted_mask)."""
    from x265_tpu_torch.hevc.rate_model import rdoq_rate_consts
    dev = resolve_device(device)
    nby, nbx = dir_blk.shape
    N = nby * nbx
    # the reference pads the list to four by repeating the last tuple; a
    # repeat costs the same as the tuple before it and never wins the
    # first-index argmin, so only the distinct ones are evaluated
    cands = list(cands)[:4]
    K = len(cands)
    by, bx = np.meshgrid(np.arange(nby), np.arange(nbx), indexing="ij")
    xy = np.stack([bx.reshape(-1) * 16, by.reshape(-1) * 16], 1)
    mv_all = [mv_blk.reshape(N, 2, 2)]
    dir_all = [dir_blk.reshape(N)]
    ref_all = [ref_blk.reshape(N)]
    for (dd, r0_, _r1, m0, m1) in cands:
        mvc = np.zeros((N, 2, 2), np.int32)
        mvc[:, 0] = m0
        mvc[:, 1] = m1
        mv_all.append(mvc)
        dir_all.append(np.full(N, dd, np.int32))
        ref_all.append(np.full(N, r0_, np.int32))
    hdr = np.array([OWN_HDR_BITS] + [CAND_HDR_BITS] * K, np.float32)

    pad = 80
    srcs, r0s, r1s = _plane_stacks(src_yuv, refs0_padded, refs1_padded,
                                   p, pad, dev)
    cost = _adopt_costs(
        *srcs, *r0s, *r1s, _dev_i32(xy, dev),
        _dev_i32(np.concatenate(mv_all), dev),
        _dev_i32(np.concatenate(dir_all), dev),
        _dev_i32(np.concatenate(ref_all), dev),
        _dev_i32(np.full(N, qp), dev), _dev_f32(hdr, dev),
        _dev_i32(rdoq_rate_consts(2, int(qp)), dev), k=K + 1,
        bd=p.bit_depth, sdh=bool(p.sign_hide), do_rdoq=p.rdoq_level > 0,
        scaling=bool(p.scaling_lists), pad=pad,
        cb_off=int(p.cb_qp_offset), cr_off=int(p.cr_qp_offset),
        psy=round(float(getattr(p, "psy_rd", 0.0)), 2))
    cost = cost.cpu().numpy()                      # [K+1, N]
    choice = cost.argmin(axis=0).reshape(nby, nbx)
    choice = np.where(inter_blk, choice, 0)
    adopted = choice > 0
    if not adopted.any():
        return dir_blk, mv_blk, ref_blk, adopted
    carr = np.array([[dd, r0_, m0[0], m0[1], m1[0], m1[1]]
                     for (dd, r0_, _r1, m0, m1) in cands], np.int32)
    sel = carr[np.clip(choice - 1, 0, K - 1)]      # [nby,nbx,6]
    dir_out = np.where(adopted, sel[..., 0], dir_blk).astype(np.int32)
    ref_out = np.where(adopted, sel[..., 1], ref_blk).astype(np.int32)
    mv_out = mv_blk.copy()
    mv_out[adopted, 0, 0] = sel[adopted, 2]
    mv_out[adopted, 0, 1] = sel[adopted, 3]
    mv_out[adopted, 1, 0] = sel[adopted, 4]
    mv_out[adopted, 1, 1] = sel[adopted, 5]
    return dir_out, mv_out, ref_out, adopted
