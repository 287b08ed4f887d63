"""Batched inter-CU residual pipeline — the P-frame half of the
finalizer split.

For every inter CU the decision maps already fix (MV, dir, ref), so
motion compensation, transform, quant, SBH, dequant and recon have no
intra-frame dependency at all: the whole frame's inter CUs of one size
run as ONE batched device computation (reference analog: the per-CU
serial Predict::motionCompensation + Quant::transformNxN walk,
predict.cpp / quant.cpp:397, recast as tensor ops). Results feed the
native writer's precomputed (emit-only) mode — streams are byte-identical
to the all-CPU path.

MC and the source-tile gathers are hand-written CUDA kernels
(ops/cuda_mc.py); the transform chain is models/residual.py.

Bit-exactness notes: the 8/4-tap MC uses the same "tap-0 == 64" algebra
as mc_14 (slice_writer.cpp:491) — the generic separable path equals every
xf/yf special case exactly because 64 = 2^6 divides the stage shifts.

Ported so far: uni-directional prediction from list 0 (with or without
explicit weights) or list 1, bi-prediction, TU == CU (64x64 CUs as four
32x32 quadrants), the integer RDOQ (estBit constants, psy-RDOQ) and the
explicit RQT level (tu-inter-depth 2: a 16x16 or 32x32 CU keeps its one
TU or splits it into four, whichever costs less). Scaling lists raise.

The RQT choice is a float32 cost comparison. Its sums are taken as
integers (SSE) or in Q15 (rates) and converted once, which equals the
JAX package's float32 sums whenever those are exact (a plane's SSE below
2^24, a TB's rate below 512 bits); the sum of four quadrant rates is
taken left to right, and the rate product is rounded on its own, as the
reference's compiled CPU code does (models/rdo._rd_cost).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from x265_tpu_torch.hevc.tables import CHROMA_QP_TABLE
from x265_tpu_torch.models.residual import _tq_chain
from x265_tpu_torch.ops.cuda_mc import mc_gather_interp, tile_gather
from x265_tpu_torch.utils.device import resolve_device

_LUMA_FILT = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1]], np.int32)
_CHROMA_FILT = np.array([
    [0, 64, 0, 0], [-2, 58, 10, -2], [-4, 54, 16, -2], [-6, 46, 28, -4],
    [-4, 36, 36, -4], [-4, 28, 46, -6], [-2, 16, 54, -4], [-2, 10, 58, -2]],
    np.int32)


@lru_cache(maxsize=16)
def _const_dev(name: str, device: str) -> torch.Tensor:
    arr = {"luma": _LUMA_FILT, "chroma": _CHROMA_FILT,
           "cqp": np.asarray(CHROMA_QP_TABLE, np.int32)}[name]
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _i16(t: torch.Tensor) -> torch.Tensor:
    """The kernels' plane type: contiguous int16 (pixels always fit)."""
    return t.to(torch.int16).contiguous()


def gather_src_blocks(src, yy, xx, size):
    """[N, size, size] int32 source tiles at (yy, xx); the gather clips
    origins into the plane (dynamic_slice clamp semantics)."""
    return tile_gather(_i16(src), yy.to(torch.int32).contiguous(),
                       xx.to(torch.int32).contiguous(), size)


def _mc_gather(planes, ridx, x0, y0, mvx, mvy, filt, fb, n, taps, pad, bd):
    """14-bit MC prediction for a batch of blocks from stacked ref planes.

    planes [R, Hp, Wp] int16; ridx/x0/y0/mvx/mvy [N]; filt [P, taps];
    fb: mv fractional bits (2 luma, 3 chroma). The kernel clips window
    origins with the plane bounds. Returns [N, n, n] int32.
    """
    half = taps // 2
    mask = (1 << fb) - 1

    def i32(t):
        return t.to(torch.int32).contiguous()

    oy = pad + y0 + (mvy >> fb) - half + 1
    ox = pad + x0 + (mvx >> fb) - half + 1
    return mc_gather_interp(_i16(planes), i32(ridx), i32(oy), i32(ox),
                            i32(mvx & mask), i32(mvy & mask), filt,
                            n, taps, bd)


def _tq_quads(res, qvec, m, N, bd, sdh, do_rdoq, lossless, scaling,
              kk=None, pfx=0):
    """res [N,2m,2m] -> per-quadrant transform chain at m (z-order);
    returns (lvl [N,2m,2m], rres [N,2m,2m], cbf [N,4]). Serves both the
    64x64 implicit RQT split and the explicit inter RQT level."""
    q = res.reshape(N, 2, m, 2, m).permute(0, 1, 3, 2, 4)
    q = q.reshape(N * 4, m, m)
    lv, rr, cb_ = _tq_chain(q, qvec.repeat_interleave(4),
                            torch.zeros((N * 4,), dtype=torch.int32,
                                        device=res.device), m,
                            False, False, bd, sdh, do_rdoq,
                            lossless, scaling, kk, pfx)

    def back(a):
        return (a.reshape(N, 2, 2, m, m).permute(0, 1, 3, 2, 4)
                .reshape(N, 2 * m, 2 * m))

    return back(lv), back(rr), cb_.reshape(N, 4)


def _inter_class_body(src_y, src_cb, src_cr,
                      r0y, r0cb, r0cr, r1y, r1cb, r1cr,
                      xy, mv, dirm, ref_i, qp, wp,
                      n, bd, sdh, do_rdoq, lossless, pad, wld, wcd,
                      cb_off, cr_off, scaling=False, consts=None, psy_fx=0,
                      rqt=False, rate_kk=None):
    """One CU-size class of inter CUs: MC + residual chain, all planes.

    xy [N,2] luma top-left; mv [N,2,2] (list, x/y) qpel; dirm [N] 1/2/3
    (L0, L1, bi); ref_i [N] L0 ref; qp [N] slice/CTB QpY (pre bd
    offset); r1* the list-1 stacks (one reference) or None when list 1 is
    empty; wp [4,3,3] int32 (flag, weight, offset) explicit L0 weights
    per reference and plane, or None; wld/wcd their log2 denominators.
    consts: [2,8] estBit RDOQ constants (luma, chroma) or None (the
    static model); psy_fx: psy-RDOQ strength (luma); rqt: the explicit
    RQT level for the 16 and 32 classes, priced with the estBit rows
    rate_kk [2,8].
    Returns (lvl_y [N,n,n], lvl_cb, lvl_cr [N,n/2,n/2], cbf [N,3] or
    [N,4,3], rec_y [N,n,n], rec_cb, rec_cr, tusplit [N]).
    """
    N = xy.shape[0]
    hs = n // 2
    maxv = (1 << bd) - 1
    dev = xy.device
    x0 = xy[:, 0]
    y0 = xy[:, 1]

    use0 = (dirm & 1) > 0
    use1 = (dirm & 2) > 0
    lanes0 = torch.nonzero(use0).reshape(-1)
    lanes1 = torch.nonzero(use1).reshape(-1)

    def pred_plane(pl, planes0, planes1, size, fb, taps, filt, padc):
        xx = x0 if pl == 0 else x0 >> 1
        yy = y0 if pl == 0 else y0 >> 1

        def mc(planes, lanes, ridx, lst):
            """The 14-bit prediction from one list for the lanes that use
            it; zero elsewhere (those lanes never read it)."""
            out = torch.zeros((N, size, size), dtype=torch.int32,
                              device=dev)
            if planes is not None and lanes.numel():
                out[lanes] = _mc_gather(
                    planes, ridx[lanes], xx[lanes], yy[lanes],
                    mv[lanes, lst, 0], mv[lanes, lst, 1], filt, fb, size,
                    taps, padc, bd)
            return out

        p0 = mc(planes0, lanes0, ref_i, 0)
        # list 1 holds one reference: ridx 0 (the reference gathers a
        # list-1 prediction for every lane; only the lanes using it
        # differ from zero)
        p1 = mc(planes1, lanes1, torch.zeros_like(ref_i), 1)
        # bi: (p0 + p1 + off) >> (15 - bd)
        shift_bi = 15 - bd
        bi = ((p0 + p1 + (1 << (shift_bi - 1))) >> shift_bi).clamp_(0, maxv)
        # uni from the used list
        p14 = torch.where(use0[:, None, None], p0, p1)
        shift_u = 14 - bd
        uni = ((p14 + (1 << (shift_u - 1))) >> shift_u).clamp_(0, maxv)
        if wp is not None:
            # explicit weighted uni (L0 uni lanes only, 8.5.4.2.3.2).
            # int32 holds the product: |p14| < 2^15 and |weight| < 2^8;
            # >> is arithmetic. The table holds 4 references; a 5th one
            # (ref 5, the slower presets) reads the last row, as the JAX
            # package's clamped gather does (only reference 0 carries a
            # weight, so both rows are unweighted)
            ri = torch.where(use0, ref_i, 0).clamp_(max=wp.shape[0] - 1)
            we = wp[ri.long(), pl]                         # flag,w,off
            wflag = (we[:, 0] > 0) & use0 & ~use1
            denom = wld if pl == 0 else wcd                # one per slice
            log2wd = denom + 14 - bd
            o = (we[:, 2] << (bd - 8))[:, None, None]
            wgt = we[:, 1][:, None, None]
            if log2wd >= 1:
                wv = (p14 * wgt + (1 << (log2wd - 1))) >> log2wd
            else:
                wv = p14 * wgt
            wuni = (wv + o).clamp_(0, maxv)
            uni = torch.where(wflag[:, None, None], wuni, uni)
        return torch.where((dirm == 3)[:, None, None], bi, uni)

    pred_y = pred_plane(0, r0y, r1y, n, 2, 8, _const_dev("luma", str(dev)),
                        pad)
    pred_cb = pred_plane(1, r0cb, r1cb, hs, 3, 4,
                         _const_dev("chroma", str(dev)), pad >> 1)
    pred_cr = pred_plane(2, r0cr, r1cr, hs, 3, 4,
                         _const_dev("chroma", str(dev)), pad >> 1)

    def block_src(plane, size):
        xx = x0 if plane == 0 else x0 >> 1
        yy = y0 if plane == 0 else y0 >> 1
        return gather_src_blocks((src_y, src_cb, src_cr)[plane],
                                 yy, xx, size)

    sy = block_src(0, n)
    scb = block_src(1, hs)
    scr = block_src(2, hs)

    qpy = qp + 6 * (bd - 8)

    # chroma QP (8.6.1 via table)
    def cqp(off):
        bdo = 6 * (bd - 8)
        q = (qp + off).clamp(-bdo, 57)
        tab = _const_dev("cqp", str(dev))
        return torch.where(q < 0, q + bdo,
                           tab[q.clamp(min=0).long()] + bdo)

    zsel = torch.zeros((N,), dtype=torch.int32, device=dev)
    kl = None if consts is None else consts[0]
    kc = None if consts is None else consts[1]
    if n <= 32:
        lvl_y, rres_y, cbf_y = _tq_chain(sy - pred_y, qpy, zsel, n, False,
                                         False, bd, sdh, do_rdoq, lossless,
                                         scaling, kl, psy_fx)
        lvl_cb, rres_cb, cbf_cb = _tq_chain(scb - pred_cb, cqp(cb_off),
                                            zsel, hs, False, False, bd,
                                            sdh, do_rdoq, lossless, scaling,
                                            kc)
        lvl_cr, rres_cr, cbf_cr = _tq_chain(scr - pred_cr, cqp(cr_off),
                                            zsel, hs, False, False, bd,
                                            sdh, do_rdoq, lossless, scaling,
                                            kc)
        cbf = torch.stack([cbf_y, cbf_cb, cbf_cr], dim=1)
    else:
        lvl_y, rres_y, qcbf_y = _tq_quads(sy - pred_y, qpy, n // 2, N,
                                          bd, sdh, do_rdoq, lossless,
                                          scaling, kl, psy_fx)
        lvl_cb, rres_cb, qcbf_cb = _tq_quads(scb - pred_cb, cqp(cb_off),
                                             hs // 2, N, bd, sdh, do_rdoq,
                                             lossless, scaling, kc)
        lvl_cr, rres_cr, qcbf_cr = _tq_quads(scr - pred_cr, cqp(cr_off),
                                             hs // 2, N, bd, sdh, do_rdoq,
                                             lossless, scaling, kc)
        cbf = torch.stack([qcbf_y, qcbf_cb, qcbf_cr], dim=2)  # [N,4,3]
    tusplit = torch.zeros((N,), dtype=torch.int32, device=dev)
    if rqt and 16 <= n <= 32 and not lossless:
        # explicit RQT level (x265 estimateResidualQT, search.cpp:2863):
        # re-run the chain with the TU split into 4 quadrants and keep
        # the per-CU winner of 32*SSE + lambda*estBits (+ the tree's
        # extra cbf/flag bins charged to the split)
        from x265_tpu_torch.models.rdo import (_lam_full, _sse,
                                               _tb_rate_bits_j)
        lam = _lam_full(qpy) / float(1 << 15)        # bits domain
        ry, rcb, rcr = sy - pred_y, scb - pred_cb, scr - pred_cr
        ly2, ry2, qy2 = _tq_quads(ry, qpy, n // 2, N, bd, sdh, do_rdoq,
                                  lossless, scaling, kl, psy_fx)
        lcb2, rcb2, qcb2 = _tq_quads(rcb, cqp(cb_off), hs // 2, N, bd, sdh,
                                     do_rdoq, lossless, scaling, kc)
        lcr2, rcr2, qcr2 = _tq_quads(rcr, cqp(cr_off), hs // 2, N, bd, sdh,
                                     do_rdoq, lossless, scaling, kc)

        def sse3(ra, rb, rc):
            return _sse(ry, ra) + _sse(rcb, rb) + _sse(rcr, rc)

        def rate_whole(lv, kkrow):
            return torch.where((lv != 0).any(dim=2).any(dim=1),
                               _tb_rate_bits_j(lv, kkrow), 0.0)

        def rate_quads(lv, kkrow, m):
            q = (lv.reshape(N, 2, m, 2, m).permute(0, 1, 3, 2, 4)
                 .reshape(N * 4, m, m))
            r = torch.where((q != 0).any(dim=2).any(dim=1),
                            _tb_rate_bits_j(q, kkrow), 0.0).reshape(N, 4)
            return ((r[:, 0] + r[:, 1]) + r[:, 2]) + r[:, 3]

        kkl, kkc = rate_kk[0], rate_kk[1]
        rate_a = (rate_whole(lvl_y, kkl) + rate_whole(lvl_cb, kkc)
                  + rate_whole(lvl_cr, kkc))
        rate_b = (rate_quads(ly2, kkl, n // 2)
                  + rate_quads(lcb2, kkc, hs // 2)
                  + rate_quads(lcr2, kkc, hs // 2))
        # tree-bin overhead of the split: 4 extra cbf_luma + up to 8
        # child chroma cbfs, ~8 bins net of the shared flag
        cost_a = 32.0 * sse3(rres_y, rres_cb, rres_cr) + lam * rate_a
        cost_b = 32.0 * sse3(ry2, rcb2, rcr2) + lam * (rate_b + 8.0)
        split = cost_b < cost_a
        tusplit = split.to(torch.int32)
        sm = split[:, None, None]
        lvl_y = torch.where(sm, ly2, lvl_y)
        rres_y = torch.where(sm, ry2, rres_y)
        lvl_cb = torch.where(sm, lcb2, lvl_cb)
        rres_cb = torch.where(sm, rcb2, rres_cb)
        lvl_cr = torch.where(sm, lcr2, lvl_cr)
        rres_cr = torch.where(sm, rcr2, rres_cr)
        # per-quadrant cbf (z-order) regardless of the choice: an
        # unsplit CU gives its single cbf to all 4 cells
        whole = torch.stack([(a != 0).any(dim=2).any(dim=1)
                             for a in (lvl_y, lvl_cb, lvl_cr)], dim=1)
        quads = torch.stack([qy2, qcb2, qcr2], dim=2)          # [N,4,3]
        cbf = torch.where(split[:, None, None], quads,
                          whole[:, None, :].expand_as(quads))
    rec_y = (pred_y + rres_y).clamp_(0, maxv)
    rec_cb = (pred_cb + rres_cb).clamp_(0, maxv)
    rec_cr = (pred_cr + rres_cr).clamp_(0, maxv)
    # int16 results: levels clamp to +-32767, recon to the pixel range
    return (lvl_y.to(torch.int16), lvl_cb.to(torch.int16),
            lvl_cr.to(torch.int16), cbf, rec_y.to(torch.int16),
            rec_cb.to(torch.int16), rec_cr.to(torch.int16), tusplit)


def _inter_multi_planes(src_y, src_cb, src_cr,
                        r0y, r0cb, r0cr, r1y, r1cb, r1cr,
                        per_class, wp, ns, bd, sdh, do_rdoq, lossless,
                        pad, wld, wcd, cb_off, cr_off, scaling=False,
                        consts=None, psy_fx=0, rqt=False, rate_kk=None):
    """Every CU-size class through _inter_class_body + ON-DEVICE scatter
    of each class's levels/recon into full-frame planes, so one
    frame-sized download per plane reaches the host.

    Returns (lvl_y, lvl_cb, lvl_cr [i16], cbf8, has8 [u8],
    rec_y, rec_cb, rec_cr [u8 when bd==8 else i16], tus8 [u8])."""
    h, w = src_y.shape
    maxv = (1 << bd) - 1
    dev = src_y.device
    rdt = torch.uint8 if bd == 8 else torch.int16
    lvl_y = torch.zeros((h, w), dtype=torch.int16, device=dev)
    lvl_cb = torch.zeros((h // 2, w // 2), dtype=torch.int16, device=dev)
    lvl_cr = torch.zeros((h // 2, w // 2), dtype=torch.int16, device=dev)
    rec_y = src_y.clamp(0, maxv).to(rdt)
    rec_cb = src_cb.clamp(0, maxv).to(rdt)
    rec_cr = src_cr.clamp(0, maxv).to(rdt)
    cbf8 = torch.zeros((h // 8, w // 8), dtype=torch.uint8, device=dev)
    has8 = torch.zeros((h // 8, w // 8), dtype=torch.uint8, device=dev)
    tus8 = torch.zeros((h // 8, w // 8), dtype=torch.uint8, device=dev)
    for (n, args) in zip(ns, per_class):
        xy, mv, dirm, ref_i, qp = args
        if xy.shape[0] == 0:
            continue
        ly, lcb, lcr, cbf, ry, rcb, rcr, tus = _inter_class_body(
            src_y, src_cb, src_cr, r0y, r0cb, r0cr, r1y, r1cb, r1cr,
            xy, mv, dirm, ref_i, qp, wp, n, bd, sdh, do_rdoq, lossless,
            pad, wld, wcd, cb_off, cr_off, scaling, consts, psy_fx,
            rqt, rate_kk)
        x0 = xy[:, 0].long()
        y0 = xy[:, 1].long()
        ii = torch.arange(n, device=dev)
        yy = y0[:, None, None] + ii[None, :, None]
        xx = x0[:, None, None] + ii[None, None, :]
        lvl_y[yy, xx] = ly
        rec_y[yy, xx] = ry.to(rdt)
        hh = ii[:n // 2]
        cyy = (y0 >> 1)[:, None, None] + hh[None, :, None]
        cxx = (x0 >> 1)[:, None, None] + hh[None, None, :]
        lvl_cb[cyy, cxx] = lcb
        lvl_cr[cyy, cxx] = lcr
        rec_cb[cyy, cxx] = rcb.to(rdt)
        rec_cr[cyy, cxx] = rcr.to(rdt)
        r = n >> 3
        jj = torch.arange(r, device=dev)
        byy = (y0 >> 3)[:, None, None] + jj[None, :, None]
        bxx = (x0 >> 3)[:, None, None] + jj[None, None, :]
        c8 = cbf.to(torch.uint8)
        if cbf.dim() == 2:
            bits = c8[:, 0] | (c8[:, 1] << 1) | (c8[:, 2] << 2)
            bmap = bits[:, None, None].expand(bits.shape[0], r, r)
        else:
            # cbf [N,4,3], z-order quadrants; each 32x32 quadrant's
            # 8x8-block range carries its own bits
            qbits = c8[:, :, 0] | (c8[:, :, 1] << 1) | (c8[:, :, 2] << 2)
            half = r // 2
            rows = []
            for qy in range(2):
                cols = [qbits[:, qy * 2 + qx][:, None, None].expand(
                    qbits.shape[0], half, half) for qx in range(2)]
                rows.append(torch.cat(cols, dim=2))
            bmap = torch.cat(rows, dim=1)
        cbf8[byy, bxx] = bmap
        has8[byy, bxx] = 1
        tus8[byy, bxx] = tus.to(torch.uint8)[:, None, None].expand(
            tus.shape[0], r, r)
    return (lvl_y, lvl_cb, lvl_cr, cbf8, has8, rec_y, rec_cb, rec_cr,
            tus8)


def build_inter_pre(src, decisions, refs_padded, qp_slice, p, wp_native,
                    sdh, rdoq_level, mesh=None, slice_type=1, device=None):
    """Assemble the precomputed-residual dict for the native writer.

    src: (y, cb, cr) numpy planes; decisions: FrameDecisions with
    inter8/dir8/mv8/ref8/cu_log2_map/qp_map; refs_padded: ([(y,cb,cr)
    padded int16 numpy, or FramePlanes] per list) — the same references
    handed to the native call; wp_native: (wp[4,3,3] int32, luma_denom,
    chroma_denom) or None.
    Returns the `pre` dict for native.encode_slice_px, or None when there
    is nothing to precompute. Lanes are the true CU count of each size
    class: eager PyTorch has no compile to protect with a fixed batch
    shape, so there are no padding lanes and nothing to drop.

    mesh (Encoder.attach_mesh): refused with NotImplementedError where
    there is something to precompute. The JAX package's mesh branch
    shards the CU lanes and fails while tracing _inter_multi
    (TracerBoolConversionError), so there is no reference stream to
    match; a mesh encode runs with use_tpu_residual = False or under
    noise reduction, where this function is not called.
    """
    from x265_tpu_torch.engine.planes import FramePlanes
    from x265_tpu_torch.hevc.rate_model import slice_rate_consts
    from x265_tpu_torch.utils import devcache
    device = resolve_device(device)
    if decisions.inter8 is None or not np.any(decisions.inter8):
        return None
    h, w = src[0].shape
    h8, w8 = decisions.cu_log2_map.shape
    bd = p.bit_depth
    pad = 80

    def stack_refs(lst, plane):
        if not lst:
            return None             # list 1 of a P slice: never read
        def one(r):
            if isinstance(r, FramePlanes):
                # device-resident anchor: padded ON DEVICE
                return r.dev_padded(pad)[plane]
            # host planes: per-plane cached uploads (anchors serve many
            # frames)
            return devcache.get_or(
                ("ref80", id(r[plane]), str(device)), r[plane],
                lambda rr=r[plane]: torch.from_numpy(np.ascontiguousarray(
                    np.asarray(rr, np.int16))).to(device))
        return torch.stack([one(r) for r in lst])

    r0y = stack_refs(refs_padded[0], 0)
    r0cb = stack_refs(refs_padded[0], 1)
    r0cr = stack_refs(refs_padded[0], 2)
    r1y = stack_refs(refs_padded[1], 0)
    r1cb = stack_refs(refs_padded[1], 1)
    r1cr = stack_refs(refs_padded[1], 2)
    sy = devcache.src_plane(src[0], bd, device)
    scb = devcache.src_plane(src[1], bd, device)
    scr = devcache.src_plane(src[2], bd, device)

    inter8 = decisions.inter8.astype(bool)
    ref8 = (decisions.ref8 if decisions.ref8 is not None
            else np.zeros((h8, w8), np.int32))
    qmap = decisions.qp_map
    ctb_l2 = p.ctb_log2
    any_pre = False
    classes = []
    # --tskip: 8x8 CUs have 4x4 chroma TBs with a per-TB transform_skip
    # decision the pre tensors cannot carry — leave that class to the
    # native compute path (which decides identically)
    sizes = (4, 5, 6) if p.tskip else (3, 4, 5, 6)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    for s_log2 in sizes:
        n = 1 << s_log2
        if n > min(h, w):
            continue
        r = n >> 3
        ys8, xs8 = np.nonzero(
            (decisions.cu_log2_map == s_log2) & inter8 &
            ((np.arange(h8)[:, None] % r) == 0) &
            ((np.arange(w8)[None, :] % r) == 0))
        # full CUs only (partial frame-edge CUs stay on the CPU path)
        keep = ((ys8 * 8 + n) <= h) & ((xs8 * 8 + n) <= w)
        ys8, xs8 = ys8[keep], xs8[keep]
        N = len(ys8)
        if N == 0:
            continue
        any_pre = True
        x0 = (xs8 * 8).astype(np.int32)
        y0 = (ys8 * 8).astype(np.int32)
        mv = np.ascontiguousarray(decisions.mv8[ys8, xs8]).astype(np.int32)
        dirm = decisions.dir8[ys8, xs8].astype(np.int32)
        ref_i = ref8[ys8, xs8].astype(np.int32)
        if qmap is not None:
            qp_cu = qmap[y0 >> ctb_l2, x0 >> ctb_l2].astype(np.int32)
        else:
            qp_cu = np.full(N, qp_slice, np.int32)
        classes.append((n, (put(np.stack([x0, y0], 1)), put(mv), put(dirm),
                            put(ref_i), put(qp_cu))))
    if not any_pre:
        return None
    if mesh is not None:
        raise NotImplementedError(
            "the device inter residual under a mesh: the JAX package's "
            "mesh branch fails in _inter_multi "
            "(x265_tpu/models/inter_residual.py, TracerBoolConversionError"
            "), so it has no stream to match; encode with "
            "Encoder.use_tpu_residual = False or under noise reduction")
    if wp_native is not None:
        wp_arr = put(np.asarray(wp_native[0], np.int32))
        wld, wcd = int(wp_native[1]), int(wp_native[2])
    else:
        wp_arr, wld, wcd = None, 0, 0
    kk = None
    psy_fx = 0
    if rdoq_level > 0 and not p.lossless:
        # estBit RDOQ consts from the SLICE qp/type — identical to the
        # native and oracle derivations (hevc/rate_model.py)
        kk = put(np.array(slice_rate_consts(slice_type, qp_slice)))
        if rdoq_level >= 2:
            psy_fx = int(round(p.psy_rdoq * 256))
    # explicit inter RQT level (x265 tuQTMaxInterDepth >= 2,
    # search.cpp:2863): RD-choose TU==CU vs a 4-quad split for the
    # 16/32 classes; the estBit rate rows feed the choice even when
    # RDOQ itself is off
    rqt = bool(p.tu_inter_depth >= 2 and not p.lossless and not p.tskip)
    rate_kk = (put(np.array(slice_rate_consts(slice_type, qp_slice)))
               if rqt else None)
    pouts = _inter_multi_planes(
        sy, scb, scr, r0y, r0cb, r0cr, r1y, r1cb, r1cr,
        tuple(c[1] for c in classes), wp_arr, tuple(c[0] for c in classes),
        bd, bool(sdh), rdoq_level > 0, bool(p.lossless), pad, wld, wcd,
        int(p.cb_qp_offset), int(p.cr_qp_offset),
        bool(p.scaling_lists), kk, psy_fx, rqt, rate_kk)
    (lvl_y, lvl_cb, lvl_cr, cbf8, has8, rec_y, rec_cb, rec_cr,
     tus8) = (t.cpu().numpy() for t in pouts)
    return {"lvl_y": lvl_y, "lvl_cb": lvl_cb, "lvl_cr": lvl_cr,
            "cbf8": cbf8, "has8": has8, "tusplit8": tus8,
            "rec_y": rec_y.astype(np.int16),
            "rec_cb": rec_cb.astype(np.int16),
            "rec_cr": rec_cr.astype(np.int16)}
