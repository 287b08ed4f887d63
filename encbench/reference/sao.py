"""Sample Adaptive Offset (spec 7.3.8.3 syntax, 8.7.3 process; x265
analog encoder/sao.cpp — calcSaoStatsCTU:735, rdoSaoUnitCu:1225,
applyPixelOffsets:274).

Design split (SURVEY.md §7.1): statistics + parameter decisions are dense
whole-frame array math over the deblocked recon (EO category counting and
BO histograms vectorized across all CTUs at once); only the per-CTU
syntax emission is serial. The filter itself is applied full-frame from
per-CTU parameter maps.

Parameter maps per plane-group (shape [ctbs_y, ctbs_x]):
  type:   0=off, 1=BO, 2=EO
  eo_class / band_position
  offsets[4]
Chroma shares type + eo_class between Cb and Cr (7.3.8.3), offsets and
band positions are per-component.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

SAO_OFF, SAO_BO, SAO_EO = 0, 1, 2

# EO class -> (neighbor a offset, neighbor b offset) in (dy, dx)
EO_DIRS = ((0, -1), (-1, 0), (-1, -1), (-1, 1))


@dataclass
class SaoParams:
    """Per-frame SAO parameter maps (None => SAO off for the frame)."""
    # luma
    type_y: np.ndarray = None          # [cy, cx] int
    class_y: np.ndarray = None         # eo class or band position
    off_y: np.ndarray = None           # [cy, cx, 4] int
    # chroma (type/class shared cb+cr)
    type_c: np.ndarray = None
    class_cb: np.ndarray = None        # eo class (shared) or band pos (cb)
    class_cr: np.ndarray = None        # band pos (cr); == class_cb for EO
    off_cb: np.ndarray = None
    off_cr: np.ndarray = None


def _eo_categories(rec: np.ndarray, eo_class: int) -> np.ndarray:
    """Per-pixel EO category 0..4 (8.7.3: 1=valley,2=half-valley,
    3=half-peak,4=peak); 0 where a neighbor is outside the picture."""
    # the out-of-picture sentinel is 1<<20: narrow dtypes would wrap it
    rec = np.asarray(rec, dtype=np.int32)
    H, W = rec.shape
    (day, dax) = EO_DIRS[eo_class]
    dby, dbx = -day, -dax
    a = np.full_like(rec, 1 << 20)
    b = np.full_like(rec, 1 << 20)
    ys = slice(max(0, day), H + min(0, day))
    xs = slice(max(0, dax), W + min(0, dax))
    ys_s = slice(max(0, -day), H + min(0, -day))
    xs_s = slice(max(0, -dax), W + min(0, -dax))
    a[ys_s, xs_s] = rec[ys, xs]
    ys2 = slice(max(0, dby), H + min(0, dby))
    xs2 = slice(max(0, dbx), W + min(0, dbx))
    ys2_s = slice(max(0, -dby), H + min(0, -dby))
    xs2_s = slice(max(0, -dbx), W + min(0, -dbx))
    b[ys2_s, xs2_s] = rec[ys2, xs2]
    valid = (a != (1 << 20)) & (b != (1 << 20))
    sa = np.sign(rec - a)
    sb = np.sign(rec - b)
    s = sa + sb
    cat = np.zeros(rec.shape, dtype=np.int8)
    cat[s == -2] = 1
    cat[(s == -1)] = 2
    cat[(s == 1)] = 3
    cat[s == 2] = 4
    cat[~valid] = 0
    return cat


def _ctu_reduce(v: np.ndarray, cy: int, cx: int, ctb: int) -> np.ndarray:
    """Sum v over CTU tiles -> [cy, cx] (pads bottom/right with zeros)."""
    H, W = v.shape
    out = np.zeros((cy * ctb, cx * ctb), dtype=np.int64)
    out[:H, :W] = v
    return out.reshape(cy, ctb, cx, ctb).sum(axis=(1, 3))


def _eo_stats(src, rec, cy, cx, ctb):
    """count[eo, cat, cy, cx], diff_sum[eo, cat, cy, cx] for cats 1..4."""
    cnt = np.zeros((4, 5, cy, cx), dtype=np.int64)
    dsum = np.zeros((4, 5, cy, cx), dtype=np.int64)
    diff = (src - rec).astype(np.int64)
    for eo in range(4):
        cat = _eo_categories(rec, eo)
        for c in range(1, 5):
            m = cat == c
            cnt[eo, c] = _ctu_reduce(m.astype(np.int64), cy, cx, ctb)
            dsum[eo, c] = _ctu_reduce(np.where(m, diff, 0), cy, cx, ctb)
    return cnt, dsum


def _bo_stats(src, rec, cy, cx, ctb, bd):
    """count[band, cy, cx], diff_sum[band, cy, cx] for the 32 bands."""
    band = (rec >> (bd - 5)).astype(np.int32)
    diff = (src - rec).astype(np.int64)
    cnt = np.zeros((32, cy, cx), dtype=np.int64)
    dsum = np.zeros((32, cy, cx), dtype=np.int64)
    for b in range(32):
        m = band == b
        cnt[b] = _ctu_reduce(m.astype(np.int64), cy, cx, ctb)
        dsum[b] = _ctu_reduce(np.where(m, diff, 0), cy, cx, ctb)
    return cnt, dsum


def _best_offset(cnt, dsum, lo, hi):
    """Distortion-optimal offset in [lo, hi] and its delta-distortion
    (dD = n*h^2 - 2*h*e; x265 estSaoDist, sao.cpp:1105)."""
    n = cnt
    e = dsum
    with np.errstate(divide="ignore", invalid="ignore"):
        h = np.where(n > 0, np.round(e / np.maximum(n, 1)), 0)
    h = np.clip(h, lo, hi).astype(np.int64)
    # refine by checking h and h+-1 (rounding ties)
    best_d = None
    best_h = h
    for dh in (-1, 0, 1):
        hh = np.clip(h + dh, lo, hi)
        d = n * hh * hh - 2 * hh * e
        if best_d is None:
            best_d, best_h = d, hh
        else:
            take = d < best_d
            best_d = np.where(take, d, best_d)
            best_h = np.where(take, hh, best_h)
    return best_h, best_d


def analyze_plane(src: np.ndarray, rec: np.ndarray, ctb: int, cy: int,
                  cx: int, lam: float, bd: int = 8, stats=None):
    """Per-CTU best SAO params for one plane.

    Returns (type, cls, offsets[4], gain) arrays; gain = -(dD + lam*bits)
    clipped at 0 (off has gain 0).
    """
    max_off = (1 << (min(bd, 10) - 5)) - 1
    if stats is not None:
        ecnt, esum, bcnt_pre, bsum_pre = [np.asarray(a, np.int64)
                                          for a in stats]
    else:
        ecnt, esum = _eo_stats(src, rec, cy, cx, ctb)
        bcnt_pre = bsum_pre = None
    # EO: cats 1,2 positive offsets; 3,4 negative
    eo_cost = np.zeros((4, cy, cx), dtype=np.float64)
    eo_offs = np.zeros((4, 4, cy, cx), dtype=np.int64)
    for eo in range(4):
        tot = np.zeros((cy, cx), dtype=np.float64)
        for c in range(1, 5):
            lo, hi = (0, max_off) if c <= 2 else (-max_off, 0)
            h, d = _best_offset(ecnt[eo, c], esum[eo, c], lo, hi)
            eo_offs[eo, c - 1] = h
            tot += d + lam * (np.abs(h) + 1)      # ~TR bits per offset
        eo_cost[eo] = tot + lam * 3               # type + class bits
    if bcnt_pre is not None:
        bcnt, bsum = bcnt_pre, bsum_pre
    else:
        bcnt, bsum = _bo_stats(src, rec, cy, cx, ctb, bd)
    bh, bdist = _best_offset(bcnt, bsum, -max_off, max_off)
    # best 4-band window
    win = np.stack([sum(bdist[(s + i) % 32] for i in range(4))
                    for s in range(29)])          # band_position <= 28
    bo_pos = np.argmin(win, axis=0)
    bo_cost = win.min(axis=0) + lam * (8 + 5)
    bo_offs = np.stack([np.take_along_axis(
        bh, (bo_pos + i)[None, :, :], axis=0)[0] for i in range(4)])

    eo_best = np.argmin(eo_cost, axis=0)
    eo_best_cost = eo_cost.min(axis=0)
    use_bo = bo_cost < eo_best_cost
    cost = np.where(use_bo, bo_cost, eo_best_cost)
    typ = np.where(cost < 0, np.where(use_bo, SAO_BO, SAO_EO), SAO_OFF)
    cls = np.where(use_bo, bo_pos, eo_best)
    idx = np.broadcast_to(eo_best[None, None], (1, 4, cy, cx))
    eo_sel = np.take_along_axis(eo_offs, idx, axis=0)[0]   # [4, cy, cx]
    offs = np.where(use_bo[None], bo_offs, eo_sel)
    offs = np.where((typ == SAO_OFF)[None], 0, offs)
    cls = np.where(typ == SAO_OFF, 0, cls)
    return (typ.astype(np.int32), cls.astype(np.int32),
            np.moveaxis(offs, 0, -1).astype(np.int32),
            np.where(cost < 0, -cost, 0.0))



def apply_plane(rec: np.ndarray, typ, cls, offs, ctb: int, bd: int = 8):
    """Apply SAO offsets to one plane from per-CTU maps (vectorized:
    category/band computed full-frame, offsets gathered per pixel)."""
    H, W = rec.shape
    cy, cx = typ.shape
    maxv = (1 << bd) - 1
    iy = np.minimum(np.arange(H) // ctb, cy - 1)
    ix = np.minimum(np.arange(W) // ctb, cx - 1)
    ptyp = typ[np.ix_(iy, ix)]
    pcls = cls[np.ix_(iy, ix)]
    out = rec.astype(np.int64)
    add = np.zeros((H, W), dtype=np.int64)

    # EO
    for eo in range(4):
        sel = (ptyp == SAO_EO) & (pcls == eo)
        if not sel.any():
            continue
        cat = _eo_categories(rec, eo)
        for c in range(1, 5):
            o = offs[..., c - 1][np.ix_(iy, ix)]
            add += np.where(sel & (cat == c), o, 0)
    # BO
    selb = ptyp == SAO_BO
    if selb.any():
        band = (rec >> (bd - 5)).astype(np.int64)
        for i in range(4):
            bmatch = band == ((pcls + i) % 32)
            o = offs[..., i][np.ix_(iy, ix)]
            add += np.where(selb & bmatch, o, 0)
    return np.clip(out + add, 0, maxv).astype(np.int32)


def apply_frame(rec_planes, sp: SaoParams, ctb_log2: int, bd: int = 8):
    ctb = 1 << ctb_log2
    y = apply_plane(rec_planes[0], sp.type_y, sp.class_y, sp.off_y, ctb, bd)
    cb = apply_plane(rec_planes[1], sp.type_c, sp.class_cb, sp.off_cb,
                     ctb >> 1, bd)
    cr = apply_plane(rec_planes[2], sp.type_c, sp.class_cr, sp.off_cr,
                     ctb >> 1, bd)
    return y, cb, cr


# ---------------------------------------------------------------------------
# syntax (7.3.8.3 sao()) — shared bin sequence for writer and decoder
# ---------------------------------------------------------------------------

def _params_equal(sp: SaoParams, ay, ax, by, bx) -> bool:
    return (sp.type_y[ay, ax] == sp.type_y[by, bx] and
            sp.class_y[ay, ax] == sp.class_y[by, bx] and
            (sp.off_y[ay, ax] == sp.off_y[by, bx]).all() and
            sp.type_c[ay, ax] == sp.type_c[by, bx] and
            sp.class_cb[ay, ax] == sp.class_cb[by, bx] and
            sp.class_cr[ay, ax] == sp.class_cr[by, bx] and
            (sp.off_cb[ay, ax] == sp.off_cb[by, bx]).all() and
            (sp.off_cr[ay, ax] == sp.off_cr[by, bx]).all())


def _write_tr_offset(cab, v: int, cmax: int) -> None:
    for i in range(v):
        cab.encode_bin_ep(1)
    if v < cmax:
        cab.encode_bin_ep(0)


def _read_tr_offset(cab, cmax: int) -> int:
    v = 0
    while v < cmax and cab.decode_bin_ep():
        v += 1
    return v


def write_sao_ctu(cab, ctx_off, sp: SaoParams, cy_i: int, cx_i: int,
                  sao_luma: bool, sao_chroma: bool, bd: int = 8) -> None:
    max_off = (1 << (min(bd, 10) - 5)) - 1
    if cx_i > 0:
        if _params_equal(sp, cy_i, cx_i, cy_i, cx_i - 1):
            cab.encode_bin(ctx_off["sao_merge"], 1)
            return
        cab.encode_bin(ctx_off["sao_merge"], 0)
    if cy_i > 0:
        if _params_equal(sp, cy_i, cx_i, cy_i - 1, cx_i):
            cab.encode_bin(ctx_off["sao_merge"], 1)
            return
        cab.encode_bin(ctx_off["sao_merge"], 0)
    for c_idx in range(3):
        if c_idx == 0 and not sao_luma:
            continue
        if c_idx > 0 and not sao_chroma:
            continue
        typ = int(sp.type_y[cy_i, cx_i] if c_idx == 0
                  else sp.type_c[cy_i, cx_i])
        if c_idx == 0 or c_idx == 1:
            cab.encode_bin(ctx_off["sao_type"], 1 if typ != SAO_OFF else 0)
            if typ != SAO_OFF:
                cab.encode_bin_ep(1 if typ == SAO_EO else 0)
        if typ == SAO_OFF:
            continue
        offs = (sp.off_y if c_idx == 0 else
                (sp.off_cb if c_idx == 1 else sp.off_cr))[cy_i, cx_i]
        cls = int((sp.class_y if c_idx == 0 else
                   (sp.class_cb if c_idx == 1 else sp.class_cr))[cy_i, cx_i])
        for i in range(4):
            _write_tr_offset(cab, abs(int(offs[i])), max_off)
        if typ == SAO_BO:
            for i in range(4):
                if offs[i]:
                    cab.encode_bin_ep(1 if offs[i] < 0 else 0)
            cab.encode_bins_ep(cls, 5)
        elif c_idx in (0, 1):
            cab.encode_bins_ep(cls, 2)


def parse_sao_ctu(cab, ctx_off, sp: SaoParams, cy_i: int, cx_i: int,
                  sao_luma: bool, sao_chroma: bool, bd: int = 8,
                  first_row_of_slice: bool = False) -> None:
    """Decoder-side sao(); fills sp maps at (cy_i, cx_i).

    first_row_of_slice: the above CTB belongs to a previous slice
    segment, so the up-merge bin is absent (7.3.8.3 condition on
    CtbAddrInTs / slice segment; mirrors write_sao in
    native/slice_writer.cpp)."""
    max_off = (1 << (min(bd, 10) - 5)) - 1

    def copy_from(sy, sx):
        sp.type_y[cy_i, cx_i] = sp.type_y[sy, sx]
        sp.class_y[cy_i, cx_i] = sp.class_y[sy, sx]
        sp.off_y[cy_i, cx_i] = sp.off_y[sy, sx]
        sp.type_c[cy_i, cx_i] = sp.type_c[sy, sx]
        sp.class_cb[cy_i, cx_i] = sp.class_cb[sy, sx]
        sp.class_cr[cy_i, cx_i] = sp.class_cr[sy, sx]
        sp.off_cb[cy_i, cx_i] = sp.off_cb[sy, sx]
        sp.off_cr[cy_i, cx_i] = sp.off_cr[sy, sx]

    if cx_i > 0 and cab.decode_bin(ctx_off["sao_merge"]):
        copy_from(cy_i, cx_i - 1)
        return
    if cy_i > 0 and not first_row_of_slice and \
            cab.decode_bin(ctx_off["sao_merge"]):
        copy_from(cy_i - 1, cx_i)
        return
    shared_type = SAO_OFF
    shared_class = 0
    for c_idx in range(3):
        if c_idx == 0 and not sao_luma:
            continue
        if c_idx > 0 and not sao_chroma:
            continue
        if c_idx in (0, 1):
            typ = SAO_OFF
            if cab.decode_bin(ctx_off["sao_type"]):
                typ = SAO_EO if cab.decode_bin_ep() else SAO_BO
            if c_idx == 1:
                shared_type = typ
        else:
            typ = shared_type
        if c_idx == 0:
            sp.type_y[cy_i, cx_i] = typ
        else:
            sp.type_c[cy_i, cx_i] = typ
        if typ == SAO_OFF:
            continue
        absoffs = [_read_tr_offset(cab, max_off) for _ in range(4)]
        if typ == SAO_BO:
            offs = []
            for a in absoffs:
                if a and cab.decode_bin_ep():
                    offs.append(-a)
                else:
                    offs.append(a)
            pos = cab.decode_bins_ep(5)
            cls = pos
        else:
            # EO: signs inferred (+,+,-,-)
            offs = [absoffs[0], absoffs[1], -absoffs[2], -absoffs[3]]
            if c_idx in (0, 1):
                cls = cab.decode_bins_ep(2)
                if c_idx == 1:
                    shared_class = cls
            else:
                cls = shared_class
        if c_idx == 0:
            sp.class_y[cy_i, cx_i] = cls
            sp.off_y[cy_i, cx_i] = offs
        elif c_idx == 1:
            sp.class_cb[cy_i, cx_i] = cls
            sp.off_cb[cy_i, cx_i] = offs
            if typ == SAO_EO:
                shared_class = cls
        else:
            sp.class_cr[cy_i, cx_i] = cls
            sp.off_cr[cy_i, cx_i] = offs


def empty_params(cy: int, cx: int) -> SaoParams:
    z = lambda *s: np.zeros(s, dtype=np.int32)
    return SaoParams(type_y=z(cy, cx), class_y=z(cy, cx), off_y=z(cy, cx, 4),
                     type_c=z(cy, cx), class_cb=z(cy, cx),
                     class_cr=z(cy, cx), off_cb=z(cy, cx, 4),
                     off_cr=z(cy, cx, 4))
