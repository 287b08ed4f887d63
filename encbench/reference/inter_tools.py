"""Inter prediction derivations shared by encoder finalizer and decoder:
merge candidate list (spec 8.5.3.2.3-8.5.3.2.5), AMVP predictor list
(8.5.3.2.6-8.5.3.2.8 incl. spatial MV scaling) and MVD binarization
(7.3.8.9 / 9.3.3.8).

Two reference lists (P uses L0 only, B uses L0+L1), multiple refs per
list, TMVP (temporal merge/MVP candidate, 8.5.3.2.7/8.5.3.2.9 with the
16x16 compressed collocated motion field). x265 analog:
getInterMergeCandidates/fillMvpCand in source/common/cudata.cpp and
mergeEstimation in encoder/search.cpp:1891.

Motion is represented as a tuple
    (dir, mv0, mv1, ref0, ref1)
with dir a bitmask (1=L0, 2=L1), mvN quarter-pel (x, y) tuples and refN
reference *indices* into the slice's ref list (-1: list unused).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

MV = Tuple[int, int]
Motion = Tuple[int, MV, MV, int, int]

ZERO_MV: MV = (0, 0)


class InterCtx:
    """Per-picture inter state at 4x4 granularity (two lists)."""

    def __init__(self, h: int, w: int):
        h4, w4 = (h + 3) // 4, (w + 3) // 4
        self.mv4 = np.zeros((h4, w4, 2, 2), dtype=np.int32)   # [list][x,y]
        self.ref4 = np.full((h4, w4, 2), -1, dtype=np.int32)  # -1 = unused
        self.skip4 = np.zeros((h4, w4), dtype=bool)

    def set_block(self, x0: int, y0: int, nw: int, nh: int, m: Motion,
                  skip: bool) -> None:
        s = (slice(y0 >> 2, (y0 + nh) >> 2), slice(x0 >> 2, (x0 + nw) >> 2))
        dir_, mv0, mv1, r0, r1 = m
        self.mv4[s[0], s[1], 0] = mv0 if (dir_ & 1) else (0, 0)
        self.mv4[s[0], s[1], 1] = mv1 if (dir_ & 2) else (0, 0)
        self.ref4[s[0], s[1], 0] = r0 if (dir_ & 1) else -1
        self.ref4[s[0], s[1], 1] = r1 if (dir_ & 2) else -1
        self.skip4[s] = skip


class ColCtx:
    """Collocated picture's motion field at 16x16 granularity (the spec's
    MV storage compression: the PU covering ((x>>4)<<4, (y>>4)<<4)) with
    reference POCs resolved, for TMVP derivation (8.5.3.2.7-8.5.3.2.9)."""

    def __init__(self, poc: int, dir16: np.ndarray, mv16: np.ndarray,
                 refpoc16: np.ndarray):
        self.poc = poc
        self.dir16 = dir16            # [h16,w16] bitmask; 0 = intra
        self.mv16 = mv16              # [h16,w16,2(list),2(xy)]
        self.refpoc16 = refpoc16      # [h16,w16,2]


def temporal_mv(col: ColCtx, x0: int, y0: int, nw: int, nh: int,
                width: int, height: int, ctb_size: int, lx: int,
                target_poc: int, cur_poc: int, no_backward: bool,
                col_from_l0: int) -> Optional[MV]:
    """Temporal luma MV for list lx targeting target_poc (8.5.3.2.7):
    bottom-right C0 (same-CTU-row constraint) then center C1; col list
    choice per 8.5.3.2.9; scaled per 8.5.3.2.8. None if unavailable."""
    if col is None:
        return None
    positions = []
    x_br, y_br = x0 + nw, y0 + nh
    if (x_br < width and y_br < height
            and (y_br // ctb_size) == (y0 // ctb_size)):
        positions.append((x_br, y_br))
    positions.append((x0 + (nw >> 1), y0 + (nh >> 1)))
    for (x, y) in positions:
        i, j = y >> 4, x >> 4
        if i >= col.dir16.shape[0] or j >= col.dir16.shape[1]:
            continue
        d = int(col.dir16[i, j])
        if d == 0:
            continue                      # intra / unavailable
        if d == 1:
            ly = 0
        elif d == 2:
            ly = 1
        elif no_backward:
            ly = lx                       # all refs in the past: use X
        else:
            ly = col_from_l0              # N = collocated_from_l0_flag
        mv = (int(col.mv16[i, j, ly, 0]), int(col.mv16[i, j, ly, 1]))
        tb = cur_poc - target_poc
        td = col.poc - int(col.refpoc16[i, j, ly])
        return _scale_mv(mv, tb, td)
    return None


def no_backward_pred(ref_poc: Sequence[Sequence[int]],
                     cur_poc: int) -> bool:
    """NoBackwardPredFlag (8.5.3): every ref POC <= current POC."""
    return all(p <= cur_poc for lst in ref_poc for p in lst)


def _neighbor(ic: InterCtx, avail4: np.ndarray, x: int, y: int,
              width: int, height: int) -> Optional[Motion]:
    """Full motion of the 4x4 block at luma (x, y), or None."""
    if x < 0 or y < 0 or x >= width or y >= height:
        return None
    i, j = y >> 2, x >> 2
    if not avail4[i, j]:
        return None
    r0, r1 = int(ic.ref4[i, j, 0]), int(ic.ref4[i, j, 1])
    if r0 < 0 and r1 < 0:
        return None            # intra
    dir_ = (1 if r0 >= 0 else 0) | (2 if r1 >= 0 else 0)
    return (dir_,
            (int(ic.mv4[i, j, 0, 0]), int(ic.mv4[i, j, 0, 1])),
            (int(ic.mv4[i, j, 1, 0]), int(ic.mv4[i, j, 1, 1])),
            r0, r1)


def _same_motion(a: Motion, b: Motion) -> bool:
    """Spec compares per-list mv + refIdx (8.5.3.2.3 candidate pruning)."""
    if a[0] != b[0]:
        return False
    if (a[0] & 1) and (a[1] != b[1] or a[3] != b[3]):
        return False
    if (a[0] & 2) and (a[2] != b[2] or a[4] != b[4]):
        return False
    return True


# combined bi-pred candidate index pairs (Table 8-8 combCandList)
_COMB_PAIRS = ((0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1),
               (0, 3), (3, 0), (1, 3), (3, 1), (2, 3), (3, 2))


def merge_candidates(ic: InterCtx, avail4: np.ndarray, x0: int, y0: int,
                     nw: int, nh: int, width: int, height: int,
                     max_cand: int, ctb_size: int, is_b: bool = False,
                     ref_poc: Sequence[Sequence[int]] = ((0,), ()),
                     col: Optional[ColCtx] = None, col_from_l0: int = 1,
                     cur_poc: int = 0) -> List[Motion]:
    """Merge list: spatial A1,B1,B0,A0,B2 + temporal (TMVP, when col is
    given) + (B) combined bi + zero fill."""
    a1 = _neighbor(ic, avail4, x0 - 1, y0 + nh - 1, width, height)
    b1 = _neighbor(ic, avail4, x0 + nw - 1, y0 - 1, width, height)
    b0 = _neighbor(ic, avail4, x0 + nw, y0 - 1, width, height)
    a0 = _neighbor(ic, avail4, x0 - 1, y0 + nh, width, height)
    b2 = _neighbor(ic, avail4, x0 - 1, y0 - 1, width, height)

    cands: List[Motion] = []
    if a1 is not None:
        cands.append(a1)
    if b1 is not None and not (a1 is not None and _same_motion(b1, a1)):
        cands.append(b1)
    if b0 is not None and not (b1 is not None and _same_motion(b0, b1)):
        cands.append(b0)
    if a0 is not None and not (a1 is not None and _same_motion(a0, a1)):
        cands.append(a0)
    if len(cands) < 4 and b2 is not None and \
            not (a1 is not None and _same_motion(b2, a1)) and \
            not (b1 is not None and _same_motion(b2, b1)):
        cands.append(b2)

    # temporal candidate (8.5.3.2.3 step with refIdx 0; no pruning
    # against the spatial candidates)
    if col is not None and len(cands) < max_cand:
        nb = no_backward_pred(ref_poc, cur_poc)
        mv0 = temporal_mv(col, x0, y0, nw, nh, width, height, ctb_size,
                          0, ref_poc[0][0], cur_poc, nb, col_from_l0)
        mv1 = None
        if is_b and len(ref_poc[1]):
            mv1 = temporal_mv(col, x0, y0, nw, nh, width, height,
                              ctb_size, 1, ref_poc[1][0], cur_poc, nb,
                              col_from_l0)
        if mv0 is not None or mv1 is not None:
            d = (1 if mv0 is not None else 0) | (2 if mv1 is not None else 0)
            cands.append((d, mv0 or ZERO_MV, mv1 or ZERO_MV,
                          0 if mv0 is not None else -1,
                          0 if mv1 is not None else -1))

    # combined bi-predictive candidates (8.5.3.2.4), B slices only
    if is_b and len(cands) > 1 and len(cands) < max_cand:
        n_orig = len(cands)
        for (i, j) in _COMB_PAIRS:
            if len(cands) >= max_cand:
                break
            if i >= n_orig or j >= n_orig:
                continue
            ci, cj = cands[i], cands[j]
            if not (ci[0] & 1) or not (cj[0] & 2):
                continue
            poc_l0 = ref_poc[0][ci[3]]
            poc_l1 = ref_poc[1][cj[4]]
            if poc_l0 != poc_l1 or ci[1] != cj[2]:
                cands.append((3, ci[1], cj[2], ci[3], cj[4]))

    # zero candidates (8.5.3.2.5)
    nref = (min(len(ref_poc[0]), len(ref_poc[1])) if is_b
            else len(ref_poc[0]))
    zero_idx = 0
    while len(cands) < max_cand:
        r = zero_idx if zero_idx < nref else 0
        if is_b:
            cands.append((3, ZERO_MV, ZERO_MV, r, r))
        else:
            cands.append((1, ZERO_MV, ZERO_MV, r, -1))
        zero_idx += 1
    return cands[:max_cand]


# ---------------------------------------------------------------------------
# AMVP (8.5.3.2.6-8.5.3.2.8)
# ---------------------------------------------------------------------------

def _scale_mv(mv: MV, tb: int, td: int) -> MV:
    """Temporal-distance MV scaling (8.5.3.2.8 equations 8-175..8-177)."""
    if td == tb:
        return mv
    td = max(-128, min(127, td))
    tb = max(-128, min(127, tb))
    q = 16384 + (abs(td) >> 1)
    tx = (q // td) if td > 0 else -(q // -td)
    dsf = max(-4096, min(4095, (tb * tx + 32) >> 6))

    def sc(v):
        p = dsf * v
        s = (abs(p) + 127) >> 8
        return max(-32768, min(32767, s if p >= 0 else -s))

    return (sc(mv[0]), sc(mv[1]))


def _cand_same_poc(m: Motion, lx: int, target_poc: int,
                   ref_poc: Sequence[Sequence[int]]) -> Optional[MV]:
    """First-pass AMVP condition: neighbor motion in list lx, then the
    other list, whose reference picture IS the target picture."""
    for ly in (lx, 1 - lx):
        if m[0] & (1 << ly):
            r = m[3 + ly]
            if r >= 0 and r < len(ref_poc[ly]) and ref_poc[ly][r] == target_poc:
                return m[1 + ly]
    return None


def _cand_scaled(m: Motion, lx: int, target_poc: int, cur_poc: int,
                 ref_poc: Sequence[Sequence[int]]) -> Optional[MV]:
    """Second-pass: any motion from list lx then other list, scaled."""
    for ly in (lx, 1 - lx):
        if m[0] & (1 << ly):
            r = m[3 + ly]
            if 0 <= r < len(ref_poc[ly]):
                tb = cur_poc - target_poc
                td = cur_poc - ref_poc[ly][r]
                return _scale_mv(m[1 + ly], tb, td)
    return None


def amvp_candidates(ic: InterCtx, avail4: np.ndarray, x0: int, y0: int,
                    nw: int, nh: int, width: int, height: int,
                    lx: int = 0, ref_idx: int = 0, cur_poc: int = 0,
                    ref_poc: Sequence[Sequence[int]] = ((0,), ()),
                    col: Optional[ColCtx] = None, col_from_l0: int = 1,
                    ctb_size: int = 64) -> List[MV]:
    """AMVP list for (list lx, ref_idx): A from {A0,A1}, B from {B0,B1,B2},
    with the normative scaling/fallback structure; dedup; zero-fill to 2."""
    target_poc = ref_poc[lx][ref_idx]
    a0 = _neighbor(ic, avail4, x0 - 1, y0 + nh, width, height)
    a1 = _neighbor(ic, avail4, x0 - 1, y0 + nh - 1, width, height)
    b0 = _neighbor(ic, avail4, x0 + nw, y0 - 1, width, height)
    b1 = _neighbor(ic, avail4, x0 + nw - 1, y0 - 1, width, height)
    b2 = _neighbor(ic, avail4, x0 - 1, y0 - 1, width, height)

    is_scaled = a0 is not None or a1 is not None

    # --- A: same-poc pass then scaled pass over {A0, A1} ---
    mvp_a: Optional[MV] = None
    for m in (a0, a1):
        if m is None:
            continue
        v = _cand_same_poc(m, lx, target_poc, ref_poc)
        if v is not None:
            mvp_a = v
            break
    if mvp_a is None:
        for m in (a0, a1):
            if m is None:
                continue
            v = _cand_scaled(m, lx, target_poc, cur_poc, ref_poc)
            if v is not None:
                mvp_a = v
                break

    # --- B: same-poc pass over {B0, B1, B2} ---
    mvp_b: Optional[MV] = None
    for m in (b0, b1, b2):
        if m is None:
            continue
        v = _cand_same_poc(m, lx, target_poc, ref_poc)
        if v is not None:
            mvp_b = v
            break

    if not is_scaled:
        # no left neighbors (steps 6-7): B's same-poc result is promoted
        # into A's slot (A found nothing — it had no neighbors), then B is
        # re-derived with the scaled pass
        mvp_a, mvp_b = mvp_b, None
        for m in (b0, b1, b2):
            if m is None:
                continue
            v = _cand_scaled(m, lx, target_poc, cur_poc, ref_poc)
            if v is not None:
                mvp_b = v
                break

    out: List[MV] = []
    if mvp_a is not None:
        out.append(mvp_a)
    if mvp_b is not None and mvp_b != mvp_a:
        out.append(mvp_b)
    if len(out) < 2 and col is not None:
        v = temporal_mv(col, x0, y0, nw, nh, width, height, ctb_size,
                        lx, target_poc, cur_poc,
                        no_backward_pred(ref_poc, cur_poc), col_from_l0)
        if v is not None:
            out.append(v)
    while len(out) < 2:
        out.append(ZERO_MV)
    return out[:2]


# ---------------------------------------------------------------------------
# MVD coding (7.3.8.9; EG1 bypass for abs-2)
# ---------------------------------------------------------------------------

def encode_mvd(cab, ctx_mvd: int, mvd_x: int, mvd_y: int) -> None:
    ax, ay = abs(mvd_x), abs(mvd_y)
    cab.encode_bin(ctx_mvd + 0, 1 if ax > 0 else 0)
    cab.encode_bin(ctx_mvd + 0, 1 if ay > 0 else 0)
    if ax > 0:
        cab.encode_bin(ctx_mvd + 1, 1 if ax > 1 else 0)
    if ay > 0:
        cab.encode_bin(ctx_mvd + 1, 1 if ay > 1 else 0)
    if ax > 0:
        if ax > 1:
            _encode_eg1(cab, ax - 2)
        cab.encode_bin_ep(1 if mvd_x < 0 else 0)
    if ay > 0:
        if ay > 1:
            _encode_eg1(cab, ay - 2)
        cab.encode_bin_ep(1 if mvd_y < 0 else 0)


def decode_mvd(cab, ctx_mvd: int) -> MV:
    g0x = cab.decode_bin(ctx_mvd + 0)
    g0y = cab.decode_bin(ctx_mvd + 0)
    g1x = cab.decode_bin(ctx_mvd + 1) if g0x else 0
    g1y = cab.decode_bin(ctx_mvd + 1) if g0y else 0
    mvd_x = mvd_y = 0
    if g0x:
        ax = 1 + (1 + _decode_eg1(cab) if g1x else 0)
        mvd_x = -ax if cab.decode_bin_ep() else ax
    if g0y:
        ay = 1 + (1 + _decode_eg1(cab) if g1y else 0)
        mvd_y = -ay if cab.decode_bin_ep() else ay
    return (mvd_x, mvd_y)


def _encode_eg1(cab, value: int) -> None:
    """Exp-Golomb order-1, bypass bins (spec 9.3.3.3 with k=1)."""
    k = 1
    while value >= (1 << k):
        cab.encode_bin_ep(1)
        value -= 1 << k
        k += 1
    cab.encode_bin_ep(0)
    for i in range(k - 1, -1, -1):
        cab.encode_bin_ep((value >> i) & 1)


def _decode_eg1(cab) -> int:
    k = 1
    value = 0
    while cab.decode_bin_ep():
        value += 1 << k
        k += 1
    suffix = 0
    for _ in range(k):
        suffix = (suffix << 1) | cab.decode_bin_ep()
    return value + suffix
