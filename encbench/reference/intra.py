"""Reference (numpy) HEVC intra prediction — spec 8.4.4.2.

This is the golden model for the batched TPU kernels in
``x265_tpu_torch.ops.intra`` (TestBench pattern, SURVEY.md §4) and the production
predictor of the in-repo reference decoder. x265's analogous C code:
source/common/intrapred.cpp:32-240.

Modes: 0=Planar, 1=DC, 2..34 angular (10=horizontal, 26=vertical).
"""
from __future__ import annotations

import numpy as np

from encbench.reference.tables import INTRA_PRED_ANGLE, intra_filter_flag


def get_ref_samples(plane: np.ndarray, avail4: np.ndarray, x0: int, y0: int,
                    nt: int, bit_depth: int = 8) -> np.ndarray:
    """Gather the 4*nT+1 intra reference samples with substitution.

    plane:  reconstructed sample plane [H, W] (int dtype)
    avail4: bool [H/4, W/4] — True where samples are already reconstructed
            (coding-order availability at 4x4 granularity; picture-boundary
            unavailability is implied by the array bounds)
    Returns ``ref`` laid out as a 1-D array of length 4*nT+1:
        ref[0 .. 2nT-1]  = left column bottom-up: p[-1][2nT-1] .. p[-1][0]
        ref[2nT]         = corner p[-1][-1]
        ref[2nT+1 .. 4nT]= top row: p[0][-1] .. p[2nT-1][-1]
    """
    h, w = plane.shape
    n2 = 2 * nt
    ref = np.empty(4 * nt + 1, dtype=np.int32)
    avail = np.zeros(4 * nt + 1, dtype=bool)

    def sample_avail(x: int, y: int) -> bool:
        if x < 0 or y < 0 or x >= w or y >= h:
            return False
        return bool(avail4[y >> 2, x >> 2])

    # left column bottom-up: index i -> p[-1][n2-1-i]
    for i in range(n2):
        y = y0 + n2 - 1 - i
        x = x0 - 1
        if sample_avail(x, y):
            ref[i] = plane[y, x]
            avail[i] = True
    # corner
    if sample_avail(x0 - 1, y0 - 1):
        ref[n2] = plane[y0 - 1, x0 - 1]
        avail[n2] = True
    # top row
    for i in range(n2):
        x = x0 + i
        y = y0 - 1
        if sample_avail(x, y):
            ref[n2 + 1 + i] = plane[y, x]
            avail[n2 + 1 + i] = True

    if not avail.any():
        ref[:] = 1 << (bit_depth - 1)
        return ref
    if not avail.all():
        # substitution scan (spec 8.4.4.2.2): from ref[0] upward
        first = int(np.argmax(avail))
        ref[0] = ref[first] if not avail[0] else ref[0]
        for i in range(1, 4 * nt + 1):
            if not avail[i]:
                ref[i] = ref[i - 1]
    return ref


def filter_ref_samples(ref: np.ndarray, nt: int, mode: int,
                       strong_enabled: bool, bit_depth: int = 8) -> np.ndarray:
    """Reference smoothing (spec 8.4.4.2.3). Luma only."""
    log2 = nt.bit_length() - 1
    if not intra_filter_flag(mode, log2):
        return ref
    n2 = 2 * nt
    corner = n2
    out = ref.copy()
    if (strong_enabled and nt == 32 and
            abs(int(ref[corner]) + int(ref[4 * nt]) - 2 * int(ref[corner + nt])) < (1 << (bit_depth - 5)) and
            abs(int(ref[corner]) + int(ref[0]) - 2 * int(ref[nt])) < (1 << (bit_depth - 5))):
        # strong (bi-linear) smoothing
        c = int(ref[corner])
        topend = int(ref[4 * nt])
        leftend = int(ref[0])
        for x in range(n2 - 1):
            out[corner + 1 + x] = ((63 - x) * c + (x + 1) * topend + 32) >> 6
        for i in range(1, n2):
            # out index i corresponds to p[-1][n2-1-i]; y = n2-1-i
            y = n2 - 1 - i
            out[i] = ((63 - y) * c + (y + 1) * leftend + 32) >> 6
        out[4 * nt] = topend
        out[0] = leftend
        out[corner] = c
    else:
        # 1-2-1 filter along the contiguous ref array (it is geometrically
        # contiguous: left bottom-up, corner, top left-to-right)
        r = ref.astype(np.int64)
        out[1:-1] = ((r[:-2] + 2 * r[1:-1] + r[2:] + 2) >> 2).astype(ref.dtype)
        out[0] = ref[0]
        out[-1] = ref[-1]
    return out


def predict(ref: np.ndarray, nt: int, mode: int, c_idx: int = 0,
            bit_depth: int = 8) -> np.ndarray:
    """Predict an nT x nT block from the (possibly filtered) ref array."""
    n2 = 2 * nt
    corner = n2
    maxval = (1 << bit_depth) - 1
    # spec-coordinate accessors
    top = ref[corner + 1: corner + 1 + n2].astype(np.int32)    # p[0..2nT-1][-1]
    left = ref[corner - 1:: -1].astype(np.int32)               # p[-1][0..2nT-1]
    pcorner = int(ref[corner])

    xs = np.arange(nt)
    if mode == 0:  # planar
        px = top[:nt][None, :].repeat(nt, 0)
        py = left[:nt][:, None].repeat(nt, 1)
        tr = int(top[nt])
        bl = int(left[nt])
        log2 = nt.bit_length() - 1
        pred = ((nt - 1 - xs[None, :]) * py + (xs[None, :] + 1) * tr +
                (nt - 1 - xs[:, None]) * px + (xs[:, None] + 1) * bl + nt) >> (log2 + 1)
        return pred.astype(np.int32)

    if mode == 1:  # DC
        log2 = nt.bit_length() - 1
        dc = (int(top[:nt].sum()) + int(left[:nt].sum()) + nt) >> (log2 + 1)
        pred = np.full((nt, nt), dc, dtype=np.int32)
        if c_idx == 0 and nt < 32:
            pred[0, 1:] = (top[1:nt] + 3 * dc + 2) >> 2
            pred[1:, 0] = (left[1:nt] + 3 * dc + 2) >> 2
            pred[0, 0] = (int(left[0]) + 2 * dc + int(top[0]) + 2) >> 2
        return pred

    angle = int(INTRA_PRED_ANGLE[mode - 2])
    if mode >= 18:
        # vertical-ish: main ref = top
        if angle < 0:
            inv = _inv_angle(angle)
            lo = (nt * angle) >> 5
            main = np.zeros(n2 + 1 - lo, dtype=np.int32)  # main[i] = ref_main[i+lo]
            # projection of the side (left) reference onto the main array;
            # ref_main[lo] is never addressed (min index is lo+1), and when
            # lo == -1 the prediction only reads ref_main[0..] (no extension)
            for x in range(lo + 1, 0):
                yy = ((x * inv + 128) >> 8) - 1     # p[-1][ -1 + ((x*inv+128)>>8) ]
                main[x - lo] = pcorner if yy < 0 else left[yy]
            main[-lo] = pcorner
            main[-lo + 1: -lo + 1 + n2] = top[:n2]
            base = -lo
        else:
            # +1 pad: the vectorized (a, b) read touches index 2nT+1 when
            # iFact==0 at the steepest angle; weight is 0 there.
            main = np.empty(n2 + 2, dtype=np.int32)
            main[0] = pcorner
            main[1:-1] = top[:n2]
            main[-1] = top[n2 - 1]
            base = 0
        ys = np.arange(1, nt + 1)
        iidx = (ys * angle) >> 5
        ifact = (ys * angle) & 31
        cols = xs[None, :] + iidx[:, None] + 1 + base
        a = main[cols]
        b = main[cols + 1]
        pred = ((32 - ifact[:, None]) * a + ifact[:, None] * b + 16) >> 5
        pred = pred.astype(np.int32)
        if mode == 26 and c_idx == 0 and nt < 32:
            col0 = top[0] + ((left[:nt] - pcorner) >> 1)
            pred[:, 0] = np.clip(col0, 0, maxval)
        return pred
    else:
        # horizontal-ish: main ref = left; output transposed relative to above
        if angle < 0:
            inv = _inv_angle(angle)
            lo = (nt * angle) >> 5
            main = np.zeros(n2 + 1 - lo, dtype=np.int32)
            for x in range(lo + 1, 0):
                xx = ((x * inv + 128) >> 8) - 1
                main[x - lo] = pcorner if xx < 0 else top[xx]
            main[-lo] = pcorner
            main[-lo + 1: -lo + 1 + n2] = left[:n2]
            base = -lo
        else:
            main = np.empty(n2 + 2, dtype=np.int32)
            main[0] = pcorner
            main[1:-1] = left[:n2]
            main[-1] = left[n2 - 1]
            base = 0
        ys = np.arange(1, nt + 1)
        iidx = (ys * angle) >> 5
        ifact = (ys * angle) & 31
        rows = xs[None, :] + iidx[:, None] + 1 + base
        a = main[rows]
        b = main[rows + 1]
        predT = ((32 - ifact[:, None]) * a + ifact[:, None] * b + 16) >> 5
        pred = predT.T.astype(np.int32).copy()
        if mode == 10 and c_idx == 0 and nt < 32:
            row0 = left[0] + ((top[:nt] - pcorner) >> 1)
            pred[0, :] = np.clip(row0, 0, maxval)
        return pred


def _inv_angle(angle: int) -> int:
    return int(round(8192 / angle))


def predict_block(plane: np.ndarray, avail4: np.ndarray, x0: int, y0: int,
                  nt: int, mode: int, c_idx: int, strong_smoothing: bool,
                  bit_depth: int = 8) -> np.ndarray:
    """Full intra prediction for one TB (gather + filter + predict)."""
    ref = get_ref_samples(plane, avail4, x0, y0, nt, bit_depth)
    if c_idx == 0:
        ref = filter_ref_samples(ref, nt, mode, strong_smoothing, bit_depth)
    return predict(ref, nt, mode, c_idx, bit_depth)
