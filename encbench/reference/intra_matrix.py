"""Intra prediction as linear operators — the TPU-first formulation.

Every HEVC intra prediction (planar, DC incl. boundary filters, all 33
angular modes incl. negative-angle projection, and the 1:2:1 reference
smoothing) is LINEAR in the 4S+1 reference samples. We therefore express
the entire 35-mode predictor bank as a single weight tensor

    W[35, S*S, 4S+1]   with   pred[m] = W[m] @ ref

so that batched whole-frame mode analysis becomes one MXU contraction
(see x265_tpu_torch.models.intra_frame). This replaces x265's per-PU
intra_pred_allangs asm family (SURVEY.md §2.3, intrapred8_allangs.asm).

Weights are float (exact rational values, no intermediate floor), so the
TPU predictions can differ from the normative integer predictor by <1 LSB;
decisions only — the CABAC finalizer recomputes normative predictions.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from encbench.reference.tables import INTRA_PRED_ANGLE, intra_filter_flag

# ref layout (matches ops.ref.intra.get_ref_samples):
#   ref[0 .. 2S-1]   left column bottom-up  (p[-1][2S-1] .. p[-1][0])
#   ref[2S]          corner p[-1][-1]
#   ref[2S+1 .. 4S]  top row (p[0][-1] .. p[2S-1][-1])


def _left_idx(S, y):      # p[-1][y]
    return 2 * S - 1 - y


def _top_idx(S, x):       # p[x][-1]
    return 2 * S + 1 + x


def _corner_idx(S):
    return 2 * S


def _filter_matrix(S: int) -> np.ndarray:
    """1:2:1 smoothing of the ref array (spec 8.4.4.2.3) as a matrix."""
    R = 4 * S + 1
    F = np.zeros((R, R), dtype=np.float64)
    F[0, 0] = 1.0
    F[R - 1, R - 1] = 1.0
    for i in range(1, R - 1):
        F[i, i - 1] = 0.25
        F[i, i] = 0.5
        F[i, i + 1] = 0.25
    return F


def _planar(S: int) -> np.ndarray:
    R = 4 * S + 1
    W = np.zeros((S * S, R), dtype=np.float64)
    d = 2.0 * S
    for y in range(S):
        for x in range(S):
            p = y * S + x
            W[p, _left_idx(S, y)] += (S - 1 - x) / d
            W[p, _top_idx(S, S)] += (x + 1) / d           # top-right
            W[p, _top_idx(S, x)] += (S - 1 - y) / d
            W[p, _left_idx(S, S)] += (y + 1) / d          # bottom-left
    return W


def _dc(S: int, c_idx: int) -> np.ndarray:
    R = 4 * S + 1
    W = np.zeros((S * S, R), dtype=np.float64)
    dcw = np.zeros(R, dtype=np.float64)
    for i in range(S):
        dcw[_top_idx(S, i)] += 1.0 / (2 * S)
        dcw[_left_idx(S, i)] += 1.0 / (2 * S)
    W[:, :] = dcw[None, :]
    if c_idx == 0 and S < 32:
        # boundary filtering: row0 = (top + 3dc)/4, col0 = (left + 3dc)/4,
        # corner = (left0 + 2dc + top0)/4
        for x in range(1, S):
            W[x, :] = 0.75 * dcw
            W[x, _top_idx(S, x)] += 0.25
        for y in range(1, S):
            p = y * S
            W[p, :] = 0.75 * dcw
            W[p, _left_idx(S, y)] += 0.25
        W[0, :] = 0.5 * dcw
        W[0, _top_idx(S, 0)] += 0.25
        W[0, _left_idx(S, 0)] += 0.25
    return W


def _angular(S: int, mode: int, c_idx: int) -> np.ndarray:
    R = 4 * S + 1
    W = np.zeros((S * S, R), dtype=np.float64)
    angle = int(INTRA_PRED_ANGLE[mode - 2])
    vertical = mode >= 18

    # main reference array as weight rows over ref samples:
    # main[k] for k in [lo .. 2S] (lo = 0 for angle >= 0)
    if angle < 0:
        inv = int(round(8192 / angle))
        lo = (S * angle) >> 5
    else:
        lo = 0
    main = {}  # k -> (ref_index, weight) list
    if vertical:
        main[0] = [(_corner_idx(S), 1.0)]
        for k in range(1, 2 * S + 1):
            if k - 1 < 2 * S:
                main[k] = [(_top_idx(S, k - 1), 1.0)]
        for k in range(lo, 0):
            if k == lo and lo < -1:
                pass  # never addressed
            yy = ((k * inv + 128) >> 8) - 1
            main[k] = [(_corner_idx(S) if yy < 0 else _left_idx(S, yy), 1.0)]
    else:
        main[0] = [(_corner_idx(S), 1.0)]
        for k in range(1, 2 * S + 1):
            main[k] = [(_left_idx(S, k - 1), 1.0)]
        for k in range(lo, 0):
            xx = ((k * inv + 128) >> 8) - 1
            main[k] = [(_corner_idx(S) if xx < 0 else _top_idx(S, xx), 1.0)]

    def acc(p, k, w):
        for (ri, rw) in main.get(k, main[max(main)]):
            W[p, ri] += w * rw

    for j in range(1, S + 1):           # j = y+1 (vertical) or x+1 (horizontal)
        iidx = (j * angle) >> 5
        ifact = (j * angle) & 31
        for i in range(S):              # i = x (vertical) or y (horizontal)
            if vertical:
                p = (j - 1) * S + i
            else:
                p = i * S + (j - 1)
            k = i + iidx + 1
            acc(p, k, (32 - ifact) / 32.0)
            if ifact:
                acc(p, min(k + 1, 2 * S), ifact / 32.0)
            elif False:
                pass
    # pure horizontal/vertical edge filter (modes 10/26, luma, S<32):
    # pred[0][x] += (top[x]-corner)/2 for mode 10; col for 26 (no clip here)
    if c_idx == 0 and S < 32:
        if mode == 26:
            for y in range(S):
                p = y * S
                W[p, :] = 0.0
                W[p, _top_idx(S, 0)] += 1.0
                W[p, _left_idx(S, y)] += 0.5
                W[p, _corner_idx(S)] -= 0.5
        elif mode == 10:
            for x in range(S):
                W[x, :] = 0.0
                W[x, _left_idx(S, 0)] += 1.0
                W[x, _top_idx(S, x)] += 0.5
                W[x, _corner_idx(S)] -= 0.5
    return W


@lru_cache(maxsize=None)
def intra_weight_matrices(S: int, c_idx: int = 0) -> np.ndarray:
    """W[35, S*S, 4S+1] float32 — full 35-mode linear predictor bank,
    reference smoothing folded in per spec filter flags."""
    R = 4 * S + 1
    F = _filter_matrix(S)
    log2 = S.bit_length() - 1
    out = np.zeros((35, S * S, R), dtype=np.float64)
    for mode in range(35):
        if mode == 0:
            Wm = _planar(S)
        elif mode == 1:
            Wm = _dc(S, c_idx)
        else:
            Wm = _angular(S, mode, c_idx)
        if c_idx == 0 and intra_filter_flag(mode, log2):
            Wm = Wm @ F
        out[mode] = Wm
    return out.astype(np.float32)
