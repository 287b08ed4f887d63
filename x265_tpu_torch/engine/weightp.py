"""Weighted-prediction analysis for P slices (fades / brightness ramps).

Reference analog: x265 weightAnalyse (weightPrediction.cpp:480) — fit a
global luma scale+offset per (frame, ref) by least squares on subsampled
planes, then keep the weight only when it actually reduces SAD by a
margin.  Deviation from the reference: the fit is a closed-form moment match on a
4x-decimated grid (two means, a variance, a covariance), so it's four
reductions — no iterative search like the reference's chroma loop.

References live on the device (FramePlanes); the fit reads only the
4x-decimated grid, downloaded once per anchor (host_decimated4 — 1/16
of the plane bytes), and the weighted search reference is built ON
DEVICE (weight_luma_me_handle), so the full-size weighted plane is never
downloaded. Counterpart of x265_tpu/engine/weightp.py.

The resulting weights use the pred_weight_table explicit form
(7.3.6.3 / 8.5.4.2.3.2): denom 6 (matching x265's default denom), weight
in [1, 127], offset in [-128, 127].
"""
import numpy as np
import torch

DENOM = 6  # x265 weightPrediction.cpp: luma/chroma log2 denom default


def _fit(c: np.ndarray, r: np.ndarray, bd: int):
    """Closed-form (w, off) moment fit at denom 6 on PRE-DECIMATED
    ([::4, ::4]) planes; None if unweighted."""
    c = c.astype(np.float64)
    r = r.astype(np.float64)
    mr, mc = r.mean(), c.mean()
    vr = ((r - mr) ** 2).mean()
    if vr < 1e-3:
        a = 1.0
    else:
        a = ((r - mr) * (c - mc)).mean() / vr
    w = int(round(np.clip(a, 1.0 / (1 << DENOM), 127.0 / (1 << DENOM))
                  * (1 << DENOM)))
    off = int(round(mc - (w * mr) / (1 << DENOM)))
    off = int(np.clip(off >> (bd - 8), -128, 127)) if bd > 8 else \
        int(np.clip(off, -128, 127))
    if w == (1 << DENOM) and off == 0:
        return None
    # keep only if weighted SAD clearly beats unweighted (x265 uses the
    # same accept test: weighted cost < unweighted cost, with a margin)
    o_px = off << (bd - 8)
    pred = np.clip(r * w / (1 << DENOM) + o_px, 0, (1 << bd) - 1)
    sad_w = np.abs(c - pred).sum()
    sad_u = np.abs(c - r).sum()
    if sad_w * 1.03 >= sad_u:
        return None
    return w, off


def _dec4(planes):
    """4x-decimated (y, cb, cr): a device-resident FramePlanes downloads
    only the decimated grid; host planes slice in place."""
    if hasattr(planes, "host_decimated4"):
        return planes.host_decimated4()
    return tuple(np.asarray(p)[::4, ::4] for p in planes)


def analyze_slice_weights(cur_planes, ref_planes, bd: int = 8):
    """-> (luma (w, off) | None, chroma ((wcb, ocb), (wcr, ocr)) | None).

    Chroma gets an offset-only weight (scale fixed at 1<<DENOM) — fades to
    black/white shift chroma toward the midpoint much less than luma, and
    an offset captures most of the gain (same simplification x265 applies
    when chroma denom search fails).
    """
    cd = _dec4(cur_planes)
    rd = _dec4(ref_planes)
    luma = _fit(cd[0], rd[0], bd)
    chroma = None
    if luma is not None:
        offs = []
        for i in (1, 2):
            c = cd[i].astype(np.float64)
            r = rd[i].astype(np.float64)
            d = int(round(c.mean() - r.mean())) >> (bd - 8) if bd > 8 \
                else int(round(c.mean() - r.mean()))
            offs.append(int(np.clip(d, -128, 127)))
        if any(abs(o) >= 2 for o in offs):
            chroma = (((1 << DENOM), offs[0]), ((1 << DENOM), offs[1]))
    return luma, chroma


def weight_plane(plane: np.ndarray, w: int, off: int, bd: int = 8):
    """Apply (w, off, DENOM) to a pixel-domain plane — used to bias the
    motion search toward the weighted reference (approximate: the real
    weighting happens at 14-bit post-interpolation in the writers)."""
    o_px = off << (bd - 8)
    v = (plane.astype(np.int64) * w) >> DENOM
    return np.clip(v + o_px, 0, (1 << bd) - 1).astype(plane.dtype)


def weight_luma_me_handle(ref, w: int, off: int, bd: int = 8):
    """Motion-search reference under a luma weight: device-resident refs
    weight ON DEVICE (an MELuma handle); host refs use the numpy
    weight_plane. Bit-identical either way."""
    from x265_tpu_torch.engine.planes import FramePlanes, MELuma
    if isinstance(ref, FramePlanes):
        return MELuma(_weight_dev(ref.dev()[0], int(w), int(off), bd), bd=bd)
    return weight_plane(np.asarray(ref[0]), w, off, bd)


def _weight_dev(pl, w, off, bd):
    """weight_plane on a device plane -> int16 (counterpart of the JAX
    package's _weight_dev; int32 inside, arithmetic shift)."""
    o_px = off << (bd - 8)
    v = (pl.to(torch.int32) * w) >> DENOM
    return (v + o_px).clamp(0, (1 << bd) - 1).to(torch.int16)
