"""Depth-reducing dither (x265_dither_image analog, x265.h:2150-2156).

x265 dithers when the source depth exceeds the encoder's internal depth
(--dither, source/common/picyuv.cpp ditherPlane): a 1D error-diffusion
along each row so banding from straight truncation becomes blue-ish
noise.  Same idea here — err carries the rounding residue to the next
pixel in the row:

    v      = pix[x] + err
    out[x] = clip((v + half) >> shift)
    err    = v - (out[x] << shift)

Rows are independent, so the whole plane vectorizes over rows with one
sequential scan along x (numpy loop over columns: W iterations of
H-element vector ops — fast enough for an I/O-side conversion; this
never sits on the encode path).
"""
from __future__ import annotations

import numpy as np


def dither_plane(plane: np.ndarray, shift: int, max_val: int) -> np.ndarray:
    """Reduce one plane by `shift` bits with row-wise error diffusion."""
    if shift <= 0:
        return np.clip(plane, 0, max_val)
    src = plane.astype(np.int32)
    h, w = src.shape
    out = np.empty((h, w), dtype=np.int32)
    half = 1 << (shift - 1)
    lsb = 1 << shift
    err = np.zeros(h, dtype=np.int32)            # per-row carried error
    for x in range(w):
        v = src[:, x] + err
        q = np.clip((v + half) >> shift, 0, max_val)
        out[:, x] = q
        err = v - (q << shift)
        np.clip(err, -lsb, lsb, out=err)         # bound at clip edges
    return out


def dither_image(planes, src_depth: int, dst_depth: int):
    """x265_dither_image: convert (y, cb, cr) from src_depth to dst_depth
    with error-diffusion; pass-through when no reduction is needed."""
    shift = src_depth - dst_depth
    maxv = (1 << dst_depth) - 1
    if shift <= 0:
        return tuple(np.clip(np.asarray(p), 0, maxv) for p in planes)
    return tuple(dither_plane(np.asarray(p), shift, maxv) for p in planes)
