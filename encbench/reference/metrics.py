"""Quality metrics: PSNR + SSIM (x265 analog: FrameFilter::processPostRow
PSNR accumulation framefilter.cpp:654+ and calculateSSIM / the
ssim_4x4x2_core primitive, framefilter.cpp:692-710)."""
from __future__ import annotations

import numpy as np


def psnr(ref: np.ndarray, rec: np.ndarray, bd: int = 8) -> float:
    maxv = (1 << bd) - 1
    mse = float(np.mean((ref.astype(np.int64) - rec.astype(np.int64)) ** 2))
    if mse <= 0:
        return 99.99
    return 10.0 * np.log10(maxv * maxv / mse)


def ssim(ref: np.ndarray, rec: np.ndarray, bd: int = 8) -> float:
    """Global SSIM over 8x8 blocks with 4-pel stride (the x264/x265
    formulation: means/variances per block, no gaussian window)."""
    maxv = (1 << bd) - 1
    c1 = (0.01 * maxv) ** 2
    c2 = (0.03 * maxv) ** 2
    a = ref.astype(np.float64)
    b = rec.astype(np.float64)
    H, W = a.shape
    bs, st = 8, 4
    ys = np.arange(0, H - bs + 1, st)
    xs = np.arange(0, W - bs + 1, st)
    # windows [ny, nx, 8, 8] via stride tricks
    sa = np.lib.stride_tricks.sliding_window_view(a, (bs, bs))[::st, ::st]
    sb = np.lib.stride_tricks.sliding_window_view(b, (bs, bs))[::st, ::st]
    ma = sa.mean(axis=(2, 3))
    mb = sb.mean(axis=(2, 3))
    va = sa.var(axis=(2, 3))
    vb = sb.var(axis=(2, 3))
    cov = (sa * sb).mean(axis=(2, 3)) - ma * mb
    s = ((2 * ma * mb + c1) * (2 * cov + c2)) / \
        ((ma * ma + mb * mb + c1) * (va + vb + c2))
    return float(s.mean())
