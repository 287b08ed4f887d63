"""Downscaler for the ABR ladder (x265 analog: source/scaler.{h,cpp} —
the swscale-derived polyphase ScalerFilterManager used by abrEncApp and
--scale-factor analysis reuse).

Separable resampler on the device: area averaging for integer ratios
(the common ladder case: 1080p -> 540p/270p) as an integer
reshape-and-sum, windowed-sinc POLYPHASE for fractional ones
(scaler.cpp:502's filter bank, each axis's tap bank materialized as a
dense [out, in] resampling matrix so the whole plane resamples as two
float32 matrix products). The bilinear method and the tap banks are host
numpy. Planes come in and go out as host arrays.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from x265_tpu_torch.utils.device import resolve_device


def _area_down(y: torch.Tensor, fy: int, fx: int) -> torch.Tensor:
    """Mean of each fy x fx block, rounded half up, in integers."""
    H, W = y.shape
    r = y[:H - H % fy, :W - W % fx].reshape(H // fy, fy, W // fx, fx)
    return (r.sum(dim=(1, 3)) + (fy * fx) // 2) // (fy * fx)


def _bilinear(y: np.ndarray, oh: int, ow: int) -> np.ndarray:
    H, W = y.shape
    ys = (np.arange(oh) + 0.5) * H / oh - 0.5
    xs = (np.arange(ow) + 0.5) * W / ow - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    a = y[np.ix_(y0, x0)].astype(np.float64)
    b = y[np.ix_(y0, x1)].astype(np.float64)
    c = y[np.ix_(y1, x0)].astype(np.float64)
    d = y[np.ix_(y1, x1)].astype(np.float64)
    out = (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx +
           c * wy * (1 - wx) + d * wy * wx)
    return np.rint(out).astype(y.dtype)


@lru_cache(maxsize=32)
def _poly_matrix(n_in: int, n_out: int, a: int = 3) -> np.ndarray:
    """[n_out, n_in] polyphase resampling matrix: Lanczos-a windowed
    sinc, cutoff scaled by the ratio when downsampling (anti-aliasing),
    rows normalized to 1. The phase of each output sample selects its
    tap set — exactly a polyphase filter bank, stored dense so the
    resample is one matrix product."""
    scale = min(1.0, n_out / n_in)
    support = a / scale
    centers = (np.arange(n_out) + 0.5) * n_in / n_out - 0.5
    lo = np.floor(centers - support).astype(int)
    taps = int(np.ceil(2 * support)) + 2
    m = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        idx = lo[i] + np.arange(taps)
        x = (idx - centers[i]) * scale
        w = np.sinc(x) * np.sinc(x / a) * (np.abs(x) < a)
        idx = np.clip(idx, 0, n_in - 1)       # edge-clamp taps
        for j, v in zip(idx, w):
            m[i, j] += v
        m[i] /= m[i].sum()
    return m


def _poly_apply(plane: torch.Tensor, mv: torch.Tensor,
                mh: torch.Tensor) -> torch.Tensor:
    """Two float32 products (TF32 is off for the whole package)."""
    t = torch.matmul(mv, plane.to(torch.float32))
    return torch.matmul(t, mh.T)


def _polyphase(plane: np.ndarray, oh: int, ow: int, device) -> np.ndarray:
    H, W = plane.shape
    dev = resolve_device(device)
    out = _poly_apply(
        torch.from_numpy(np.ascontiguousarray(plane).astype(np.int32)).to(dev),
        torch.from_numpy(_poly_matrix(H, oh)).to(dev),
        torch.from_numpy(_poly_matrix(W, ow)).to(dev)).cpu().numpy()
    maxv = 1023 if plane.dtype == np.uint16 else 255
    return np.clip(np.rint(out), 0, maxv).astype(plane.dtype)


def scale_plane(plane: np.ndarray, oh: int, ow: int,
                method: str = "auto", device=None) -> np.ndarray:
    """One plane scaled to oh x ow: area averaging when both ratios are
    integers (method "auto"), bilinear on the host (method "bilinear"),
    else polyphase. device=None means the CUDA device."""
    H, W = plane.shape
    if H == oh and W == ow:
        return plane
    if method == "bilinear":
        return _bilinear(plane, oh, ow)
    if method == "auto" and H % oh == 0 and W % ow == 0:
        src = torch.from_numpy(np.asarray(plane).astype(np.int32))
        return _area_down(src.to(resolve_device(device)), H // oh,
                          W // ow).cpu().numpy().astype(plane.dtype)
    return _polyphase(plane, oh, ow, device)


def scale_frame(frame, oh: int, ow: int, device=None):
    """(y, cb, cr) 4:2:0 -> scaled to oh x ow luma."""
    y, cb, cr = frame
    return (scale_plane(np.asarray(y), oh, ow, device=device),
            scale_plane(np.asarray(cb), oh // 2, ow // 2, device=device),
            scale_plane(np.asarray(cr), oh // 2, ow // 2, device=device))
