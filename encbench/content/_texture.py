"""What the content generators share: a frozen copy of the port's
``x265_tpu_torch/utils/testclip.py`` helpers (commit 29bcdd5, so that a
later change to the port's test clips cannot move the benchmark), the
host's cores for set-up, and the step from 8-bit samples to a
configuration's bit depth."""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def parallel(fn, items):
    """fn over items on the host's cores (numpy leaves the interpreter
    lock while it computes); set-up only, the pool ends with the call."""
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(fn, items))


def at_depth(planes, bit_depth):
    """8-bit (y, cb, cr) planes as samples of `bit_depth` bits: uint8 at
    8, else uint16 scaled by 2**(bit_depth - 8), as a 10-bit source holds
    an 8-bit master."""
    if bit_depth == 8:
        return planes
    s = bit_depth - 8
    return tuple(p.astype(np.uint16) << s for p in planes)


# ---- frozen copy of x265_tpu_torch/utils/testclip.py (commit 29bcdd5) ----

def upsample_bilinear(a: np.ndarray, H: int, W: int) -> np.ndarray:
    """Bilinear resize [h,w] -> [H,W] (edge-clamped)."""
    h, w = a.shape
    ys = np.linspace(0, h - 1, H)
    xs = np.linspace(0, w - 1, W)
    y0 = np.clip(ys.astype(int), 0, h - 2)
    x0 = np.clip(xs.astype(int), 0, w - 2)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    a00 = a[y0][:, x0]
    a01 = a[y0][:, x0 + 1]
    a10 = a[y0 + 1][:, x0]
    a11 = a[y0 + 1][:, x0 + 1]
    return (a00 * (1 - fy) * (1 - fx) + a01 * (1 - fy) * fx
            + a10 * fy * (1 - fx) + a11 * fy * fx)


def value_noise(rng, H: int, W: int, octaves=(8, 16, 32, 64, 128),
                gains=(1.0, 0.6, 0.35, 0.2, 0.12)) -> np.ndarray:
    """Multi-octave value noise in [0,1] with a natural-ish spectrum."""
    out = np.zeros((H, W))
    for cells, g in zip(octaves, gains):
        grid = rng.standard_normal((cells, int(cells * W / H) + 2))
        out += g * upsample_bilinear(grid, H, W)
    out -= out.min()
    out /= max(1e-9, out.max())
    return out


def sample(master: np.ndarray, oy: float, ox: float,
            H: int, W: int) -> np.ndarray:
    """Bilinear subpixel crop [H,W] at float offset (oy, ox)."""
    y0 = int(np.floor(oy))
    x0 = int(np.floor(ox))
    fy = oy - y0
    fx = ox - x0
    win = master[y0:y0 + H + 1, x0:x0 + W + 1]
    return (win[:H, :W] * (1 - fy) * (1 - fx)
            + win[:H, 1:W + 1] * (1 - fy) * fx
            + win[1:H + 1, :W] * fy * (1 - fx)
            + win[1:H + 1, 1:W + 1] * fy * fx)


def to420(yf: np.ndarray, cbf: np.ndarray, crf: np.ndarray):
    y = np.clip(yf, 0, 255).astype(np.uint8)
    cb = np.clip(cbf, 0, 255)
    cr = np.clip(crf, 0, 255)
    cb = cb.reshape(cb.shape[0] // 2, 2, cb.shape[1] // 2, 2).mean((1, 3))
    cr = cr.reshape(cr.shape[0] // 2, 2, cr.shape[1] // 2, 2).mean((1, 3))
    return y, cb.astype(np.uint8), cr.astype(np.uint8)


def smooth_texture(w, h, rng, m=96, cell=32):
    """A texture that varies over tens of pels (a random grid every `cell`
    pels, bilinear between) with a little fine detail on top."""
    ys, xs = np.arange(h + m) / cell, np.arange(w + m) / cell
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
    g = rng.normal(0.0, 1.0, ((h + m) // cell + 2, (w + m) // cell + 2))
    t = ((1 - fy) * ((1 - fx) * g[y0][:, x0] + fx * g[y0][:, x0 + 1])
         + fy * ((1 - fx) * g[y0 + 1][:, x0] + fx * g[y0 + 1][:, x0 + 1]))
    f = rng.normal(0.0, 1.0, (h + m, w + m))
    for _ in range(2):
        f = (f + np.roll(f, 1, 0) + np.roll(f, 1, 1)
             + np.roll(f, -1, 0) + np.roll(f, -1, 1)) / 5.0
    return np.clip(128.0 + 50.0 * t / t.std() + 3.0 * f / f.std(), 0, 255)
