"""Seeded test clips (numpy only), shared by chip_smoke.py, the tests and
the golden-stream check, so that every one of them encodes the very same
pictures.
"""
from __future__ import annotations

import numpy as np


def _texture(w, h, rng, m=96):
    big = rng.integers(0, 256, (h + m, w + m)).astype(np.float32)
    for _ in range(4):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
               + np.roll(big, -1, 0) + np.roll(big, -1, 1)) / 5.0
    return np.clip((big - 128.0) * 4.0 + 128.0, 0, 255)


def _frames(w, h, n, seed, gain):
    rng = np.random.default_rng(seed)
    big = _texture(w, h, rng)
    frames = []
    for i in range(n):
        dy, dx = 16 + 2 * i, 16 + 5 * i
        y = big[dy:dy + h, dx:dx + w] * gain(i) + rng.normal(0, 1.5, (h, w))
        y = np.clip(np.rint(y), 0, 255).astype(np.uint8)
        cb = (y[::2, ::2] // 2 + 64).astype(np.uint8)
        cr = (255 - y[::2, ::2] // 2).astype(np.uint8)
        frames.append((y, cb, cr))
    return frames


def make_clip(w, h, n, seed):
    """Moving band-limited texture + noise, 8-bit 4:2:0, so motion is
    non-zero and residuals are not."""
    return _frames(w, h, n, seed, lambda i: 1.0)


def make_ramp_clip(w, h, n, seed, step=0.07):
    """make_clip under a linear brightness ramp (a fade towards black:
    frame i is scaled by 1 - step*i), so that weighted prediction finds
    a weight and chroma, derived from luma, moves with it."""
    return _frames(w, h, n, seed, lambda i: 1.0 - step * i)


def _smooth_texture(w, h, rng, m=96, cell=32):
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


def make_cut_clip(w, h, n, seed, cut):
    """A scene cut: frames 0..cut-1 show one smooth texture, frames
    cut..n-1 an unrelated one, both moving by (5, 2) pels a frame with
    noise, 8-bit 4:2:0. The lookahead's inter cost reaches its intra cost
    at frame `cut` only, so the scenecut test fires there and nowhere
    else; the textures are smooth enough that weighted prediction finds
    no weight inside a scene (its moment fit is not motion-compensated),
    so the full-plane rd 3 passes run on every P frame."""
    scenes = [_smooth_texture(w, h, np.random.default_rng(s))
              for s in (seed, seed + 1000)]
    frames = []
    for i in range(n):
        big = scenes[int(i >= cut)]
        noise = np.random.default_rng((seed, i)).normal(0, 1.5, (h, w))
        dy, dx = 16 + 2 * i, 16 + 5 * i
        y = np.clip(np.rint(big[dy:dy + h, dx:dx + w] + noise), 0, 255)
        y = y.astype(np.uint8)
        cb = (y[::2, ::2] // 2 + 64).astype(np.uint8)
        cr = (255 - y[::2, ::2] // 2).astype(np.uint8)
        frames.append((y, cb, cr))
    return frames


# ---- golden streams -------------------------------------------------------
# Small seeded encodes whose stream digests (SHA-256 of the JAX package's
# stream, which the port reproduces byte for byte on the CPU) are kept in
# golden_streams.json beside this file. A machine that has the port and a
# GPU but no JAX encodes the same clips and compares digests.

GOLDEN_CASES = {
    # name: (preset, tune, options through param_parse, clip maker, seed)
    "ultrafast_zerolatency": (
        "ultrafast", "zerolatency",
        {"qp": "30", "scenecut": "0", "ref": "1"}, "make_clip", 0),
    "fast_zerolatency_aq0": (
        "fast", "zerolatency",
        {"qp": "30", "scenecut": "0", "aq-mode": "0"}, "make_ramp_clip", 1),
    "fast_zerolatency": (
        "fast", "zerolatency",
        {"qp": "30", "scenecut": "0"}, "make_ramp_clip", 1),
    # the live encode: lookahead, scenecut (a CRA at the cut), cuTree,
    # rd 3; with and without AQ (without it, cu_qp_delta is on through
    # cuTree alone)
    "medium_zerolatency_crf": (
        "medium", "zerolatency", {"crf": "28"}, "make_cut_clip", 0),
    "medium_zerolatency_crf_aq0": (
        "medium", "zerolatency", {"crf": "28", "aq-mode": "0"},
        "make_cut_clip", 0),
    # ABR under a buffer small enough that VBV re-encodes fire
    "fast_zerolatency_abr_vbv": (
        "fast", "zerolatency",
        {"bitrate": "200", "vbv-maxrate": "200", "vbv-bufsize": "40"},
        "make_clip", 1),
}
GOLDEN_SIZE = (192, 128, 5)          # width, height, frames
GOLDEN_CUT = 3                       # the scene cut of make_cut_clip cases


def golden_clip(name):
    w, h, n = GOLDEN_SIZE
    maker = {"make_clip": make_clip, "make_ramp_clip": make_ramp_clip,
             "make_cut_clip": lambda *a: make_cut_clip(*a, cut=GOLDEN_CUT)}
    return maker[GOLDEN_CASES[name][3]](w, h, n, GOLDEN_CASES[name][4])


def golden_params(name, params_module):
    """The case's Param, built through the given package's api.params
    module (either package's: the option names are the same)."""
    preset, tune, opts = GOLDEN_CASES[name][:3]
    p = params_module.param_default_preset(preset, tune)
    for k, v in opts.items():
        params_module.param_parse(p, k, v)
    p.width, p.height = GOLDEN_SIZE[:2]
    return p


def golden_digests():
    """{name: {"sha256": ..., "bytes": ...}} from golden_streams.json."""
    import json
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "golden_streams.json")
    with open(path, encoding="utf-8") as f:
        return json.load(f)["streams"]
