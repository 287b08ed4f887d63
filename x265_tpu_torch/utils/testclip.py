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
}
GOLDEN_SIZE = (192, 128, 5)          # width, height, frames


def golden_clip(name):
    w, h, n = GOLDEN_SIZE
    maker = {"make_clip": make_clip, "make_ramp_clip": make_ramp_clip}
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
