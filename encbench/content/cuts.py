"""``cuts``: scenes of smooth texture moving by ``motion`` pels a picture
with sensor noise, one after another with a hard cut between them; each
scene is the port's ``utils/testclip.make_cut_clip`` (frozen copy).

Mix keys: ``scenes``, ``scene_length`` (pictures), ``margin`` (pels of
texture round the picture), ``motion`` ([dy, dx] pels a picture),
``noise_sigma``."""
from __future__ import annotations

import numpy as np

from encbench.content._texture import at_depth, parallel, smooth_texture


def _cut_frame(big, seed, i, W, H, motion, sigma):
    """Picture i of make_cut_clip's scene `big` (its offsets, noise seed
    and chroma rule)."""
    noise = np.random.default_rng((seed, i)).normal(0, sigma, (H, W))
    dy, dx = 16 + motion[0] * i, 16 + motion[1] * i
    y = np.clip(np.rint(big[dy:dy + H, dx:dx + W] + noise), 0, 255)
    y = y.astype(np.uint8)
    cb = (y[::2, ::2] // 2 + 64).astype(np.uint8)
    cr = (255 - y[::2, ::2] // 2).astype(np.uint8)
    return y, cb, cr


def make(mix, W, H, seed, bit_depth=8):
    """`scenes` scenes of `scene_length` pictures each. Scene k is
    make_cut_clip's first scene at seed + 1000 k: its texture from
    default_rng(seed + 1000 k) with `margin` pels round it, picture j of
    it moved by (16 + motion * j) pels, with the noise of
    default_rng((seed + 1000 k, j))."""
    L, m = mix["scene_length"], mix["margin"]
    motion, sigma = mix["motion"], mix["noise_sigma"]
    if 16 + max(motion) * (L - 1) > m:
        raise ValueError(f"cuts: {L} pictures move out of the {m}-pel margin")
    seeds = [seed + 1000 * k for k in range(mix["scenes"])]
    bigs = parallel(lambda s: smooth_texture(
        W, H, np.random.default_rng(s), m=m), seeds)
    return parallel(lambda kj: at_depth(
        _cut_frame(bigs[kj[0]], seeds[kj[0]], kj[1], W, H, motion, sigma),
        bit_depth), [(k, j) for k in range(len(seeds)) for j in range(L)])
