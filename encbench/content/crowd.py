"""``crowd``: high-detail multi-octave texture under a sub-pel pan, the
port's ``utils/testclip.clip_crowd1080`` (frozen copy).

Mix keys: ``frames`` (pictures in the pool), ``pan`` ([dy, dx] pels a
picture)."""
from __future__ import annotations

import numpy as np

from encbench.content._texture import (at_depth, parallel, sample, to420,
                                       value_noise)


def make(mix, W, H, seed, bit_depth=8):
    """clip_crowd1080(W, H, n, seed) exactly: the master planes carry a
    fixed margin of 100 pels, which the pan may not leave."""
    n = mix["frames"]
    py, px = mix["pan"]
    if 8 + max(py, px) * (n - 1) + 1 > 100:
        raise ValueError(f"crowd: {n} frames pan out of the 100-pel margin")
    rng = np.random.default_rng(seed)
    MH, MW = H + 100, W + 100
    master_y = value_noise(rng, MH, MW,
                           (12, 24, 48, 96, 192),
                           (1.0, 0.6, 0.4, 0.25, 0.15)) * 210 + 22
    master_cb = value_noise(rng, MH, MW, (10, 40), (1.0, 0.5)) * 85 + 85
    master_cr = value_noise(rng, MH, MW, (16, 36), (1.0, 0.5)) * 85 + 85

    def frame(i):
        oy, ox = 8 + py * i, 8 + px * i
        return at_depth(to420(sample(master_y, oy, ox, H, W),
                               sample(master_cb, oy, ox, H, W),
                               sample(master_cr, oy, ox, H, W)), bit_depth)
    return parallel(frame, range(n))
