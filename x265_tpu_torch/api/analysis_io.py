"""Analysis save/load — x265's inter-encode reuse & checkpoint channel
(x265_analysis_data, x265.h:208-230; Encoder::writeAnalysisFile /
readAnalysisFile, encoder.cpp:5374/4257; reuse levels cli.rst:942-980).

The decision tensors (CU sizes, intra modes, inter dir/MVs, per-CTB QP
map) serialize per frame in ENCODE order as one npz stream. A dependent
encode loads them and skips its own analysis — the ladder's
master->dependent handoff — optionally rescaling the maps for a
half-resolution rendition (--scale-factor analog).
"""
from __future__ import annotations

import io
import pickle
import struct
from typing import Optional

import numpy as np

from x265_tpu_torch.engine.ctu_writer import FrameDecisions

MAGIC = b"X265TPUA1"

_FIELDS = ("cu_log2_map", "luma_mode8", "chroma_mode8", "inter8", "dir8",
           "mv8", "ref8", "qp_map")


class AnalysisWriter:
    def __init__(self, path: str):
        self.f = open(path, "wb")
        self.f.write(MAGIC)

    def put(self, dec: FrameDecisions) -> None:
        blob = {}
        for k in _FIELDS:
            v = getattr(dec, k)
            blob[k] = None if v is None else np.asarray(v)
        payload = pickle.dumps(blob, protocol=4)
        self.f.write(struct.pack("<I", len(payload)))
        self.f.write(payload)

    def close(self) -> None:
        self.f.close()


class AnalysisReader:
    def __init__(self, path: str):
        self.f = open(path, "rb")
        if self.f.read(len(MAGIC)) != MAGIC:
            raise ValueError("not an analysis file")

    def get(self) -> Optional[FrameDecisions]:
        hdr = self.f.read(4)
        if len(hdr) < 4:
            return None
        (n,) = struct.unpack("<I", hdr)
        blob = pickle.loads(self.f.read(n))
        return FrameDecisions(**blob)

    def close(self) -> None:
        self.f.close()


def scale_decisions(dec: FrameDecisions, factor: int = 2) -> FrameDecisions:
    """Rescale decision maps for a 1/factor-resolution dependent encode
    (--scale-factor analysis reuse, scaler-assisted; encoder.cpp:4257
    cross-resolution import). CU sizes shrink by log2(factor), clamped to
    the 8x8 minimum; MVs scale by 1/factor."""
    import math
    s = int(math.log2(factor))

    def down(m, agg="first"):
        if m is None:
            return None
        m = np.asarray(m)
        return m[::factor, ::factor].copy()

    out = FrameDecisions(
        cu_log2_map=np.maximum(down(dec.cu_log2_map) - s, 3),
        luma_mode8=down(dec.luma_mode8),
        chroma_mode8=down(dec.chroma_mode8),
        inter8=down(dec.inter8),
        dir8=down(dec.dir8),
        ref8=down(dec.ref8),
        mv8=None if dec.mv8 is None else
            (down(dec.mv8) // factor).astype(np.int32),
        qp_map=dec.qp_map,      # per-CTB grid is resolution-relative
    )
    return out


def upscale_decisions(dec: FrameDecisions, factor: int = 2,
                      ctb_log2: int = 6) -> FrameDecisions:
    """Rescale decision maps saved at 1/factor resolution for a
    factor-x encode — the x265 --scale-factor direction (cli.rst
    942-980: analysis saved on the low-res rendition seeds the high-res
    encode; encoder.cpp:4257 readAnalysisFile scale path).  CU sizes
    grow by log2(factor) clamped to the CTB; MVs scale by factor."""
    import math
    s = int(math.log2(factor))

    def up(m):
        if m is None:
            return None
        m = np.asarray(m)
        return np.repeat(np.repeat(m, factor, axis=0), factor, axis=1)

    return FrameDecisions(
        cu_log2_map=np.minimum(up(dec.cu_log2_map) + s, ctb_log2),
        luma_mode8=up(dec.luma_mode8),
        chroma_mode8=up(dec.chroma_mode8),
        inter8=up(dec.inter8),
        dir8=up(dec.dir8),
        ref8=up(dec.ref8),
        mv8=None if dec.mv8 is None else
            (up(dec.mv8) * factor).astype(np.int32),
        qp_map=dec.qp_map,      # per-CTB grid is resolution-relative
    )
