"""Intra mode decision — analysis stage (x265 Analysis::compressIntraCU /
Search::estIntraPredQT analog, reference analysis.cpp:514, search.cpp:1509).

v0 is a numpy reference implementation processing CUs in coding order with
exact availability; the TPU production path (x265_tpu_torch.models.intra_frame)
computes the same decision tensors as a single batched jitted graph with
source-neighbor prediction (legal because the finalizer re-derives exact
predictions; see SURVEY.md §7.1).
"""
from __future__ import annotations

import numpy as np

from x265_tpu_torch.engine.ctu_writer import FrameDecisions
from x265_tpu_torch.hevc.cu_tools import mpm_list
from x265_tpu_torch.ops.ref.intra import predict_block


def _hadamard(n: int) -> np.ndarray:
    h = np.array([[1]])
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


_H8 = _hadamard(8)
_H4 = _hadamard(4)


def satd(resi: np.ndarray) -> int:
    """SATD via 8x8 (or 4x4) Hadamard, x265 sa8d-style normalization."""
    n = resi.shape[0]
    if n >= 8:
        k = 8
        h = _H8
    else:
        k = 4
        h = _H4
    total = 0
    r = resi.reshape(n // k, k, n // k, k).transpose(0, 2, 1, 3)
    t = np.einsum("ij,abjk,kl->abil", h, r.astype(np.int64), h)
    total = int(np.abs(t).sum())
    # normalize: /2 for 4x4 Hadamard SATD, /4 for 8x8 (sa8d convention)
    return (total + (2 if k == 8 else 1) - 1) // (4 if k == 8 else 2)


def decide_intra_frame(src_y: np.ndarray, width: int, height: int,
                       ctb_log2: int, cu_log2: int = 4,
                       strong_smoothing: bool = True,
                       lambda_bits: float = 1.0,
                       bit_depth: int = 8) -> FrameDecisions:
    """Fixed-size CU intra decision over a frame (numpy reference).

    Walks CUs in z-order within raster CTUs (true coding order) so that
    availability for reference-sample substitution matches the finalizer.
    """
    h8, w8 = height >> 3, width >> 3
    # CU size map: default cu_log2; force 8x8 where the enclosing
    # cu_log2-sized block crosses the picture boundary (partial-CTU case)
    cu_log2_map = np.full((h8, w8), cu_log2, dtype=np.int32)
    step = 1 << (cu_log2 - 3)
    for by in range(h8):
        for bx in range(w8):
            x0 = (bx >> (cu_log2 - 3)) << cu_log2
            y0 = (by >> (cu_log2 - 3)) << cu_log2
            if x0 + (1 << cu_log2) > width or y0 + (1 << cu_log2) > height:
                cu_log2_map[by, bx] = 3
    luma_mode8 = np.zeros((h8, w8), dtype=np.int32)
    h4, w4 = height >> 2, width >> 2
    avail4 = np.zeros((h4, w4), dtype=bool)
    mode4 = np.full((h4, w4), -1, dtype=np.int32)
    isintra4 = np.zeros((h4, w4), dtype=bool)
    src = src_y.astype(np.int32)

    ctb = 1 << ctb_log2

    def z_blocks(x0, y0, log2):
        """Yield leaf CUs (x, y, log2) following the map in z-order."""
        if x0 >= width or y0 >= height:
            return
        size = 1 << log2
        inside = x0 + size <= width and y0 + size <= height
        if inside and int(cu_log2_map[y0 >> 3, x0 >> 3]) >= log2:
            yield (x0, y0, log2)
            return
        half = size >> 1
        for dx, dy in ((0, 0), (half, 0), (0, half), (half, half)):
            yield from z_blocks(x0 + dx, y0 + dy, log2 - 1)

    for cy in range(0, height, ctb):
        for cx in range(0, width, ctb):
            for (x0, y0, lg) in z_blocks(cx, cy, ctb_log2):
                nt = 1 << lg
                blk = src[y0:y0 + nt, x0:x0 + nt]
                cands = mpm_list(mode4, isintra4, avail4, x0, y0, ctb)
                best_mode, best_cost = 1, None
                for mode in range(35):
                    pred = predict_block(src, avail4, x0, y0, nt, mode, 0,
                                         strong_smoothing, bit_depth)
                    cost = satd(blk - pred)
                    bits = 2 if mode in cands else 6
                    cost += int(lambda_bits * bits)
                    if best_cost is None or cost < best_cost:
                        best_mode, best_cost = mode, cost
                luma_mode8[y0 >> 3:(y0 + nt) >> 3, x0 >> 3:(x0 + nt) >> 3] = best_mode
                mode4[y0 >> 2:(y0 + nt) >> 2, x0 >> 2:(x0 + nt) >> 2] = best_mode
                isintra4[y0 >> 2:(y0 + nt) >> 2, x0 >> 2:(x0 + nt) >> 2] = True
                avail4[y0 >> 2:(y0 + nt) >> 2, x0 >> 2:(x0 + nt) >> 2] = True

    return FrameDecisions(cu_log2_map=cu_log2_map, luma_mode8=luma_mode8)
