"""CU-level derivations shared by encoder finalizer and decoder:
intra MPM candidate list (spec 8.4.2) and chroma mode candidates (8.4.3).
"""
from __future__ import annotations

from typing import List

import numpy as np


def mpm_list(intra_mode4: np.ndarray, is_intra4: np.ndarray,
             avail4: np.ndarray, xpb: int, ypb: int, ctb_size: int) -> List[int]:
    """Most-probable-mode candidate list for the luma PB at (xpb, ypb)."""
    def neighbor(x: int, y: int) -> int:
        if x < 0 or y < 0:
            return 1  # DC
        if not avail4[y >> 2, x >> 2] or not is_intra4[y >> 2, x >> 2]:
            return 1
        return int(intra_mode4[y >> 2, x >> 2])

    a = neighbor(xpb - 1, ypb)
    if ypb % ctb_size == 0:
        b = 1  # above row outside current CTU -> DC (spec 8.4.2 availability)
    else:
        b = neighbor(xpb, ypb - 1)
    if a == b:
        if a < 2:
            return [0, 1, 26]
        return [a, 2 + ((a + 29) % 32), 2 + ((a - 2 + 1) % 32)]
    cands = [a, b]
    if a != 0 and b != 0:
        cands.append(0)
    elif a != 1 and b != 1:
        cands.append(1)
    else:
        cands.append(26)
    return cands


def chroma_cand_list(luma_mode: int) -> List[int]:
    """intra_chroma_pred_mode 0..3 candidate modes (4 = DM)."""
    cand = [0, 26, 10, 1]
    if luma_mode in cand:
        cand[cand.index(luma_mode)] = 34
    return cand


# ---------------------------------------------------------------------------
# cu_qp_delta coding (7.3.8.10 / 9.3.3.10): TU prefix (cMax=5, ctx bins)
# + EG0 bypass suffix + bypass sign
# ---------------------------------------------------------------------------

def encode_cu_qp_delta(cab, ctx_base: int, delta: int) -> None:
    a = abs(delta)
    prefix = min(a, 5)
    for i in range(prefix):
        cab.encode_bin(ctx_base + (0 if i == 0 else 1), 1)
    if prefix < 5:
        cab.encode_bin(ctx_base + (0 if prefix == 0 else 1), 0)
    if a >= 5:
        v = a - 5
        k = 0
        while v >= (1 << k):
            cab.encode_bin_ep(1)
            v -= 1 << k
            k += 1
        cab.encode_bin_ep(0)
        for i in range(k - 1, -1, -1):
            cab.encode_bin_ep((v >> i) & 1)
    if a > 0:
        cab.encode_bin_ep(1 if delta < 0 else 0)


def decode_cu_qp_delta(cab, ctx_base: int) -> int:
    a = 0
    while a < 5 and cab.decode_bin(ctx_base + (0 if a == 0 else 1)):
        a += 1
    if a == 5:
        k = 0
        while cab.decode_bin_ep():
            a += 1 << k
            k += 1
        suffix = 0
        for _ in range(k):
            suffix = (suffix << 1) | cab.decode_bin_ep()
        a += suffix
    if a > 0 and cab.decode_bin_ep():
        return -a
    return a
