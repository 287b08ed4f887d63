"""Context-adaptive fractional-bit rate model (the estBit analog).

x265 drives RDOQ and RD mode costs from CABAC fractional-bit tables
instead of bin counts: Entropy::estBit (entropy.cpp:2217) snapshots the
live context states into per-syntax cost tables (g_entropyBits, Q15
fixed point) that Quant::rdoQuant (quant.cpp:610) reads per
coefficient.  Pure table math — perfectly jittable — and the thing that
makes RDOQ/merge decisions track the real coder.

TPU-first re-imagining: contexts cannot evolve inside a batched
dispatch, so the states are snapshotted ONCE per slice at their
spec-initial values (9.3.2.2: a function of initType and SliceQpY
only — fully deterministic, so the Python oracle, the native C++
finalizer and the device graphs derive byte-identical decisions from
the same eight constants per plane).

Units: Q15 bits (ENTROPY_BITS scale).  The constants vector per plane:

    K = [SIG0, SIG1, GT1_0, GT1_1, GT2_0, GT2_1, CG0, CG1]

where SIGb = avg cost of sig_coeff_flag == b over the plane's sig
contexts at their initial states, GT1/GT2 likewise for
coeff_abs_level_greater1/2, CG for coded_sub_block_flag.  Averaging
over the context group approximates x265's exact per-position context
selection; the win over static bin counts is that a "mostly zero"
context prices sig=0 at ~0.2 bits instead of 1.0.

The per-coefficient rate (shared integer formula — keep the three
implementations in lockstep; native analog in slice_writer.cpp
rate_fx):

    l == 0 : SIG0
    l == 1 : SIG1 + 2^15 + GT1_0                     (sign is EP)
    l == 2 : SIG1 + 2^15 + GT1_1 + GT2_0
    l >= 3 : SIG1 + 2^15 + GT1_1 + GT2_1 + REM(l-3)

    REM(r) = (r+1) << 15              if r < 3        (GR prefix, k=0)
           = (4 + 2*floor(log2(r-2))) << 15  else     (EG0 escape)

and the RD cost stays in the shared fixed-point domain:

    cost = 32*e^2 + (lam_fx * rate_fx) >> 15
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from x265_tpu_torch.hevc.tables import (CTX_CNT, CTX_OFF, ENTROPY_BITS,
                                  init_contexts)

SIG0, SIG1, GT1_0, GT1_1, GT2_0, GT2_1, CG0, CG1 = range(8)
EP_BIT = 1 << 15


@lru_cache(maxsize=512)
def rdoq_rate_consts(init_type: int, qp: int) -> np.ndarray:
    """[2, 8] int32 Q15 rate constants (row 0 luma, row 1 chroma) for a
    slice with the given CABAC initType (0=I, 1=P, 2=B) and SliceQpY."""
    st = init_contexts(init_type, min(max(0, qp), 51))

    def avg(name: str, b: int) -> int:
        off, cnt = CTX_OFF[name], CTX_CNT[name]
        return int(sum(int(ENTROPY_BITS[st[off + i] ^ b])
                       for i in range(cnt)) // cnt)

    out = np.empty((2, 8), np.int32)
    for row, sfx in ((0, "luma"), (1, "chroma")):
        out[row] = [avg("sig_" + sfx, 0), avg("sig_" + sfx, 1),
                    avg("gt1_" + sfx, 0), avg("gt1_" + sfx, 1),
                    avg("gt2_" + sfx, 0), avg("gt2_" + sfx, 1),
                    avg("csbf_" + sfx, 0), avg("csbf_" + sfx, 1)]
    out.setflags(write=False)
    return out


def slice_rate_consts(slice_type: int, qp: int) -> np.ndarray:
    """Consts for a slice by SLICE_I/P/B value (hevc slice_type: I=2,
    P=1, B=0), matching the writers' init mapping."""
    init_type = 0 if slice_type == 2 else (1 if slice_type == 1 else 2)
    return rdoq_rate_consts(init_type, int(qp))


def rate_fx_np(l: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Per-coefficient Q15 rate of |levels| l (numpy int64; the oracle
    form of the shared formula above). k: [8] consts row."""
    l = np.abs(l).astype(np.int64)
    # REM(l-3): GR prefix below 3, EG0 escape above (see module doc)
    esc = np.maximum(l - 5, 1)             # ilog2 arg for the escape
    lg = np.floor(np.log2(esc.astype(np.float64))).astype(np.int64)
    rem = np.where(l < 6, np.maximum(l - 2, 0) << 15, (4 + 2 * lg) << 15)
    return np.where(
        l == 0, int(k[SIG0]),
        int(k[SIG1]) + EP_BIT + np.where(
            l == 1, int(k[GT1_0]),
            int(k[GT1_1]) + np.where(l == 2, int(k[GT2_0]),
                                     int(k[GT2_1]) + rem)))


def rate_fx_t(l, k):
    """The shared formula above on a torch integer tensor: per-coefficient
    Q15 rate of |levels| l as int32 (the escape's log2 saturates at 15, as
    the device form of the JAX package does). k: [8] int32 tensor row."""
    import torch
    l = l.abs().to(torch.int32)
    esc = (l - 5).clamp(1, 1 << 16)
    # floor(log2(esc)): frexp's exponent is exact for integers < 2^24
    lg = (torch.frexp(esc.to(torch.float32)).exponent - 1).clamp(max=15)
    rem = torch.where(l < 6, (l - 2).clamp(min=0) << 15,
                      (4 + 2 * lg.to(torch.int32)) << 15)
    k = k.to(torch.int32)
    return torch.where(
        l == 0, k[SIG0],
        k[SIG1] + EP_BIT + torch.where(
            l == 1, k[GT1_0],
            k[GT1_1] + torch.where(l == 2, k[GT2_0], k[GT2_1] + rem)))


def rate_bits_j(l, k):
    """Per-coefficient rate of |levels| l in BITS (float32 torch tensor) —
    the estBit-based replacement for the static bin-count model in the RD
    promotion/adoption costs (models/rdo.py). k: [8] int32 tensor row."""
    import torch
    return rate_fx_t(l, k).to(torch.float32) * (1.0 / 32768.0)
