"""SATD: the Hopper kernel's wrapper and its plain PyTorch version.

Counterpart of x265_tpu/ops/pallas_kernels.py (satd8x8_pallas /
satd_pallas); the kernel is csrc/satd.cu. On a CUDA tensor the wrapper
launches the kernel or raises; on a CPU tensor it runs the plain
version. The launch count lives with the other kernels' in
ops.cuda_mc.launches.
"""
from __future__ import annotations

import numpy as np
import torch

from x265_tpu_torch.ops import cuda_build, cuda_mc

# 8x8 Hadamard matrix for SATD (row order of engine.me in the JAX package)
_H8 = np.array([[1, 1, 1, 1, 1, 1, 1, 1],
                [1, -1, 1, -1, 1, -1, 1, -1],
                [1, 1, -1, -1, 1, 1, -1, -1],
                [1, -1, -1, 1, 1, -1, -1, 1],
                [1, 1, 1, 1, -1, -1, -1, -1],
                [1, -1, 1, -1, -1, 1, -1, 1],
                [1, 1, -1, -1, -1, -1, 1, 1],
                [1, -1, -1, 1, -1, 1, 1, -1]], dtype=np.int32)


def satd_plain(a, b):
    """SATD over [N, S, S] blocks (S multiple of 8) -> [N] int32: the
    two-sided Hadamard as matrix products. They run in float32, which is
    exact here: every entry of H8 D H8^T is an integer below 64 * 2^12
    < 2^24 for any bit depth up to 12 (TF32 is off package-wide)."""
    N, S, _ = a.shape
    k = S // 8
    d = (a.to(torch.int32) - b.to(torch.int32)).reshape(N, k, 8, k, 8)
    d = d.permute(0, 1, 3, 2, 4).reshape(-1, 8, 8).to(torch.float32)
    h = torch.from_numpy(_H8).to(device=a.device, dtype=torch.float32)
    t = torch.matmul(torch.matmul(h, d), h.t())
    s = t.abs().sum(dim=(1, 2)).to(torch.int64) // 4
    return s.reshape(N, -1).sum(dim=1).to(torch.int32)


def satd(a, b):
    """SATD over [N, S, S] int32 blocks (S a multiple of 8) -> [N] int32
    (per-8x8 sa8d sums, as engine.me.satd8_batched defines it)."""
    for t, nm in ((a, "a"), (b, "b")):
        cuda_mc._check(t, nm, torch.int32, 3, a.device)
    if a.shape != b.shape or a.shape[1] != a.shape[2] or a.shape[1] % 8:
        raise ValueError(f"bad SATD block shapes {tuple(a.shape)} "
                         f"{tuple(b.shape)}")
    dev = a.device
    if dev.type != "cuda":
        return satd_plain(a, b)
    N, S, _ = a.shape
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("SATD operands must be 16-byte aligned")
    out = torch.zeros((N,), dtype=torch.int32, device=dev)
    if N:
        lib = cuda_build.get_lib()
        with torch.cuda.device(dev):
            err = lib.x265_satd8(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                 N, S, torch.cuda.current_stream(dev)
                                 .cuda_stream)
        cuda_build.check_launch(err, "satd8x8")
        cuda_mc.launches["satd8x8"] += 1
    return out


def satd8x8(a, b):
    """sa8d of [N, 8, 8] int32 blocks -> [N] int32."""
    if a.shape[1:] != (8, 8):
        raise ValueError("satd8x8 takes [N, 8, 8] blocks")
    return satd(a, b)
