"""SATD and the dense SAD sweep: the Hopper kernels' wrappers and their
plain PyTorch versions.

Counterpart of x265_tpu/ops/pallas_kernels.py (satd8x8_pallas /
satd_pallas, sad_sweep_pallas); the kernels are csrc/satd.cu and
csrc/sad_sweep.cu. On a CUDA tensor a wrapper launches its kernel or
raises; on a CPU tensor it runs the plain version. The launch counts
live with the other kernels' in ops.cuda_mc.launches.
"""
from __future__ import annotations

import numpy as np
import torch

from x265_tpu_torch.models.intra_frame import first_argmin
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


# ---------------------------------------------------------- dense SAD sweep

def _sad_rows(cur, ref_pad, S: int, R: int):
    """Yields, for dy = 0..2R, the SAD of every S x S block at the 2R+1
    displacements of that row: [nby, 2R+1, nbx] int32 (int16 differences,
    int32 block sums)."""
    H, W = cur.shape
    nby, nbx = H // S, W // S
    n = 2 * R + 1
    for dy in range(n):
        win = ref_pad[dy:dy + H, :].unfold(1, W, 1)         # [H, n, W]
        ad = (cur[:, None, :] - win).abs()
        yield ad.reshape(nby, S, n, nbx, S).sum(dim=(1, 4),
                                                dtype=torch.int32)


def sad_sweep_plain(cur, ref_pad, S: int, R: int):
    """The SAD field [(2R+1)^2, nby, nbx] float32, one row of
    displacements per step."""
    n = 2 * R + 1
    rows = [sad.permute(1, 0, 2) for sad in _sad_rows(cur, ref_pad, S, R)]
    return torch.stack(rows).reshape(n * n, *rows[0].shape[1:]).to(
        torch.float32)


def sad_sweep_argmin_plain(cur, ref_pad, mvcost, S: int, R: int):
    """First minimum of float(sad) + mvcost[d] over d = dy*n + dx. One
    step per dy covers every dx of that row at once; inside a row the
    first minimum wins, across rows a strict < keeps the earlier one: the
    same winner as a displacement-by-displacement scan in d order."""
    H, W = cur.shape
    nby, nbx = H // S, W // S
    n = 2 * R + 1
    dev = cur.device
    mvc = mvcost.reshape(n, n)
    best_cost = torch.full((nby, nbx), float("inf"), dtype=torch.float32,
                           device=dev)
    best_idx = torch.zeros((nby, nbx), dtype=torch.int64, device=dev)
    for dy, sad in enumerate(_sad_rows(cur, ref_pad, S, R)):
        cost = sad.to(torch.float32) + mvc[dy][None, :, None]  # [nby,n,nbx]
        k = first_argmin(cost, 1)
        c = torch.gather(cost, 1, k[:, None, :])[:, 0, :]
        upd = c < best_cost
        best_cost = torch.where(upd, c, best_cost)
        best_idx = torch.where(upd, dy * n + k, best_idx)
    return best_idx.to(torch.int32), best_cost


def _check_sweep(cur, ref_pad, S, R):
    cuda_mc._check(cur, "cur", torch.int16, 2)
    cuda_mc._check(ref_pad, "ref_pad", torch.int16, 2, cur.device)
    H, W = cur.shape
    if S not in (4, 8, 16, 32) or R < 0 or H < S or W < S or H % S or W % S:
        raise ValueError(f"bad SAD sweep geometry: cur {H}x{W}, S={S}, R={R}")
    if tuple(ref_pad.shape) != (H + 2 * R, W + 2 * R):
        raise ValueError(f"ref_pad is {tuple(ref_pad.shape)}, expected "
                         f"{(H + 2 * R, W + 2 * R)}")
    if ((S + 2 * R) ** 2 + S * S) * 2 > 48 * 1024:
        raise ValueError(f"search window of S={S}, R={R} does not fit a "
                         "thread block's shared memory")
    return H, W


def sad_sweep(cur, ref_pad, S: int, R: int):
    """SAD of every S x S block of cur [H,W] int16 against ref_pad
    [H+2R,W+2R] int16 at every displacement d = dy*(2R+1) + dx ->
    [(2R+1)^2, H/S, W/S] float32 (what sad_sweep_pallas returns)."""
    H, W = _check_sweep(cur, ref_pad, S, R)
    dev = cur.device
    if dev.type != "cuda":
        return sad_sweep_plain(cur, ref_pad, S, R)
    n = 2 * R + 1
    out = torch.empty((n * n, H // S, W // S), dtype=torch.float32,
                      device=dev)
    lib = cuda_build.get_lib()
    with torch.cuda.device(dev):
        err = lib.x265_sad_sweep(cur.data_ptr(), ref_pad.data_ptr(),
                                 out.data_ptr(), H, W, S, R,
                                 cuda_mc._stream(dev))
    cuda_build.check_launch(err, "sad_sweep")
    cuda_mc.launches["sad_sweep"] += 1
    return out


def sad_sweep_argmin(cur, ref_pad, mvcost, S: int, R: int):
    """The sweep fused with its argmin: for every block the FIRST d that
    minimises float32(sad) + mvcost[d] (mvcost [(2R+1)^2] float32, lambda
    already applied) -> (best_idx [H/S, W/S] int32, best_cost float32).
    Serves engine.me._int_stage."""
    H, W = _check_sweep(cur, ref_pad, S, R)
    dev = cur.device
    cuda_mc._check(mvcost, "mvcost", torch.float32, 1, dev)
    n = 2 * R + 1
    if mvcost.shape[0] != n * n:
        raise ValueError(f"mvcost has {mvcost.shape[0]} entries, expected "
                         f"{n * n}")
    if dev.type != "cuda":
        return sad_sweep_argmin_plain(cur, ref_pad, mvcost, S, R)
    idx = torch.empty((H // S, W // S), dtype=torch.int32, device=dev)
    cost = torch.empty((H // S, W // S), dtype=torch.float32, device=dev)
    lib = cuda_build.get_lib()
    with torch.cuda.device(dev):
        err = lib.x265_sad_sweep_argmin(
            cur.data_ptr(), ref_pad.data_ptr(), mvcost.data_ptr(),
            idx.data_ptr(), cost.data_ptr(), H, W, S, R,
            cuda_mc._stream(dev))
    cuda_build.check_launch(err, "sad_sweep_argmin")
    cuda_mc.launches["sad_sweep_argmin"] += 1
    return idx, cost
