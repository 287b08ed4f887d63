"""The yardstick of the hand-written kernels: the chip's peaks, and each
kernel entry's least bytes and operations worked out from the shapes of
one launch. The arithmetic is chip_smoke.py's ``bounds()`` and its
per-kernel rows (commit 29bcdd5), copied, with one change: an absolute
difference of kernel 5 (``sad_sweep_argmin``, ``sad_local_argmin``) is
charged at the card's measured ``vabsdiff4`` rate (one instruction takes
four byte differences and their sum), not at three scalar operations;
charged three operations a difference, its argmin entry would read above
100%.

A bound is the larger of bytes / HBM rate and operations / the scalar
integer rate. Each input byte is counted once, each output byte once.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12
# byte absolute differences a second by vabsdiff4 on the NVIDIA H100 80GB
# HBM3 at 700 W: chip_smoke.py's calibration phase (sad4_differences_per_s)
SAD4_DIFFS_PER_S = 59.61e12

# name fragments of the CUDA kernels the entries launch (csrc/*.cu)
KERNEL_NAMES = ("mc_gather_kernel", "tile_gather_kernel",
                "tile_gather_staged_kernel", "gather_satd_kernel",
                "satd8_kernel", "sad_sweep_kernel", "sad_local_kernel")


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S)


def _gather_bytes(plane_elems, N, side, out_elems, n_index_arrays):
    """The windows' int16s (or the whole plane when the windows cover
    more), the per-lane indices, the int32 output."""
    return (min(plane_elems, N * side * side) * 2
            + n_index_arrays * N * 4 + out_elems * 4)


def _sad_ops(diffs, n, nb):
    """The differences at the vabsdiff4 rate, as scalar operations of the
    same time, and the argmin's compare and select a candidate a block."""
    return diffs * INT_OPS_PER_S / SAD4_DIFFS_PER_S + 2 * n * n * nb


def mc_gather_interp(planes, ridx, oy, ox, xf, yf, filt, n, taps, bd):
    N = ridx.shape[0]
    side = n + taps - 1
    return (_gather_bytes(planes.numel(), N, side, N * n * n, 5)
            + filt.numel() * 4, N * 2 * taps * (side * n + n * n))


def tile_gather(plane, oy, ox, n):
    N = oy.shape[0]
    return _gather_bytes(plane.numel(), N, n, N * n * n, 2), 0


def tile_gather_planes(planes, ridx, oy, ox, n):
    N = ridx.shape[0]
    return _gather_bytes(planes.numel(), N, n, N * n * n, 3), 0


def tile_gather_planes_satd(planes, ridx, oy, ox, cur_blocks, n):
    L, Nb = ridx.shape[0], cur_blocks.shape[0]
    return (min(planes.numel(), L * n * n) * 2 + 3 * L * 4
            + Nb * n * n * 4 + L * 4, L * (n // 8) ** 2 * (64 + 384 + 64))


def satd(a, b):
    N, S = a.shape[0], a.shape[1]
    return 2 * N * S * S * 4 + N * 4, N * (S // 8) ** 2 * (64 + 384 + 64)


def satd_intra(a):
    N = a.shape[0]
    return N * 64 * 2 + N * 4, N * (384 + 64)


def sad_sweep_argmin(cur, ref_pad, mvcost, S, R):
    P = cur.shape[0] if cur.dim() == 3 else 1
    H, W = cur.shape[-2:]
    n = 2 * R + 1
    nb = (H // S) * (W // S)
    return ((cur.numel() + ref_pad.numel()) * 2 + n * n * 4 + P * nb * 8,
            P * _sad_ops(n * n * H * W, n, nb))


def sad_local_argmin(cur_blocks, ref_pad, y0s, x0s, centers, lam, S, W_r):
    N = cur_blocks.shape[0]
    n = 2 * W_r + 1
    side = S + 2 * W_r
    Hr, Wr = ref_pad.shape
    return (min(Hr * Wr, N * side * side) * 2 + N * S * S * 4 + 4 * N * 4
            + N * 8, _sad_ops(n * n * N * S * S, n, N))


# entry name -> (module that defines it, shapes -> (bytes, ops))
ENTRIES = {
    "mc_gather_interp": ("x265_tpu_torch.ops.cuda_mc", mc_gather_interp),
    "tile_gather": ("x265_tpu_torch.ops.cuda_mc", tile_gather),
    "tile_gather_planes": ("x265_tpu_torch.ops.cuda_mc", tile_gather_planes),
    "tile_gather_planes_satd": ("x265_tpu_torch.ops.cuda_mc",
                                tile_gather_planes_satd),
    "satd": ("x265_tpu_torch.ops.cuda_kernels", satd),
    "satd_intra": ("x265_tpu_torch.ops.cuda_kernels", satd_intra),
    "sad_sweep_argmin": ("x265_tpu_torch.ops.cuda_kernels", sad_sweep_argmin),
    "sad_local_argmin": ("x265_tpu_torch.ops.cuda_kernels", sad_local_argmin),
}
