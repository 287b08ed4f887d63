"""Window gathers and motion compensation: the Hopper kernels' wrappers
and, beside each, its plain PyTorch version.

Counterpart of x265_tpu/ops/pallas_mc.py. The kernels live in
csrc/mc_gather.cu and csrc/tile_gather.cu; see the notes there for what
each replaces and what bounds it. tile_gather_planes has two entries:
the one that returns the blocks, as the TPU kernel does, and
tile_gather_planes_satd, which scores them against the current blocks in
the same kernel and serves the subpel search. Contract of every wrapper:

- CUDA tensors: checks device, dtype, shape and contiguity, launches
  the kernel on the current stream, adds one to ``launches[name]``, or
  raises. There is no path from a CUDA tensor to the plain version.
- CPU tensors: the plain version (the CPU tests run this).
- Origins, plane indices and phases are clipped into range by the
  kernel and by the plain version alike (jax.lax.dynamic_slice's clamp,
  which the callers of the TPU kernels applied by hand): a lane can
  never read outside its planes.
"""
from __future__ import annotations

import torch

from x265_tpu_torch.ops import cuda_build

launches = {"mc_gather_interp": 0, "tile_gather": 0,
            "tile_gather_planes": 0, "tile_gather_planes_satd": 0,
            "satd8x8": 0, "satd8x8_intra": 0, "sad_sweep": 0,
            "sad_sweep_argmin": 0, "sad_local_argmin": 0, "deblock_bs": 0,
            "rd_tb_cost": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check(t, name, dtype, ndim, device=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _check_lanes(device, **lanes):
    """Per-lane index arrays: int32 vectors of one length on `device`."""
    first = next(iter(lanes.values()))
    for name, t in lanes.items():
        _check(t, name, torch.int32, 1, device)
        if t.shape != first.shape:
            raise ValueError(f"{'/'.join(lanes)} lengths differ")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _window_index(oy, ox, n, Hp, Wp):
    """Flat indices [N, n, n] of the n x n windows at the clipped origins."""
    ar = torch.arange(n, device=oy.device, dtype=torch.int64)
    oy = oy.to(torch.int64).clamp(0, Hp - n)
    ox = ox.to(torch.int64).clamp(0, Wp - n)
    return ((oy[:, None, None] + ar[None, :, None]) * Wp
            + ox[:, None, None] + ar[None, None, :])


def _plane_offset(ridx, P, Hp, Wp):
    return ridx.to(torch.int64).clamp(0, P - 1)[:, None, None] * (Hp * Wp)


# ---------------------------------------------------------------- gathers

_MAX_STAGED_TILE = 78      # four n x n int16 windows fit 48 KB of shared memory


def _check_tile(n, Hp, Wp):
    """Sizes the gather kernels take: a power of two from 4 to 64, or any
    other n whose windows can be staged (the search patches: up to
    64 + 2*7)."""
    if n < 1 or n > Hp or n > Wp:
        raise ValueError(f"tile {n} does not fit planes {Hp}x{Wp}")
    if n not in (4, 8, 16, 32, 64) and n > _MAX_STAGED_TILE:
        raise ValueError(f"tile {n} unsupported: above {_MAX_STAGED_TILE} "
                         "only 64 is taken")

def tile_gather_plain(plane, oy, ox, n: int):
    """[N, n, n] int32 tiles of `plane` at (oy, ox): advanced indexing."""
    Hp, Wp = plane.shape
    idx = _window_index(oy, ox, n, Hp, Wp)
    return plane.reshape(-1)[idx].to(torch.int32)


def tile_gather(plane, oy, ox, n: int):
    """Plain [N, n, n] int32 tile gather from one int16 plane [Hp, Wp].
    oy/ox [N] int32, clipped to [0, dim - n]."""
    _check(plane, "plane", torch.int16, 2)
    dev = plane.device
    _check_lanes(dev, oy=oy, ox=ox)
    Hp, Wp = plane.shape
    _check_tile(n, Hp, Wp)
    if dev.type != "cuda":
        return tile_gather_plain(plane, oy, ox, n)
    N = oy.shape[0]
    out = torch.empty((N, n, n), dtype=torch.int32, device=dev)
    if N:
        lib = cuda_build.get_lib()
        with torch.cuda.device(dev):
            err = lib.x265_tile_gather(plane.data_ptr(), oy.data_ptr(),
                                       ox.data_ptr(), out.data_ptr(),
                                       N, n, Hp, Wp, _stream(dev))
        cuda_build.check_launch(err, "tile_gather")
        launches["tile_gather"] += 1
    return out


def tile_gather_planes_plain(planes, ridx, oy, ox, n: int):
    P, Hp, Wp = planes.shape
    idx = _window_index(oy, ox, n, Hp, Wp) + _plane_offset(ridx, P, Hp, Wp)
    return planes.reshape(-1)[idx].to(torch.int32)


def tile_gather_planes(planes, ridx, oy, ox, n: int):
    """[N, n, n] int32 tile gather from STACKED int16 planes [P, Hp, Wp],
    one plane index per lane. ridx/oy/ox [N] int32, clipped into range."""
    _check(planes, "planes", torch.int16, 3)
    dev = planes.device
    _check_lanes(dev, ridx=ridx, oy=oy, ox=ox)
    P, Hp, Wp = planes.shape
    _check_tile(n, Hp, Wp)
    if dev.type != "cuda":
        return tile_gather_planes_plain(planes, ridx, oy, ox, n)
    N = oy.shape[0]
    out = torch.empty((N, n, n), dtype=torch.int32, device=dev)
    if N:
        lib = cuda_build.get_lib()
        with torch.cuda.device(dev):
            err = lib.x265_tile_gather_planes(
                planes.data_ptr(), ridx.data_ptr(), oy.data_ptr(),
                ox.data_ptr(), out.data_ptr(), N, n, P, Hp, Wp, _stream(dev))
        cuda_build.check_launch(err, "tile_gather_planes")
        launches["tile_gather_planes"] += 1
    return out


def tile_gather_planes_satd_plain(planes, ridx, oy, ox, cur_blocks, n: int):
    """The gather, then the SATD of its blocks against the current blocks
    repeated K times: the two steps the fused kernel does in one."""
    from x265_tpu_torch.ops.cuda_kernels import satd_plain
    N = cur_blocks.shape[0]
    K = ridx.shape[0] // N
    pred = tile_gather_planes_plain(planes, ridx, oy, ox, n)
    cur = cur_blocks[None].expand(K, N, n, n).reshape(K * N, n, n)
    return satd_plain(cur, pred)


def tile_gather_planes_satd(planes, ridx, oy, ox, cur_blocks, n: int):
    """SATD of cur_blocks [N, n, n] int32 against K candidate windows each,
    without the windows ever being written out -> [K*N] int32.

    Lane j = k*N + i is the n x n window of planes[ridx[j]] at (oy[j],
    ox[j]) (tile_gather_planes' lanes, clipped the same way) scored
    against cur_blocks[i]; the score is ops.cuda_kernels.satd's. planes
    [P, Hp, Wp] int16; ridx/oy/ox [K*N] int32; n in (8, 16, 32)."""
    _check(planes, "planes", torch.int16, 3)
    dev = planes.device
    _check_lanes(dev, ridx=ridx, oy=oy, ox=ox)
    _check(cur_blocks, "cur_blocks", torch.int32, 3, dev)
    P, Hp, Wp = planes.shape
    if n not in (8, 16, 32) or n > Hp or n > Wp:
        raise ValueError(f"SATD tile {n} unsupported for planes {Hp}x{Wp}")
    N = cur_blocks.shape[0]
    if tuple(cur_blocks.shape[1:]) != (n, n):
        raise ValueError(f"cur_blocks is {tuple(cur_blocks.shape)}, expected "
                         f"[N, {n}, {n}]")
    L = oy.shape[0]
    if (L % N) if N else L:
        raise ValueError(f"{L} lanes are not a multiple of {N} blocks")
    if L == 0:
        return torch.empty((0,), dtype=torch.int32, device=dev)
    if dev.type != "cuda":
        return tile_gather_planes_satd_plain(planes, ridx, oy, ox,
                                             cur_blocks, n)
    if cur_blocks.data_ptr() % 16:
        raise ValueError("cur_blocks must be 16-byte aligned")
    out = torch.empty((L,), dtype=torch.int32, device=dev)
    lib = cuda_build.get_lib()
    with torch.cuda.device(dev):
        err = lib.x265_tile_gather_planes_satd(
            planes.data_ptr(), ridx.data_ptr(), oy.data_ptr(),
            ox.data_ptr(), cur_blocks.data_ptr(), out.data_ptr(),
            N, L // N, n, P, Hp, Wp, _stream(dev))
    cuda_build.check_launch(err, "tile_gather_planes_satd")
    launches["tile_gather_planes_satd"] += 1
    return out


# --------------------------------------------------------------------- MC

def mc_gather_interp_plain(planes, ridx, oy, ox, xf, yf, filt,
                           n: int, taps: int, bd: int):
    """The separable interpolation as shifted-slice sums (int32)."""
    R, Hp, Wp = planes.shape
    side = n + taps - 1
    idx = (_window_index(oy, ox, side, Hp, Wp)
           + _plane_offset(ridx, R, Hp, Wp))
    win = planes.reshape(-1)[idx].to(torch.int32)        # [N, side, side]
    nph = filt.shape[0]
    fx = filt[xf.to(torch.int64).clamp(0, nph - 1)]      # [N, taps]
    fy = filt[yf.to(torch.int64).clamp(0, nph - 1)]
    N = oy.shape[0]
    hor = torch.zeros((N, side, n), dtype=torch.int32, device=planes.device)
    for t in range(taps):
        hor += fx[:, t, None, None] * win[:, :, t:t + n]
    hor = hor >> (bd - 8)
    acc = torch.zeros((N, n, n), dtype=torch.int32, device=planes.device)
    for t in range(taps):
        acc += fy[:, t, None, None] * hor[:, t:t + n, :]
    return acc >> 6


def mc_gather_interp(planes, ridx, oy, ox, xf, yf, filt,
                     n: int, taps: int, bd: int):
    """14-bit MC prediction [N, n, n] int32 for N CU lanes.

    planes [R, Hp, Wp] int16 (padded refs); ridx/oy/ox [N] int32
    ABSOLUTE window origins, clipped to [0, dim - side]; xf/yf [N]
    int32 fractional phases; filt [P, taps] int32. Any N, any plane
    size that holds a window."""
    _check(planes, "planes", torch.int16, 3)
    dev = planes.device
    _check_lanes(dev, ridx=ridx, oy=oy, ox=ox, xf=xf, yf=yf)
    _check(filt, "filt", torch.int32, 2, dev)
    if filt.shape[1] != taps:
        raise ValueError(f"filt has {filt.shape[1]} taps, expected {taps}")
    if taps not in (4, 8) or n not in (4, 8, 16, 32, 64) or bd < 8:
        raise ValueError(f"unsupported (n, taps, bd) = ({n}, {taps}, {bd})")
    R, Hp, Wp = planes.shape
    side = n + taps - 1
    if side > Hp or side > Wp:
        raise ValueError(f"window {side} does not fit planes {Hp}x{Wp}")
    if dev.type != "cuda":
        return mc_gather_interp_plain(planes, ridx, oy, ox, xf, yf, filt,
                                      n, taps, bd)
    N = oy.shape[0]
    out = torch.empty((N, n, n), dtype=torch.int32, device=dev)
    if N:
        lib = cuda_build.get_lib()
        with torch.cuda.device(dev):
            err = lib.x265_mc_gather_interp(
                planes.data_ptr(), ridx.data_ptr(), oy.data_ptr(),
                ox.data_ptr(), xf.data_ptr(), yf.data_ptr(),
                filt.data_ptr(), out.data_ptr(), N, n, taps, bd, R,
                filt.shape[0], Hp, Wp, _stream(dev))
        cuda_build.check_launch(err, "mc_gather_interp")
        launches["mc_gather_interp"] += 1
    return out
