"""The port's kernels' plain versions (what a CPU tensor gets) against
the JAX package: the Pallas SATD in interpret mode, and the jnp twins of
the three gather kernels. All integer: exact equality.

The CUDA kernels themselves have no interpret mode; the test that
launches them is tests/test_torch_gpu.py (marked `gpu`), held against the
same plain versions on the card (chip_smoke.py does the same at 1080p
shapes).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import x265_tpu.models.inter_residual as jir
import x265_tpu.engine.me as jme
from x265_tpu.ops import pallas_kernels as jpk

import x265_tpu_torch.models.inter_residual as tir
import x265_tpu_torch.engine.me as tme
from x265_tpu_torch.ops import cuda_kernels, cuda_mc
import torch_port_util  # noqa: F401  (one torch thread)


def T(a, dt=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dt is None else t.to(dt)


@pytest.mark.parametrize("S,N", [(8, 300), (16, 100), (32, 9)])
def test_satd_matches_pallas_interpret_and_jnp(S, N):
    rng = np.random.default_rng(S)
    a = rng.integers(0, 256, (N, S, S)).astype(np.int32)
    b = rng.integers(0, 256, (N, S, S)).astype(np.int32)
    want = np.asarray(jpk.satd_pallas(jnp.asarray(a), jnp.asarray(b),
                                      interpret=True))
    twin = np.asarray(jme.satd8_batched(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(want, twin)
    got = cuda_kernels.satd(T(a), T(b))            # CPU tensor -> plain
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tme.satd8_batched(T(a), T(b)).numpy(), want)
    assert cuda_mc.launches["satd8x8"] == 0        # no kernel on the CPU


@pytest.mark.parametrize("n,taps,bd", [(16, 8, 8), (8, 4, 8), (32, 8, 8),
                                       (64, 8, 8), (32, 4, 8)])
def test_mc_gather_matches_jnp_twin(n, taps, bd):
    rng = np.random.default_rng(0)
    H, W, pad = 256, 448, 80
    R = 2
    planes = rng.integers(
        0, (1 << bd) - 1, (R, H + 2 * pad, W + 2 * pad)).astype(np.int16)
    N = 100                     # deliberately not a multiple of 8
    filt = jir._LUMA_FILT if taps == 8 else jir._CHROMA_FILT
    fb = 2 if taps == 8 else 3
    args = [rng.integers(0, R, N).astype(np.int32),
            rng.integers(0, W - n, N).astype(np.int32),
            rng.integers(0, H - n, N).astype(np.int32),
            rng.integers(-228, 228, N).astype(np.int32),
            rng.integers(-228, 228, N).astype(np.int32)]
    # sentinel origins: far outside, clamped by both sides
    args[1][:3] = (1 << 20, -(1 << 20), 5)
    args[2][:3] = (7, 1 << 20, -(1 << 20))
    want = np.asarray(jir._mc_gather(
        jnp.asarray(planes), *(jnp.asarray(a) for a in args), filt=filt,
        fb=fb, n=n, taps=taps, pad=pad, bd=bd))
    got = tir._mc_gather(T(planes), *(T(a) for a in args), filt=T(filt),
                         fb=fb, n=n, taps=taps, pad=pad, bd=bd)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_tile_gather_matches_jnp_twin_with_sentinels():
    rng = np.random.default_rng(1)
    H, W = 256, 448
    src = rng.integers(0, 255, (H, W)).astype(np.uint8)
    N = 66
    ys = np.concatenate([rng.integers(0, H - 16, N - 2),
                         [1 << 20, 5]]).astype(np.int32)
    xs = np.concatenate([rng.integers(0, W - 16, N - 2),
                         [3, 1 << 20]]).astype(np.int32)
    for size in (16, 30, 4):
        want = np.asarray(jir.gather_src_blocks(
            jnp.asarray(src), jnp.asarray(ys), jnp.asarray(xs), size))
        got = tir.gather_src_blocks(T(src), T(ys), T(xs), size)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)


def test_gather_phase_blocks_matches_jnp_twin():
    rng = np.random.default_rng(2)
    Hm, Wm, S, N = 96, 160, 16, 77
    planes = rng.integers(0, 256, (4, 4, Hm, Wm)).astype(np.int16)
    fy = rng.integers(0, 4, N).astype(np.int32)
    fx = rng.integers(0, 4, N).astype(np.int32)
    # some beyond the far edge: both sides clamp them to dim - S (the
    # tile kernels' contract is clip-into-range; origins are never
    # negative on the encoder's path, where the twin would wrap instead)
    iy = rng.integers(0, Hm + 8, N).astype(np.int32)
    ix = rng.integers(0, Wm + 8, N).astype(np.int32)
    want = np.asarray(jme._gather_phase_blocks(
        jnp.asarray(planes), jnp.asarray(fy), jnp.asarray(fx),
        jnp.asarray(iy), jnp.asarray(ix), S))
    got = tme._gather_phase_blocks(T(planes), T(fy), T(fx), T(iy), T(ix), S)
    assert np.array_equal(got.numpy(), want)


def test_plain_versions_clip_every_index_into_range():
    rng = np.random.default_rng(3)
    planes = T(rng.integers(0, 256, (3, 40, 50)).astype(np.int16))
    oy = T(np.array([-5, 1 << 20, 7, 39], np.int32))
    ox = T(np.array([1 << 20, -9, 49, 3], np.int32))
    r = T(np.array([-1, 7, 1, 2], np.int32))
    cy = T(np.array([0, 32, 7, 32], np.int32))
    cx = T(np.array([42, 0, 42, 3], np.int32))
    cr = T(np.array([0, 2, 1, 2], np.int32))
    assert torch.equal(cuda_mc.tile_gather(planes[1], oy, ox, 8),
                       cuda_mc.tile_gather(planes[1], cy, cx, 8))
    assert torch.equal(cuda_mc.tile_gather_planes(planes, r, oy, ox, 8),
                       cuda_mc.tile_gather_planes(planes, cr, cy, cx, 8))
    filt = T(jir._CHROMA_FILT)
    ph = T(np.array([-1, 9, 3, 7], np.int32))
    cph = T(np.array([0, 7, 3, 7], np.int32))
    my = T(np.array([0, 29, 7, 29], np.int32))      # dim - (8 + 4 - 1)
    mx = T(np.array([39, 0, 39, 3], np.int32))
    assert torch.equal(
        cuda_mc.mc_gather_interp(planes, r, oy, ox, ph, ph, filt, 8, 4, 8),
        cuda_mc.mc_gather_interp(planes, cr, my, mx, cph, cph, filt, 8, 4, 8))


def test_wrappers_reject_bad_arguments():
    plane = torch.zeros((64, 64), dtype=torch.int16)
    o = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        cuda_mc.tile_gather(plane.to(torch.int32), o, o, 8)
    with pytest.raises(TypeError):
        cuda_mc.tile_gather(plane, o.long(), o, 8)
    with pytest.raises(ValueError):
        cuda_mc.tile_gather(plane.t(), o, o, 8)        # not contiguous
    with pytest.raises(ValueError):
        cuda_mc.tile_gather(plane, o, o, 65)
    with pytest.raises(ValueError):
        cuda_kernels.satd(torch.zeros((2, 12, 12), dtype=torch.int32),
                          torch.zeros((2, 12, 12), dtype=torch.int32))
    # the fused gather + SATD entry
    planes = torch.zeros((2, 64, 64), dtype=torch.int16)
    o8 = torch.zeros(8, dtype=torch.int32)
    cur = torch.zeros((4, 16, 16), dtype=torch.int32)
    assert cuda_mc.tile_gather_planes_satd(planes, o8, o8, o8, cur,
                                           16).shape == (8,)
    with pytest.raises(TypeError):                     # cur must be int32
        cuda_mc.tile_gather_planes_satd(planes, o8, o8, o8,
                                        cur.to(torch.int16), 16)
    with pytest.raises(TypeError):                     # planes must be int16
        cuda_mc.tile_gather_planes_satd(planes.to(torch.int32), o8, o8, o8,
                                        cur, 16)
    with pytest.raises(ValueError):                    # 8 lanes, 3 blocks
        cuda_mc.tile_gather_planes_satd(planes, o8, o8, o8, cur[:3], 16)
    with pytest.raises(ValueError):                    # S not a multiple of 8
        cuda_mc.tile_gather_planes_satd(
            planes, o8, o8, o8, torch.zeros((4, 12, 12), dtype=torch.int32),
            12)
    with pytest.raises(ValueError):                    # blocks are not S x S
        cuda_mc.tile_gather_planes_satd(planes, o8, o8, o8, cur, 8)
    with pytest.raises(ValueError):                    # lanes but no block
        cuda_mc.tile_gather_planes_satd(planes, o8, o8, o8, cur[:0], 16)


@pytest.mark.parametrize("n,taken", [(30, True), (64, True), (78, True),
                                     (79, False), (100, False)])
def test_gather_wrappers_take_the_tile_sizes_the_kernels_take(n, taken):
    """Powers of two up to 64, and any other size up to the largest search
    patch (64 + 2*7): the same answer on every device, so a size the
    kernels refuse is refused for CPU tensors too."""
    rng = np.random.default_rng(n)
    planes = T(rng.integers(0, 256, (2, 120, 130)).astype(np.int16))
    r = T(np.array([1, 0, 5], np.int32))
    oy = T(np.array([0, 120 - n, 1 << 20], np.int32))
    ox = T(np.array([130 - n, 3, -4], np.int32))
    if not taken:
        with pytest.raises(ValueError):
            cuda_mc.tile_gather(planes[0], oy, ox, n)
        with pytest.raises(ValueError):
            cuda_mc.tile_gather_planes(planes, r, oy, ox, n)
        return
    assert torch.equal(cuda_mc.tile_gather(planes[0], oy, ox, n),
                       cuda_mc.tile_gather_plain(planes[0], oy, ox, n))
    assert torch.equal(cuda_mc.tile_gather_planes(planes, r, oy, ox, n),
                       cuda_mc.tile_gather_planes_plain(planes, r, oy, ox, n))


@pytest.mark.parametrize("mod,name", [
    (cuda_mc, "tile_gather"), (cuda_mc, "tile_gather_planes"),
    (cuda_mc, "tile_gather_planes_satd"),
    (cuda_mc, "mc_gather_interp"), (cuda_kernels, "satd"),
    (cuda_kernels, "sad_sweep"), (cuda_kernels, "sad_sweep_argmin"),
    (cuda_kernels, "sad_local_argmin")])
def test_wrapper_reaches_plain_version_only_for_cpu_tensors(mod, name):
    """The device of the tensor alone decides: no switch, no try/except."""
    import inspect
    lines = inspect.getsource(getattr(mod, name)).splitlines()
    calls = [i for i, l in enumerate(lines) if f"{name}_plain(" in l]
    assert len(calls) == 1
    assert lines[calls[0] - 1].strip() == 'if dev.type != "cuda":'
    assert not any(l.strip().startswith(("try:", "except")) for l in lines)


def _local_args(S=16, w_r=7, N=5, Hp=64, Wp=80):
    return [torch.zeros((N, S, S), dtype=torch.int32),
            torch.zeros((Hp, Wp), dtype=torch.int16),
            torch.zeros(N, dtype=torch.int32), torch.zeros(N, dtype=torch.int32),
            torch.zeros((N, 2), dtype=torch.int32), torch.tensor(1.5), S, w_r]


@pytest.mark.parametrize("what,exc", [
    ("cur int16", TypeError), ("ref int32", TypeError),
    ("origins int64", TypeError), ("lam float64", TypeError),
    ("lam vector", ValueError), ("centers flat", ValueError),
    ("centers count", ValueError), ("origins count", ValueError),
    ("blocks not S", ValueError), ("S=12", ValueError), ("S=4", ValueError),
    ("patch above 78", ValueError), ("patch above plane", ValueError),
    ("negative W_r", ValueError), ("ref columns strided", ValueError),
    ("ref 3-D", ValueError)])
def test_window_search_wrapper_rejects_bad_arguments(what, exc):
    """Refused for CPU tensors exactly as for CUDA tensors: the checks come
    before the device decides between kernel and plain version."""
    a = _local_args()
    if what == "cur int16":
        a[0] = a[0].to(torch.int16)
    elif what == "ref int32":
        a[1] = a[1].to(torch.int32)
    elif what == "origins int64":
        a[2] = a[2].long()
    elif what == "lam float64":
        a[5] = a[5].double()
    elif what == "lam vector":
        a[5] = torch.ones(1)
    elif what == "centers flat":
        a[4] = a[4].reshape(-1)
    elif what == "centers count":
        a[4] = a[4][:3]
    elif what == "origins count":
        a[2], a[3] = a[2][:3], a[3][:3]
    elif what == "blocks not S":
        a[6] = 8
    elif what == "S=12":
        a[0], a[6] = torch.zeros((5, 12, 12), dtype=torch.int32), 12
    elif what == "S=4":
        a[0], a[6] = torch.zeros((5, 4, 4), dtype=torch.int32), 4
    elif what == "patch above 78":
        a = _local_args(S=64, w_r=8, Hp=100, Wp=100)
    elif what == "patch above plane":
        a = _local_args(S=32, w_r=7, Hp=40, Wp=80)
    elif what == "negative W_r":
        a[7] = -1
    elif what == "ref columns strided":
        a[1] = torch.zeros((80, 64), dtype=torch.int16).t()
    elif what == "ref 3-D":
        a[1] = a[1][None]
    with pytest.raises(exc):
        cuda_kernels.sad_local_argmin(*a)


def test_window_search_wrapper_takes_what_the_kernel_takes():
    for S, w_r in ((8, 7), (16, 7), (32, 7), (64, 7), (16, 0), (8, 35)):
        d, c = cuda_kernels.sad_local_argmin(*_local_args(S, w_r, 3, 90, 100))
        assert d.dtype == torch.int32 and c.dtype == torch.float32
        assert d.shape == c.shape == (3,)
    d, c = cuda_kernels.sad_local_argmin(*_local_args(N=0))
    assert d.shape == c.shape == (0,)
