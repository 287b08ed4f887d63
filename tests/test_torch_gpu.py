"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: skipped where there is no CUDA device. This file imports
neither jax nor the JAX package, so it also runs on a machine that has
only torch:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""
import numpy as np
import pytest
import torch

from x265_tpu_torch.models.inter_residual import _LUMA_FILT
from x265_tpu_torch.ops import cuda_kernels, cuda_mc


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.gpu
def test_cuda_kernels_equal_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    plane = T(rng.integers(0, 256, (3, 200, 333)).astype(np.int16)).to(dev)
    N = 111
    r = T(rng.integers(0, 3, N).astype(np.int32)).to(dev)
    oy = T(rng.integers(0, 200 - 39, N).astype(np.int32)).to(dev)
    ox = T(rng.integers(0, 333 - 39, N).astype(np.int32)).to(dev)
    xf = T(rng.integers(0, 4, N).astype(np.int32)).to(dev)
    # lanes far outside the planes: clipped by kernel and plain alike
    oy[:4] = torch.tensor([1 << 20, -(1 << 20), -1, 199], device=dev)
    ox[:4] = torch.tensor([-7, 1 << 20, 332, -(1 << 20)], device=dev)
    r[4:6] = torch.tensor([-2, 9], device=dev)
    filt = T(_LUMA_FILT).to(dev)
    before = dict(cuda_mc.launches)
    assert torch.equal(cuda_mc.tile_gather(plane[0].contiguous(), oy, ox, 30),
                       cuda_mc.tile_gather_plain(plane[0], oy, ox, 30))
    assert torch.equal(cuda_mc.tile_gather_planes(plane, r, oy, ox, 16),
                       cuda_mc.tile_gather_planes_plain(plane, r, oy, ox, 16))
    assert torch.equal(
        cuda_mc.mc_gather_interp(plane, r, oy, ox, xf, xf, filt, 32, 8, 8),
        cuda_mc.mc_gather_interp_plain(plane, r, oy, ox, xf, xf, filt,
                                       32, 8, 8))
    # the fused gather + SATD: 3 candidates for each of 37 blocks, the
    # out-of-range lanes above among them (K = N / 37)
    cur37 = T(rng.integers(0, 256, (37, 16, 16)).astype(np.int32)).to(dev)
    fa = (plane, r, oy, ox, cur37, 16)
    assert torch.equal(cuda_mc.tile_gather_planes_satd(*fa),
                       cuda_mc.tile_gather_planes_satd_plain(*fa))
    a = T(rng.integers(0, 256, (N, 16, 16)).astype(np.int32)).to(dev)
    b = T(rng.integers(0, 256, (N, 16, 16)).astype(np.int32)).to(dev)
    assert torch.equal(cuda_kernels.satd(a, b), cuda_kernels.satd_plain(a, b))
    S, R = 8, 5
    cur = T(rng.integers(0, 256, (40, 56)).astype(np.int16)).to(dev)
    ref = T(rng.integers(0, 256, (50, 66)).astype(np.int16)).to(dev)
    mvc = T(rng.integers(0, 9, 121).astype(np.float32)).to(dev)
    assert torch.equal(cuda_kernels.sad_sweep(cur, ref, S, R),
                       cuda_kernels.sad_sweep_plain(cur, ref, S, R))
    for got, want in zip(
            cuda_kernels.sad_sweep_argmin(cur, ref, mvc, S, R),
            cuda_kernels.sad_sweep_argmin_plain(cur, ref, mvc, S, R)):
        assert torch.equal(got, want)
    # the window search: 37 blocks around origins that are clipped too
    la = (cur37, plane[1].contiguous(), oy[:37].contiguous(),
          ox[:37].contiguous(), torch.stack([xf[:37] - 9, 5 - xf[:37]], 1),
          torch.tensor(2.5, device=dev), 16, 7)
    for got, want in zip(cuda_kernels.sad_local_argmin(*la),
                         cuda_kernels.sad_local_argmin_plain(*la)):
        assert torch.equal(got, want)
    for k in before:
        assert cuda_mc.launches[k] == before[k] + 1


def _dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("S,w_r,maxv", [(8, 7, 255), (16, 7, 255),
                                        (32, 7, 255), (64, 7, 255),
                                        (16, 3, 1023), (8, 0, 255)])
def test_window_search_equals_plain_on_the_card(S, w_r, maxv):
    """Both sample widths of the kernel (bytes up to 255, int16 above),
    every block size, clipped origins, a crop as the reference, flat
    content with lam = 0 (d = 0 must win)."""
    dev = _dev()
    rng = np.random.default_rng(S + w_r)
    side = S + 2 * w_r
    big = T(rng.integers(0, maxv + 1, (3 * side + 12, 4 * side + 13))
            .astype(np.int16)).to(dev)
    ref = big[6:-6, 6:-6]
    Hp, Wp = ref.shape
    N = 203
    y0s = T(rng.integers(0, Hp - side + 1, N).astype(np.int32)).to(dev)
    x0s = T(rng.integers(0, Wp - side + 1, N).astype(np.int32)).to(dev)
    y0s[:4] = torch.tensor([1 << 20, -(1 << 20), -1, Hp - side], device=dev)
    x0s[:4] = torch.tensor([-7, 1 << 20, Wp - side, 0], device=dev)
    centers = T(rng.integers(-50, 51, (N, 2)).astype(np.int32)).to(dev)
    from x265_tpu_torch.ops.cuda_mc import tile_gather_plain
    cur = (tile_gather_plain(ref, y0s.clamp(0, Hp - side) + w_r,
                             x0s.clamp(0, Wp - side) + w_r, S)
           + T(rng.integers(-2, 3, (N, S, S)).astype(np.int32)).to(dev)
           ).clamp_(0, maxv).contiguous()
    for lam, c, r in ((2.8284, cur, ref), (0.0, torch.full_like(cur, 9),
                                           torch.full_like(ref, 9))):
        a = (c, r, y0s, x0s, centers, torch.tensor(lam, device=dev), S, w_r)
        gd, gc = cuda_kernels.sad_local_argmin(*a)
        wd, wc = cuda_kernels.sad_local_argmin_plain(*a)
        assert torch.equal(gd, wd) and torch.equal(gc, wc)
    assert not gd.any()


@pytest.mark.gpu
@pytest.mark.parametrize("n,taps", [(4, 4), (8, 4), (16, 4), (32, 4),
                                    (8, 8), (16, 8), (32, 8), (64, 8)])
def test_mc_gather_every_size_equals_plain_on_the_card(n, taps):
    dev = _dev()
    from x265_tpu_torch.models.inter_residual import _CHROMA_FILT
    rng = np.random.default_rng(n + taps)
    side = n + taps - 1
    buf = T(rng.integers(0, 256, 2 * 150 * 161 + 8).astype(np.int16)).to(dev)
    planes = buf[3:3 + 2 * 150 * 161].view(2, 150, 161)   # off the 16-byte grid
    filt = T(_LUMA_FILT if taps == 8 else _CHROMA_FILT).to(dev)
    N = 301
    r = T(rng.integers(-1, 3, N).astype(np.int32)).to(dev)
    oy = T(rng.integers(-5, 150 - side + 6, N).astype(np.int32)).to(dev)
    ox = T(rng.integers(-5, 161 - side + 6, N).astype(np.int32)).to(dev)
    oy[:2] = torch.tensor([1 << 20, 150 - side], device=dev)
    ox[:2] = torch.tensor([-(1 << 20), 161 - side], device=dev)
    ph = T(rng.integers(-1, filt.shape[0] + 1, N).astype(np.int32)).to(dev)
    a = (planes, r, oy, ox, ph, ph.flip(0).contiguous(), filt, n, taps, 8)
    assert torch.equal(cuda_mc.mc_gather_interp(*a),
                       cuda_mc.mc_gather_interp_plain(*a))


@pytest.mark.gpu
@pytest.mark.parametrize("S,R,h,w", [(8, 29, 64, 96), (16, 16, 48, 80),
                                     (4, 6, 28, 44), (32, 8, 96, 160),
                                     (8, 3, 64, 104), (16, 7, 16, 16),
                                     (8, 4, 544, 960)])
def test_sad_sweep_geometries_equal_plain_on_the_card(S, R, h, w):
    dev = _dev()
    rng = np.random.default_rng(S * R)
    n = 2 * R + 1
    for maxv in (255, 1023):
        ref = T(rng.integers(0, maxv + 1, (h + 2 * R, w + 2 * R))
                .astype(np.int16)).to(dev)
        cur = ref[R + 1:R + 1 + h, R - 2:R - 2 + w].contiguous()
        mvc = T((rng.integers(0, 40, n * n) * 0.7).astype(np.float32)).to(dev)
        assert torch.equal(cuda_kernels.sad_sweep(cur, ref, S, R),
                           cuda_kernels.sad_sweep_plain(cur, ref, S, R))
        for got, want in zip(
                cuda_kernels.sad_sweep_argmin(cur, ref, mvc, S, R),
                cuda_kernels.sad_sweep_argmin_plain(cur, ref, mvc, S, R)):
            assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("oh,ow", [(540, 960), (720, 1280)])
def test_scaler_on_the_card_equals_the_cpu(bits, oh, ow):
    """io/scaler.py on the card against its CPU result on a 1080p plane:
    area averaging (ratio 2) is integer and exact; the polyphase bank
    (ratio 2/3) is two float32 products whose sums the card may round in
    another order, so a sample may land one step away after rounding:
    every sample within 1, and the count of those that differ reported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from x265_tpu_torch.io.scaler import scale_plane
    rng = np.random.default_rng(bits + oh)
    maxv = (1 << bits) - 1
    plane = rng.integers(0, maxv + 1, (1080, 1920)).astype(
        np.uint16 if bits > 8 else np.uint8)
    card = scale_plane(plane, oh, ow, device="cuda")
    cpu = scale_plane(plane, oh, ow, device="cpu")
    diff = np.abs(card.astype(np.int32) - cpu.astype(np.int32))
    if oh * 2 == 1080:
        assert diff.max() == 0
    else:
        assert diff.max() <= 1, int(diff.max())
        print(f"polyphase {bits}-bit: {int((diff > 0).sum())} of "
              f"{diff.size} samples differ")


@pytest.mark.gpu
def test_checked_tq_chain_on_the_card(monkeypatch):
    """X265TPU_CHECKIFY=1 on the card: a clean batch gives the unchecked
    chain's outputs (and the CPU's); QP 99 raises with the JAX package's
    message, and the CUDA context stays usable (no device assert)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from x265_tpu_torch.models.residual import tq_chain
    from x265_tpu_torch.utils import checks
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    resi = T(rng.integers(-200, 201, (8, 16, 16)).astype(np.int32))
    qp = torch.full((8,), 30, dtype=torch.int32)
    sel = torch.zeros(8, dtype=torch.int32)
    args = (16, False, False, 8, True, True, False)
    monkeypatch.delenv("X265TPU_CHECKIFY", raising=False)
    want = tq_chain(resi, qp, sel, *args)
    plain = tq_chain(resi.to(dev), qp.to(dev), sel.to(dev), *args)
    monkeypatch.setenv("X265TPU_CHECKIFY", "1")
    got = tq_chain(resi.to(dev), qp.to(dev), sel.to(dev), *args)
    for a, b, c in zip(got, plain, want):
        assert torch.equal(a.cpu(), b.cpu()) and torch.equal(a.cpu(), c)
    with pytest.raises(checks.CheckError, match="QP out of range"):
        tq_chain(resi.to(dev), torch.full((8,), 99, dtype=torch.int32,
                                          device=dev), sel.to(dev), *args)
    again = tq_chain(resi.to(dev), qp.to(dev), sel.to(dev), *args)
    torch.cuda.synchronize()
    assert torch.equal(again[0].cpu(), want[0])
