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
    # the SATD kernel's intra entry: DC-removed int16 blocks against zero
    a16 = T(rng.integers(-255, 256, (N, 8, 8)).astype(np.int16)).to(dev)
    assert torch.equal(cuda_kernels.satd_intra(a16),
                       cuda_kernels.satd_intra_plain(a16))
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


@pytest.mark.gpu
@pytest.mark.parametrize("R,subme", [(16, 0), (16, 2), (57, 0), (57, 2)])
def test_motion_decide_on_the_card_equals_the_cpu(R, subme):
    """The standalone motion API on the card (kernel 5's fused sweep or,
    at R=57, its window entry after the half-size sweep; kernel 3's fused
    gather + SATD in the subpel rounds) against the plain versions on the
    CPU: mvs and costs exact; with return_aux also eval_mvs,
    refine_with_mvp, smooth_mv_field and bi_cost."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from x265_tpu_torch.engine import me
    rng = np.random.default_rng(R + subme)
    h, w = 128, 192
    big = rng.integers(0, 256, (h + 64, w + 64)).astype(np.float32)
    for _ in range(2):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) / 3
    ref = big[16:16 + h, 16:16 + w].astype(np.uint8)
    cur = big[19:19 + h, 13:13 + w].astype(np.uint8)
    kw = dict(S=16, R=R, qp=30, subme=subme)
    before = dict(cuda_mc.launches)
    got = me.motion_decide(cur, ref, w, h, device="cuda", **kw)
    want = me.motion_decide(cur, ref, w, h, device="cpu", **kw)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    entry = "sad_local_argmin" if R > 24 else "sad_sweep_argmin"
    assert cuda_mc.launches[entry] > before[entry]
    if subme == 0:
        return
    kw["return_aux"] = True
    mv, cost, aux = me.motion_decide(cur, ref, w, h, device="cuda", **kw)
    cmv, ccost, caux = me.motion_decide(cur, ref, w, h, device="cpu", **kw)
    mv1, _, aux1 = me.motion_decide(cur, cur, w, h, device="cuda", **kw)
    _, _, caux1 = me.motion_decide(cur, cur, w, h, device="cpu", **kw)
    mvp = me.mv_field_median3(mv)
    assert np.array_equal(me.eval_mvs(aux, mv), me.eval_mvs(caux, mv))
    for a, b in zip(me.refine_with_mvp(aux, mv, mvp),
                    me.refine_with_mvp(caux, mv, mvp)):
        assert np.array_equal(a, b)
    assert np.array_equal(me.smooth_mv_field(mv, cost, aux, aux["lam"]),
                          me.smooth_mv_field(mv, cost, caux, caux["lam"]))
    assert np.array_equal(me.bi_cost(mv, aux, mv1, aux1),
                          me.bi_cost(mv, caux, mv1, caux1))


@pytest.mark.gpu
@pytest.mark.parametrize("nt", [4, 8, 16, 32])
def test_predict_intra_batch_on_the_card_equals_the_cpu(nt):
    """models/intra_pred.predict_intra_batch (plain PyTorch) on the card:
    every mode, luma and chroma, strong smoothing on and off, 8 and 10
    bits, partial availability; exact against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from x265_tpu_torch.models.intra_pred import predict_intra_batch
    rng = np.random.default_rng(nt)
    R, N = 4 * nt + 1, 140
    modes = np.tile(np.arange(35, dtype=np.int32), 4)
    for bd in (8, 10):
        refs = rng.integers(0, 1 << bd, (N, R)).astype(np.int32)
        refs[::3] = (100 << (bd - 8)) + np.arange(R) // 8
        avail = rng.random((N, R)) < 0.8
        avail[::4] = True
        for luma in (True, False):
            for strong in (False, True):
                a = (refs, avail, modes, nt, bd, luma, strong)
                got = predict_intra_batch(*a, device="cuda")
                assert got.is_cuda
                assert torch.equal(got.cpu(),
                                   predict_intra_batch(*a, device="cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("S,N", [(8, 1), (8, 3), (8, 8160), (16, 3),
                                 (16, 1003), (24, 5), (32, 77), (64, 3)])
def test_satd_every_shape_equals_plain_on_the_card(S, N):
    """Kernel 4's two-operand entry: eight lanes a sub-block, four blocks
    a warp at S=8 (ragged N: the last warp part-filled), a warp a block
    at S=16, a CTA a block above; 8- and 10-bit samples."""
    dev = _dev()
    rng = np.random.default_rng(S * N)
    for maxv in (255, 1023):
        a = T(rng.integers(0, maxv + 1, (N, S, S)).astype(np.int32)).to(dev)
        b = T(rng.integers(0, maxv + 1, (N, S, S)).astype(np.int32)).to(dev)
        assert torch.equal(cuda_kernels.satd(a, b),
                           cuda_kernels.satd_plain(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 3, 5, 8160, 10 * 8160])
def test_satd_intra_equals_plain_on_the_card(N):
    """Kernel 4's one-operand int16 entry at the lookahead's and a pair
    window's shapes, with the extreme samples of 8 and 10 bits and of
    int16: equal to its plain version and to satd(a, zeros); one launch a
    call."""
    dev = _dev()
    rng = np.random.default_rng(N)
    for maxv in (255, 1023, 32767):
        a = rng.integers(-maxv, maxv + 1, (N, 8, 8))
        a[:3] = np.stack([np.full((8, 8), maxv), np.full((8, 8), -maxv),
                          np.where(np.indices((8, 8)).sum(0) % 2, maxv,
                                   -maxv)])[:N]
        a = T(a.astype(np.int16)).to(dev)
        before = cuda_mc.launches["satd8x8_intra"]
        got = cuda_kernels.satd_intra(a)
        assert cuda_mc.launches["satd8x8_intra"] == before + 1
        assert torch.equal(got, cuda_kernels.satd_intra_plain(a))
        a32 = a.to(torch.int32)
        assert torch.equal(got, cuda_kernels.satd(a32, torch.zeros_like(a32)))


@pytest.mark.gpu
@pytest.mark.parametrize("P,h,w,R,maxv", [(1, 64, 96, 8, 255),
                                          (3, 64, 96, 8, 1023),
                                          (17, 40, 56, 8, 255),
                                          (5, 64, 104, 4, 255),
                                          (2, 544, 960, 8, 1023)])
def test_batched_sweep_argmin_equals_plain_on_the_card(P, h, w, R, maxv):
    """Kernel 5's argmin entry over a stack of P planes (a grid row a
    plane) in one launch == its plain version == P one-plane launches."""
    dev = _dev()
    rng = np.random.default_rng(P * R)
    ref = T(rng.integers(0, maxv + 1, (P, h + 2 * R, w + 2 * R))
            .astype(np.int16)).to(dev)
    cur = ref[:, R + 1:R + 1 + h, R - 2:R - 2 + w].contiguous()
    mvc = torch.zeros(((2 * R + 1) ** 2,), dtype=torch.float32, device=dev)
    before = cuda_mc.launches["sad_sweep_argmin"]
    gi, gc = cuda_kernels.sad_sweep_argmin(cur, ref, mvc, 8, R)
    assert cuda_mc.launches["sad_sweep_argmin"] == before + 1
    wi, wc = cuda_kernels.sad_sweep_argmin_plain(cur, ref, mvc, 8, R)
    assert torch.equal(gi, wi) and torch.equal(gc, wc)
    for p in range(P):
        si, sc = cuda_kernels.sad_sweep_argmin(cur[p], ref[p], mvc, 8, R)
        assert torch.equal(si, gi[p]) and torch.equal(sc, gc[p])


@pytest.mark.gpu
def test_batched_pair_costs_on_the_card_equals_the_cpu():
    """A window's pairs costed on the card in one intra launch, one sweep
    launch and one copy == the CPU's plain versions; the window's second
    call comes from the memo and launches nothing."""
    dev = _dev()
    from x265_tpu_torch.engine import lookahead
    rng = np.random.default_rng(9)
    lows = [rng.integers(0, 256, (64, 96)).astype(np.int32)
            for _ in range(6)]
    lows_dev = [T(x).to(dev) for x in lows]
    idx = [(c, r) for r in range(6) for c in range(6) if c != r][:17]
    before = dict(cuda_mc.launches)
    got = lookahead.batched_pair_costs(
        [(lows_dev[c], lows_dev[r]) for c, r in idx], device=dev)
    assert cuda_mc.launches["satd8x8_intra"] == before["satd8x8_intra"] + 1
    assert (cuda_mc.launches["sad_sweep_argmin"]
            == before["sad_sweep_argmin"] + 1)
    want = lookahead.batched_pair_costs(
        [(lows[c], lows[r]) for c, r in idx], device="cpu")
    for g, w_ in zip(got, want):
        assert np.array_equal(g, w_)
    again = lookahead.batched_pair_costs(
        [(lows_dev[c], lows_dev[r]) for c, r in idx], device=dev)
    assert all(a is b for a, b in zip(again, got))
    assert cuda_mc.launches["sad_sweep_argmin"] == (
        before["sad_sweep_argmin"] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4, 8])
def test_tiles_on_the_card_equal_the_cpu_tiles(n):
    """parallel/tiles on n tiles of the card: the band step (kernel 5 a
    band) equals the same mesh on the CPU, the min-SAD exactly (and the
    whole-frame plain sweep), the intra costs within 1e-4 relative; the
    mesh's intra decisions and motion search equal the unsharded ones on
    the card."""
    dev = _dev()
    from x265_tpu_torch.engine import me
    from x265_tpu_torch.models.intra_frame import (
        decide_intra_frame_tpu_with_cost)
    from x265_tpu_torch.parallel.tiles import (make_tile_mesh,
                                               mesh_intra_decisions,
                                               sharded_frame_analysis)
    from x265_tpu_torch.utils.testclip import make_clip
    gpu = make_tile_mesh(n, devices=[dev] * n)
    cpu = make_tile_mesh(n, devices=["cpu"] * n)
    H, W = 32 * n, 192
    rng = np.random.default_rng(n)
    y = rng.integers(0, 256, (H, W)).astype(np.int32)
    ref = np.concatenate([np.repeat(y[:1], 5, axis=0), y[:-5]])
    before = cuda_mc.launches["sad_sweep_argmin"]
    got = sharded_frame_analysis(gpu, y, ref)
    assert cuda_mc.launches["sad_sweep_argmin"] == before + n
    want = sharded_frame_analysis(cpu, y, ref)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[2].cpu(), want[2])
    assert int(got[2][:-1].max()) == 0
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].numpy(),
                               rtol=1e-4)
    cur = T(y.astype(np.int16)).to(dev)
    ref_pad = T(np.pad(ref, 8, mode="edge").astype(np.int16)).to(dev)
    zero = torch.zeros((17 * 17,), dtype=torch.float32, device=dev)
    _, whole = cuda_kernels.sad_sweep_argmin_plain(cur, ref_pad, zero, 16, 8)
    assert torch.equal(got[2], whole.to(torch.int32))
    frames = make_clip(W, H, 3, seed=n)
    dec, icost = mesh_intra_decisions(gpu, frames[1][0], W, H)
    one, icost1 = decide_intra_frame_tpu_with_cost(frames[1][0], W, H,
                                                   device=dev)
    assert np.array_equal(dec.luma_mode8, one.luma_mode8)
    assert np.array_equal(icost, icost1)
    kw = dict(S=16, R=57, qp=30, do_bi=True)
    refs = [frames[0][0], frames[2][0]]
    for a, b in zip(me.motion_fused(frames[1][0], refs, W, H, mesh=gpu,
                                    device=dev, **kw),
                    me.motion_fused(frames[1][0], refs, W, H, device=dev,
                                    **kw)):
        assert np.array_equal(a, b)


@pytest.mark.gpu
def test_sweep_at_the_band_shape_equals_plain_on_the_card():
    """Kernel 5's fused entry at _band_step's 1080p band (4 tiles: cur
    [272,1920], ref_pad [288,1936], S=16, R=8, zero mv cost) == its plain
    version, on 8- and 10-bit samples."""
    dev = _dev()
    rng = np.random.default_rng(272)
    for maxv in (255, 1023):
        ref = T(rng.integers(0, maxv + 1, (288, 1936)).astype(np.int16)
                ).to(dev)
        cur = ref[3:275, 10:1930].contiguous()
        zero = torch.zeros((17 * 17,), dtype=torch.float32, device=dev)
        gi, gc = cuda_kernels.sad_sweep_argmin(cur, ref, zero, 16, 8)
        wi, wc = cuda_kernels.sad_sweep_argmin_plain(cur, ref, zero, 16, 8)
        assert torch.equal(gi, wi) and torch.equal(gc, wc)
        assert float(gc.max()) == 0.0
