"""The per-block window search of the port (engine.me._local_search and
its kernel entry ops.cuda_kernels.sad_local_argmin, whose plain version a
CPU tensor gets) against the JAX package's _local_search on the same numpy
inputs, and against a displacement-by-displacement numpy scan. Integer
SADs, integer mv bits, one fp32 multiply and one fp32 add: motion vectors
are compared exactly everywhere, and costs exactly against the numpy scan.
Against the JAX package the cost is held to 2 ulp (rtol 2.4e-7): XLA's CPU
code contracts sad + lam * bits into one fused multiply-add, which rounds
once where the port (and the card) round twice. The CUDA kernel itself is
held against the same plain version on the card (tests/test_torch_gpu.py,
chip_smoke.py)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from x265_tpu.engine import me as jme
from x265_tpu_torch.engine import me as tme
from x265_tpu_torch.ops import cuda_kernels, cuda_mc
import torch_port_util  # noqa: F401  (one torch thread)

W_R = 7
PAD = 20


def T(a, dt=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dt is None else t.to(dt)


def _inputs(S, case, seed=0, nby=4, nbx=6, maxv=255):
    """cur_blocks [N,S,S], ref_pad, centers [N,2], bxy [N,2], lam."""
    rng = np.random.default_rng(seed + S)
    H, W = nby * S, nbx * S
    lim = PAD - W_R
    if case == "flat":
        ref_pad = np.full((H + 2 * PAD, W + 2 * PAD), 77, np.int32)
        cur = np.full((H, W), 77, np.int32)
    else:
        ref_pad = rng.integers(0, maxv + 1,
                               (H + 2 * PAD, W + 2 * PAD)).astype(np.int32)
        cur = np.clip(ref_pad[PAD + 3:PAD + 3 + H, PAD - 5:PAD - 5 + W]
                      + rng.integers(-2, 3, (H, W)), 0, maxv).astype(np.int32)
    bx, by = np.meshgrid(np.arange(nbx), np.arange(nby))
    bxy = np.stack([bx.ravel(), by.ravel()], axis=1).astype(np.int32)
    N = nby * nbx
    if case == "clamp":
        # every centre on the clamp: the patches touch the plane's borders
        centers = rng.choice([-lim, lim], (N, 2)).astype(np.int32)
    else:
        centers = rng.integers(-lim, lim + 1, (N, 2)).astype(np.int32)
        centers[:4] = [[-5, 3], [-lim, lim], [lim, -lim], [0, 0]]
    lam = np.float32(0.0 if case == "zero_lam" else 2.8284)
    blocks = (cur.reshape(nby, S, nbx, S).transpose(0, 2, 1, 3)
              .reshape(N, S, S))
    return blocks, ref_pad, centers, bxy, lam


def _numpy_scan(blocks, ref_pad, y0s, x0s, centers, lam, S, w_r):
    """The definition: displacements in d order, strict <, patch origins
    clipped into the plane, fp32 multiply then fp32 add."""
    n = 2 * w_r + 1
    side = S + 2 * w_r
    Hp, Wp = ref_pad.shape
    best_d = np.zeros(len(blocks), np.int32)
    best_c = np.full(len(blocks), np.inf, np.float32)
    for i, blk in enumerate(blocks):
        y0 = min(max(int(y0s[i]), 0), Hp - side)
        x0 = min(max(int(x0s[i]), 0), Wp - side)
        patch = ref_pad[y0:y0 + side, x0:x0 + side].astype(np.int64)
        for d in range(n * n):
            dy, dx = divmod(d, n)
            sad = np.abs(blk - patch[dy:dy + S, dx:dx + S]).sum()
            mv = centers[i] + np.array([dx - w_r, dy - w_r])
            bits = np.float32(jme._mv_bits(4 * mv).sum())
            c = np.float32(sad) + np.float32(np.float32(lam) * bits)
            if c < best_c[i]:
                best_c[i], best_d[i] = c, d
    return best_d, best_c


@pytest.mark.parametrize("S", [8, 16])
@pytest.mark.parametrize("case", ["texture", "clamp", "flat", "zero_lam"])
def test_local_search_matches_jax(S, case):
    blocks, ref_pad, centers, bxy, lam = _inputs(S, case)
    mj, cj = jme._local_search(jnp.asarray(blocks), jnp.asarray(ref_pad),
                               jnp.asarray(centers), jnp.asarray(bxy),
                               jnp.float32(lam), S, W_R, PAD)
    before = dict(cuda_mc.launches)
    mt, ct = tme._local_search(T(blocks), T(ref_pad), T(centers), T(bxy),
                               torch.tensor(lam), S, W_R, PAD)
    assert mt.dtype == torch.int32 and ct.dtype == torch.float32
    assert np.array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=2.4e-7,
                               atol=0)
    assert cuda_mc.launches == before              # no kernel on the CPU
    if case == "texture":
        # the planted motion (-5, 3) is found from the centre next to it
        assert tuple(mt.numpy()[0]) == (-5, 3)
    if case == "flat":
        # every SAD is 0: the cost is the mv cost alone
        bits = jme._mv_bits(4 * mt.numpy()).sum(axis=1)
        assert np.array_equal(ct.numpy(), np.float32(lam) * bits)


@pytest.mark.parametrize("S,w_r,maxv", [(8, 7, 255), (16, 7, 255),
                                        (16, 3, 1023), (32, 2, 255),
                                        (8, 0, 255)])
def test_plain_version_is_the_scan_in_d_order(S, w_r, maxv):
    rng = np.random.default_rng(S * 10 + w_r)
    N = 13
    side = S + 2 * w_r
    Hp, Wp = 3 * side, 4 * side + 1
    ref_pad = rng.integers(0, maxv + 1, (Hp, Wp)).astype(np.int16)
    ref_pad[:side, :] = 9                  # a constant region: equal SADs
    blocks = rng.integers(0, maxv + 1, (N, S, S)).astype(np.int32)
    y0s = rng.integers(0, Hp - side + 1, N).astype(np.int32)
    x0s = rng.integers(0, Wp - side + 1, N).astype(np.int32)
    y0s[:4] = [0, -9, 1 << 20, Hp - side]  # clipped like tile_gather
    x0s[:4] = [3, 1 << 20, -(1 << 20), Wp - side]
    centers = rng.integers(-40, 41, (N, 2)).astype(np.int32)
    centers[0] = 0
    for lam in (0.0, 1.4142):
        want_d, want_c = _numpy_scan(blocks, ref_pad, y0s, x0s, centers, lam,
                                     S, w_r)
        got_d, got_c = cuda_kernels.sad_local_argmin(
            T(blocks), T(ref_pad), T(y0s), T(x0s), T(centers),
            torch.tensor(lam, dtype=torch.float32), S, w_r)
        assert got_d.dtype == torch.int32 and got_c.dtype == torch.float32
        assert np.array_equal(got_d.numpy(), want_d)
        assert np.array_equal(got_c.numpy(), want_c)
    # block 0 sits in the constant region with lam = 0: every d ties
    got_d, _ = cuda_kernels.sad_local_argmin(
        T(blocks), T(ref_pad), T(y0s), T(x0s), T(centers),
        torch.tensor(0.0), S, w_r)
    assert int(got_d[0]) == 0


def test_a_crop_of_a_larger_plane_is_taken_as_it_is():
    """ref_pad may be a view whose rows are contiguous: the same answer
    as from its contiguous copy."""
    blocks, ref_pad, centers, bxy, lam = _inputs(16, "texture", seed=3)
    big = np.pad(ref_pad, 6, mode="edge").astype(np.int16)
    view = T(big)[6:-6, 6:-6]
    assert not view.is_contiguous()
    a = tme._local_search(T(blocks), view, T(centers), T(bxy),
                          torch.tensor(lam), 16, W_R, PAD)
    b = tme._local_search(T(blocks), T(ref_pad), T(centers), T(bxy),
                          torch.tensor(lam), 16, W_R, PAD)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_local_search_is_one_call_of_the_window_entry(monkeypatch):
    """_local_search hands origins, centres and lam to the window entry
    once, gathers nothing itself, and turns the index it gets back into
    centre + (dx - W_r, dy - W_r)."""
    blocks, ref_pad, centers, bxy, lam = _inputs(16, "texture", seed=5)
    N = len(blocks)
    n = 2 * W_R + 1
    want_d = (np.arange(N) * 37 % (n * n)).astype(np.int32)
    calls = []

    def entry(cur, ref, y0s, x0s, ctr, lam_t, S, w_r):
        calls.append((cur, ref, y0s, x0s, ctr, lam_t, S, w_r))
        return T(want_d), torch.arange(N, dtype=torch.float32)

    def no_gather(*a, **k):
        raise AssertionError("_local_search gathered patches")

    monkeypatch.setattr(tme, "sad_local_argmin", entry)
    for name in ("tile_gather", "tile_gather_plain", "tile_gather_planes",
                 "tile_gather_planes_plain"):
        monkeypatch.setattr(cuda_mc, name, no_gather)
    mv, cost = tme._local_search(T(blocks), T(ref_pad), T(centers), T(bxy),
                                 torch.tensor(lam), 16, W_R, PAD)
    assert len(calls) == 1
    cur, ref, y0s, x0s, ctr, lam_t, S, w_r = calls[0]
    assert (S, w_r) == (16, W_R)
    assert cur.dtype == torch.int32 and ref.dtype == torch.int16
    assert np.array_equal(y0s.numpy(),
                          bxy[:, 1] * 16 + centers[:, 1] + PAD - W_R)
    assert np.array_equal(x0s.numpy(),
                          bxy[:, 0] * 16 + centers[:, 0] + PAD - W_R)
    assert np.array_equal(ctr.numpy(), centers) and float(lam_t) == lam
    off = np.stack([want_d % n - W_R, want_d // n - W_R], axis=1)
    assert np.array_equal(mv.numpy(), centers + off)
    assert np.array_equal(cost.numpy(), np.arange(N, dtype=np.float32))
