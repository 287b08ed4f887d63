"""The fused gather + SATD entry of the port (what a CPU tensor gets: its
plain version) against the JAX package's subpel search, and against the
two plain steps it fuses. All integer, and costs built from them: exact
equality.

The CUDA kernel itself has no interpret mode; tests/test_torch_gpu.py
(marked `gpu`) and chip_smoke.py hold it against the same plain version on
the card.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import x265_tpu.engine.me as jme
import x265_tpu_torch.engine.me as tme
from x265_tpu_torch.ops import cuda_kernels, cuda_mc
import torch_port_util  # noqa: F401  (one torch thread)

S, MARGIN = 16, 6
NBY, NBX = 4, 6


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _frame(seed):
    """Phase planes of a small padded picture, its current blocks, block
    coordinates and quarter-pel MVs. Some MVs point far beyond the right
    and bottom edges, where both sides clamp the window to dim - S;
    none below -MARGIN pels (a negative origin wraps in the jnp twin and
    is never produced by the encoder)."""
    rng = np.random.default_rng(seed)
    Hm, Wm = NBY * S + 2 * MARGIN, NBX * S + 2 * MARGIN
    planes = rng.integers(0, 256, (4, 4, Hm, Wm)).astype(np.int16)
    N = NBY * NBX
    cur = rng.integers(0, 256, (N, S, S)).astype(np.int32)
    bx, by = np.meshgrid(np.arange(NBX), np.arange(NBY))
    bxy = np.stack([bx.ravel(), by.ravel()], axis=1).astype(np.int32)
    mv = rng.integers(-4 * (MARGIN - 1), 4 * (MARGIN - 1), (N, 2)).astype(
        np.int32)
    mv[-1] = (4 * 40 + 1, 4 * 50 + 3)          # far outside: clamped
    mv[-2] = (4 * 30 + 2, 3)                   # over the right edge only
    mv[-7] = (1, 4 * 30 + 1)                   # over the bottom edge only
    mv[0] = (-4 * MARGIN, -4 * MARGIN)         # origin exactly 0
    return planes, cur, bxy, mv


def test_eval_fixed_matches_jax():
    planes, cur, bxy, mv = _frame(0)
    want = np.asarray(jme._eval_fixed(
        jnp.asarray(cur), jnp.asarray(planes), jnp.asarray(mv),
        jnp.asarray(bxy), S, MARGIN))
    got = tme._eval_fixed(T(cur), T(planes), T(mv), T(bxy), S, MARGIN)
    assert got.dtype == torch.int32 and got.shape == (NBY * NBX,)
    assert np.array_equal(got.numpy(), want)
    assert cuda_mc.launches["tile_gather_planes_satd"] == 0   # CPU: plain


@pytest.mark.parametrize("offs", ["half", "quarter"])
def test_refine_round_matches_jax(offs):
    """One round of _refine: the same winner and, to the last bit, the
    same fp32 cost. lam = 2.5 keeps lam * bits exact in fp32, so the
    equality does not hang on whether a compiler contracts the multiply
    and the add."""
    planes, cur, bxy, mv = _frame(1)
    mv[0] += 2               # the candidates at -2 still start at origin 0
    offsets = jme._HALF_OFFS if offs == "half" else jme._QUARTER_OFFS
    assert np.array_equal(offsets, getattr(tme, "_HALF_OFFS" if offs == "half"
                                           else "_QUARTER_OFFS"))
    mvp = np.roll(mv, 1, axis=0)
    lam = np.float32(2.5)
    mv_q = np.concatenate([mv, bxy], axis=1)
    want_mv, want_cost = jme._refine(
        jnp.asarray(cur), jnp.asarray(planes), jnp.asarray(mv_q),
        jnp.asarray(offsets), lam, jnp.asarray(mvp), S, MARGIN)
    got_mv, got_cost = tme._refine(
        T(cur), T(planes), T(mv_q), T(offsets), torch.tensor(lam), T(mvp),
        S, MARGIN)
    assert np.array_equal(got_mv.numpy(), np.asarray(want_mv))
    assert got_cost.dtype == torch.float32
    assert np.array_equal(got_cost.numpy(), np.asarray(want_cost))


@pytest.mark.parametrize("K", [1, 9])
@pytest.mark.parametrize("n", [8, 16, 32])
def test_fused_plain_is_gather_then_satd(K, n):
    rng = np.random.default_rng(10 * n + K)
    P, Hp, Wp, N = 5, 70, 83, 13
    planes = T(rng.integers(0, 1024, (P, Hp, Wp)).astype(np.int16))
    cur = T(rng.integers(0, 1024, (N, n, n)).astype(np.int32))
    L = K * N
    ridx = rng.integers(-2, P + 2, L).astype(np.int32)
    oy = rng.integers(-20, Hp + 20, L).astype(np.int32)
    ox = rng.integers(-20, Wp + 20, L).astype(np.int32)
    oy[:3] = (1 << 20, -(1 << 20), Hp - n)
    ox[:3] = (-(1 << 20), 1 << 20, Wp - n)
    ridx, oy, ox = T(ridx), T(oy), T(ox)
    got = cuda_mc.tile_gather_planes_satd(planes, ridx, oy, ox, cur, n)
    pred = cuda_mc.tile_gather_planes_plain(planes, ridx, oy, ox, n)
    want = cuda_kernels.satd_plain(cur.repeat(K, 1, 1), pred)
    assert got.dtype == torch.int32 and got.shape == (L,)
    assert torch.equal(got, want)
    # lane k*N + i is scored against block i, and a block against its own
    # window scores 0
    own = cuda_mc.tile_gather_planes_satd(planes, ridx[:N], oy[:N], ox[:N],
                                          pred[:N], n)
    assert int(own.abs().max()) == 0


def test_fused_entry_takes_no_lanes():
    planes = torch.zeros((2, 40, 40), dtype=torch.int16)
    e = torch.zeros(0, dtype=torch.int32)
    cur = torch.zeros((0, 16, 16), dtype=torch.int32)
    out = cuda_mc.tile_gather_planes_satd(planes, e, e, e, cur, 16)
    assert out.shape == (0,) and out.dtype == torch.int32
