"""The slice-type search's pair axis and the SATD kernel's one-operand
entry, against the JAX package, on the CPU (the plain versions).

- ops.cuda_kernels.satd_intra (the lookahead's intra cost: int16 blocks
  against zero) == satd_plain(a, zeros) == the JAX satd8_batched(a, zeros)
  == the Pallas SATD in interpret mode, at 8 and 10 bits with the extreme
  samples;
- sad_sweep_argmin over a stack of P planes == P single calls;
- engine.lookahead.batched_pair_costs == the JAX batched_pair_costs,
  exactly, for windows of 1, 5, 16 and 17 pairs (the JAX package pads to a
  bucket of 16, then 32) with shared current planes and memo hits mixed
  in, on 8- and 10-bit lowres planes; one intra pass, one sweep pass;
- engine.me.tuple_satd with its K candidates in one SATD call == the JAX
  tuple_satd.
All integer: exact equality.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import x265_tpu.engine.lookahead as jla
import x265_tpu.engine.me as jme
from x265_tpu.ops import pallas_kernels as jpk

import x265_tpu_torch.engine.lookahead as tla
import x265_tpu_torch.engine.me as tme
from x265_tpu_torch.ops import cuda_kernels, cuda_mc
import torch_port_util  # noqa: F401  (one torch thread)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _extreme_blocks(rng, bd, n=61):
    """Random DC-removed blocks in [-(2^bd - 1), 2^bd - 1] and the blocks
    that reach the extremes: all +max, all -max, a checkerboard and row
    and column stripes of +-max (every Hadamard coefficient at its
    largest), one sample at +-max."""
    m = (1 << bd) - 1
    a = rng.integers(-m, m + 1, (n, 8, 8))
    yy, xx = np.mgrid[0:8, 0:8]
    ext = [np.full((8, 8), m), np.full((8, 8), -m),
           np.where((yy + xx) % 2, m, -m), np.where(yy % 2, m, -m),
           np.where(xx < 4, -m, m), np.zeros((8, 8), np.int64)]
    ext[-1][3, 5] = m
    ext.append(-ext[-1])
    return np.concatenate([a, np.stack(ext)]).astype(np.int16)


@pytest.mark.parametrize("bd", [8, 10])
def test_satd_intra_matches_jax(bd):
    a = _extreme_blocks(np.random.default_rng(bd), bd)
    z = np.zeros(a.shape, np.int32)
    a32 = a.astype(np.int32)
    want = np.asarray(jme.satd8_batched(jnp.asarray(a32), jnp.asarray(z)))
    pallas = np.asarray(jpk.satd_pallas(jnp.asarray(a32), jnp.asarray(z),
                                        interpret=True))
    assert np.array_equal(pallas, want)
    plain = cuda_kernels.satd_plain(T(a32), T(z))
    assert np.array_equal(plain.numpy(), want)
    assert np.array_equal(cuda_kernels.satd_intra_plain(T(a)).numpy(), want)
    got = cuda_kernels.satd_intra(T(a))            # CPU tensor -> plain
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert cuda_mc.launches["satd8x8_intra"] == 0  # no kernel on the CPU
    # the largest int16 inputs stay exact in the plain version's float32
    big = np.stack([np.full((8, 8), 32767), np.full((8, 8), -32768)])
    assert cuda_kernels.satd_intra(T(big.astype(np.int16))).tolist() == [
        16 * 32767, 16 * 32768]


def test_satd_intra_refuses_what_the_kernel_does_not_take():
    a = torch.zeros((3, 8, 8), dtype=torch.int16)
    with pytest.raises(TypeError):
        cuda_kernels.satd_intra(a.to(torch.int32))
    with pytest.raises(ValueError):
        cuda_kernels.satd_intra(torch.zeros((3, 16, 16), dtype=torch.int16))
    with pytest.raises(ValueError):
        cuda_kernels.satd_intra(a.transpose(1, 2))


@pytest.mark.parametrize("S,R,P,maxv", [(8, 8, 5, 255), (8, 4, 3, 1023),
                                        (16, 3, 2, 255), (8, 8, 1, 255)])
def test_batched_sweep_argmin_equals_single_calls(S, R, P, maxv):
    rng = np.random.default_rng(S + R + P)
    h, w = 32, 48
    ref = rng.integers(0, maxv + 1, (P, h + 2 * R, w + 2 * R))
    cur = np.clip(ref[:, R + 1:R + 1 + h, R - 2:R - 2 + w]
                  + rng.integers(-2, 3, (P, h, w)), 0, maxv)
    cur, ref = T(cur.astype(np.int16)), T(ref.astype(np.int16))
    n = 2 * R + 1
    mvc = T((rng.integers(0, 30, n * n) * 0.7).astype(np.float32))
    idx, cost = cuda_kernels.sad_sweep_argmin(cur, ref, mvc, S, R)
    assert idx.shape == cost.shape == (P, h // S, w // S)
    assert idx.dtype == torch.int32 and cost.dtype == torch.float32
    for p in range(P):
        wi, wc = cuda_kernels.sad_sweep_argmin_plain(cur[p], ref[p], mvc,
                                                     S, R)
        assert torch.equal(idx[p], wi) and torch.equal(cost[p], wc)
    with pytest.raises(ValueError):
        cuda_kernels.sad_sweep_argmin(cur, ref[:, :-1], mvc, S, R)
    with pytest.raises(ValueError):
        cuda_kernels.sad_sweep_argmin(cur, ref[0], mvc, S, R)


def _planes(bd, n=7, h=32, w=48, seed=0):
    """Lowres planes of a pan with noise and a cut (plane 4 on), samples
    at both ends of the range: what the lookahead keeps per frame."""
    rng = np.random.default_rng(seed + bd)
    m = (1 << bd) - 1
    a = rng.integers(0, m + 1, (h, w + 4 * n))
    b = rng.integers(0, m + 1, (h, w))
    out = []
    for i in range(n):
        p = a[:, 3 * i:3 * i + w] if i < 4 else np.roll(b, 2 * i, 0)
        p = np.clip(p + rng.integers(-3, 4, (h, w)), 0, m)
        p[0, :4] = m
        p[1, :4] = 0
        out.append(p.astype(np.int32))
    return out


def _window(lows, P):
    """P distinct (cur, ref) pairs in slicetype_split's order (forward
    pairs, then backward): several pairs share each current plane."""
    pairs = [(c, r) for r in range(len(lows)) for c in range(r + 1,
                                                            len(lows))]
    pairs += [(c, r) for r in range(len(lows)) for c in range(r)]
    return [(lows[c], lows[r]) for c, r in pairs[:P]]


def _spy(monkeypatch):
    calls = {"fn": [], "satd_intra": 0, "sad_sweep_argmin": 0}
    fn, intra, sweep = (tla._batched_pair_fn, tla.satd_intra,
                        tla.sad_sweep_argmin)

    def fn_spy(curs, refs, cur_of):
        calls["fn"].append((curs.shape[0], refs.shape[0]))
        return fn(curs, refs, cur_of)

    def intra_spy(*a):
        calls["satd_intra"] += 1
        return intra(*a)

    def sweep_spy(*a):
        calls["sad_sweep_argmin"] += 1
        return sweep(*a)
    monkeypatch.setattr(tla, "_batched_pair_fn", fn_spy)
    monkeypatch.setattr(tla, "satd_intra", intra_spy)
    monkeypatch.setattr(tla, "sad_sweep_argmin", sweep_spy)
    return calls


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("P", [1, 5, 16, 17])
def test_batched_pair_costs_matches_jax(P, bd, monkeypatch):
    lows = _planes(bd, seed=P)
    pairs = _window(lows, P)
    calls = _spy(monkeypatch)
    # the JAX package costs the whole window at once (17 pairs: a bucket
    # of 32); the port first a window of every other pair, which fills
    # its memo
    want = jla.batched_pair_costs(pairs)
    first = pairs[::2]
    got0 = tla.batched_pair_costs(first, device="cpu")
    for g, w in zip(got0, want[::2]):
        w = np.asarray(w)
        assert g.dtype == w.dtype == np.int32 and np.array_equal(g, w)
    got = tla.batched_pair_costs(pairs, device="cpu")
    for g, w in zip(got, want):
        assert g.shape == (4, 6) and np.array_equal(g, np.asarray(w))
    # memo hits are the very arrays of the first call
    assert all(got[2 * k] is got0[k] for k in range(len(first)))
    # one pass a call with new pairs: the new pairs only, each distinct
    # current plane once, one intra and one sweep launch
    new = pairs[1::2]
    passes = [(len({id(c) for c, _ in first}), len(first))]
    if new:
        passes.append((len({id(c) for c, _ in new}), len(new)))
    assert calls["fn"] == passes
    assert calls["satd_intra"] == calls["sad_sweep_argmin"] == len(passes)
    # a window served wholly by the memo costs nothing
    again = tla.batched_pair_costs(pairs, device="cpu")
    assert all(a is b for a, b in zip(again, got))
    assert len(calls["fn"]) == len(passes)


def test_pairs_sharing_cur_keep_their_own_inter_costs():
    """Three pairs with one current plane and three references: one intra
    cost, three sweeps, each pair its own map (== the JAX package's)."""
    lows = _planes(8, n=4, seed=40)
    pairs = [(lows[3], lows[0]), (lows[3], lows[1]), (lows[3], lows[2])]
    got = tla.batched_pair_costs(pairs, device="cpu")
    want = jla.batched_pair_costs(pairs)
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(w))
    assert not np.array_equal(got[0], got[2])


def test_slicetype_split_over_the_pair_axis():
    """The decision that consumes the pair axis, on a 10-bit window of
    seven pictures (30 pairs in one pass): the JAX package's anchor."""
    lows = _planes(10, seed=7)
    want = jla.slicetype_split(lows[0], lows[1:], max_bs=4, b_discount=0.9)
    got = tla.slicetype_split(lows[0], lows[1:], max_bs=4, b_discount=0.9,
                              device="cpu")
    assert got == want


@pytest.mark.parametrize("K", [1, 4])
def test_tuple_satd_stacked_matches_jax(K, monkeypatch):
    """All three directions (L0, L1, bi) among the candidates; the K
    candidates' SATD is one call of the kernel's wrapper."""
    rng = np.random.default_rng(K)
    h, w = 48, 64
    big = rng.integers(0, 256, (h + 32, w + 32)).astype(np.float32)
    for _ in range(2):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) / 3
    cur = big[8:8 + h, 8:8 + w].astype(np.uint8)
    ref0 = big[9:9 + h, 6:6 + w].astype(np.int32)
    ref1 = big[7:7 + h, 10:10 + w].astype(np.int32)
    cands = [(3, 0, 0, (5, -3), (-7, 2)), (1, 0, 0, (12, 8), (0, 0)),
             (2, 0, 0, (0, 0), (-9, 4)), (1, 0, 0, (0, 0), (0, 0))][:K]
    n = {"satd": 0}
    kern = tme._satd_kernel

    def satd_spy(a, b):
        n["satd"] += 1
        return kern(a, b)
    monkeypatch.setattr(tme, "_satd_kernel", satd_spy)
    want = jme.tuple_satd(cur, [ref0], [ref1], cands, w, h, R=8)
    got = tme.tuple_satd(cur, [ref0], [ref1], cands, w, h, R=8,
                         device="cpu")
    assert got.shape == want.shape == (K, h // 16, w // 16)
    assert np.array_equal(got, want)
    assert n["satd"] == 1
