"""The port's lookahead (engine/lookahead.py) against the JAX package's on
the same numpy inputs: the lowres downscale, the per-block intra cost
(the SATD kernel's plain version here), inter cost and mv (the fused SAD
sweep's plain version, S=8, no mv cost) at R=4 and R=8, the per-frame
costs over a clip with a scene cut, and the cuTree propagation (host
numpy in both). Everything is integer or the same float64 host code:
exact equality."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from x265_tpu.engine import lookahead as jla
from x265_tpu_torch.engine import lookahead as tla
from x265_tpu_torch.utils.testclip import make_cut_clip
import torch_port_util  # noqa: F401  (one torch thread)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("h,w", [(128, 192), (120, 200), (72, 40)])
def test_lowres_downscale(h, w):
    y = np.random.default_rng(h + w).integers(0, 256, (h, w)).astype(np.uint8)
    want = np.asarray(jla.lowres_downscale(jnp.asarray(y)))
    got = tla.lowres_downscale(T(y)).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)


def _low_pair(seed, H, W, flat=False):
    rng = np.random.default_rng(seed)
    if flat:
        return np.full((H, W), 90, np.int32), np.full((H, W), 90, np.int32)
    big = rng.integers(0, 256, (H + 8, W + 8))
    for _ in range(2):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) // 3
    prev = big[4:4 + H, 4:4 + W].astype(np.int32)
    cur = np.clip(big[6:6 + H, 1:1 + W] + rng.integers(-3, 4, (H, W)),
                  0, 255).astype(np.int32)
    return cur, prev


@pytest.mark.parametrize("R", [4, 8])
@pytest.mark.parametrize("H,W,flat", [(64, 96, False), (56, 104, False),
                                      (40, 48, True)])
def test_lowres_costs_body(R, H, W, flat):
    """H = 56 and 40 are multiples of 8 but not of 16; flat content puts
    every displacement at the same cost, where d = 0 must win."""
    cur, prev = _low_pair(R * 100 + H, H, W, flat)
    ji, jm, jmv = (np.asarray(a) for a in
                   jla._lowres_costs(jnp.asarray(cur), jnp.asarray(prev), R))
    ti, tm, tmv = (a.numpy() for a in
                   tla._lowres_costs(T(cur), T(prev), R))
    assert np.array_equal(ti, ji)
    assert np.array_equal(tm, jm)
    assert np.array_equal(tmv, jmv)
    if flat:
        assert (tmv == -R).all()      # d = 0 is the corner (-R, -R)
    else:
        assert (tmv != tmv[0, 0]).any() or (tm > 0).any()


def test_frame_costs_over_a_cut():
    """The per-frame (cost, intra, inter) and the per-block records of a
    clip whose scene changes at frame 3; the height is no multiple of 16,
    so the lowres plane is edge-padded."""
    w, h = 160, 104
    frames = make_cut_clip(w, h, 5, seed=4, cut=3)
    jl = jla.Lookahead(w, h)
    tl = tla.Lookahead(w, h, device="cpu")
    ratios = []
    for i, (y, _cb, _cr) in enumerate(frames):
        want = jl.frame_costs(y, i == 0)
        got = tl.frame_costs(y, i == 0)
        assert got == want
        for k in ("icost", "mcost", "mv"):
            assert np.array_equal(tl.last_blocks[k], jl.last_blocks[k])
        assert np.array_equal(tl.last_low.numpy(), np.asarray(jl.last_low))
        ratios.append(want[2] / want[1])
    # the cut is where the inter cost reaches the intra cost
    assert ratios[3] > 0.9 and max(ratios[1:3] + ratios[4:]) < 0.9


@pytest.mark.parametrize("n,ctb_log2,qc", [(1, 6, 0.6), (4, 6, 0.6),
                                           (6, 5, 0.7)])
def test_cutree_propagate(n, ctb_log2, qc):
    rng = np.random.default_rng(n * 10 + ctb_log2)
    shape = (9, 13)
    recs = [{"icost": rng.integers(0, 4000, shape).astype(np.int32),
             "mcost": rng.integers(0, 9000, shape).astype(np.int32),
             "mv": rng.integers(-20, 21, shape + (2,)).astype(np.int32)}
            for _ in range(n)]
    want = jla.cutree_propagate(recs, ctb_log2, qc)
    got = tla.cutree_propagate(recs, ctb_log2, qc)
    assert np.array_equal(got, want)
    assert tla.cutree_propagate([], ctb_log2) is None
