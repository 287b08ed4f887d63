"""The dense SAD sweep of the port (ops/cuda_kernels.py: the plain
versions, which a CPU tensor gets) against the JAX package: the field
against sad_sweep_pallas in interpret mode, the fused argmin against
engine.me._int_stage. Integer SADs and one fp32 add: exact equality,
ties included. The CUDA kernel itself is held against the same plain
versions on the card (tests/test_torch_gpu.py, chip_smoke.py)."""
import functools

import jax
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from x265_tpu.engine import me as jme
from x265_tpu.ops import pallas_kernels as jpk
from x265_tpu_torch.engine import me as tme
from x265_tpu_torch.ops import cuda_kernels, cuda_mc
import torch_port_util  # noqa: F401  (one torch thread)


def T(a, dt=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dt is None else t.to(dt)


@functools.lru_cache(maxsize=None)
def _int_stage_jit(S, R):
    """The reference's scan, compiled once per (S, R) for all contents
    (inside the JAX package it is always traced under a jit as well)."""
    return jax.jit(functools.partial(jme._int_stage, S=S, R=R))


def _planes(seed, H, W, R, flat=False):
    rng = np.random.default_rng(seed)
    if flat:
        return (np.full((H, W), 77, np.int32),
                np.full((H + 2 * R, W + 2 * R), 77, np.int32))
    big = rng.integers(0, 256, (H + 2 * R, W + 2 * R)).astype(np.int32)
    cur = np.clip(big[R + 1:R + 1 + H, R - 2:R - 2 + W]
                  + rng.integers(-2, 3, (H, W)), 0, 255).astype(np.int32)
    return cur, big


def _mvcost(R, lam):
    dys, dxs = np.mgrid[-R:R + 1, -R:R + 1]
    return (np.float32(lam) * (jme._mv_bits(4 * dxs.ravel())
                               + jme._mv_bits(4 * dys.ravel()))
            ).astype(np.float32)


@pytest.mark.parametrize("H,W,R,S", [(32, 48, 3, 16), (32, 48, 3, 8),
                                     (16, 16, 5, 16)])
def test_sad_sweep_field_matches_pallas_interpret(H, W, R, S):
    cur, refp = _planes(4, H, W, R)
    want = np.asarray(jpk.sad_sweep_pallas(
        jnp.asarray(cur), jnp.asarray(refp), S, R, interpret=True))
    got = cuda_kernels.sad_sweep(T(cur, torch.int16), T(refp, torch.int16),
                                 S, R)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    assert cuda_mc.launches["sad_sweep"] == 0      # no kernel on the CPU


@pytest.mark.parametrize("S", [8, 16])
@pytest.mark.parametrize("R", [3, 16, 29])
@pytest.mark.parametrize("case", ["texture", "flat", "zero_mvcost"])
def test_sad_sweep_argmin_matches_int_stage(S, R, case):
    H, W = 4 * S, 6 * S
    cur, refp = _planes(S + R, H, W, R, flat=(case == "flat"))
    mvc = _mvcost(R, 2.83)
    if case == "zero_mvcost":
        # many equal SADs (a constant reference), no mv cost: d = 0 wins
        refp[:] = 9
        mvc[:] = 0
    want = np.asarray(_int_stage_jit(S, R)(
        jnp.asarray(cur), jnp.asarray(refp), jnp.asarray(mvc)))
    idx, cost = cuda_kernels.sad_sweep_argmin(
        T(cur, torch.int16), T(refp, torch.int16), T(mvc), S, R)
    n = 2 * R + 1
    got = np.stack([idx.numpy() % n - R, idx.numpy() // n - R], axis=-1)
    assert idx.dtype == torch.int32 and cost.dtype == torch.float32
    assert np.array_equal(got, want)
    mv = tme._int_stage(T(cur), T(refp), T(mvc), S, R)
    assert mv.dtype == torch.int32
    assert np.array_equal(mv.numpy(), want)
    # the cost is that of the winner, taken from the field
    field = cuda_kernels.sad_sweep_plain(T(cur, torch.int16),
                                         T(refp, torch.int16), S, R)
    tot = field + T(mvc)[:, None, None]
    assert torch.equal(cost, tot.amin(dim=0))
    assert torch.equal(idx.long(), (tot == cost[None]).to(torch.int8)
                       .argmax(dim=0))
    if case == "zero_mvcost":
        assert not idx.any()
    if case == "flat":
        assert (idx == (n * n) // 2).all()         # the zero vector
    assert cuda_mc.launches["sad_sweep_argmin"] == 0


def test_sad_sweep_wrappers_reject_bad_arguments():
    cur = torch.zeros((32, 32), dtype=torch.int16)
    ref = torch.zeros((38, 38), dtype=torch.int16)
    mvc = torch.zeros(49, dtype=torch.float32)
    with pytest.raises(TypeError):
        cuda_kernels.sad_sweep(cur.to(torch.int32), ref, 16, 3)
    with pytest.raises(ValueError):
        cuda_kernels.sad_sweep(cur, ref, 16, 4)          # ref_pad shape
    with pytest.raises(ValueError):
        cuda_kernels.sad_sweep(cur, ref, 12, 3)          # S
    with pytest.raises(ValueError):
        cuda_kernels.sad_sweep(ref[:32, :32], ref, 16, 3)    # strided
    with pytest.raises(ValueError):
        cuda_kernels.sad_sweep_argmin(cur, ref, mvc[:48], 16, 3)
    with pytest.raises(TypeError):
        cuda_kernels.sad_sweep_argmin(cur, ref, mvc.double(), 16, 3)
    big = torch.zeros((32 + 160, 32 + 160), dtype=torch.int16)
    with pytest.raises(ValueError):                      # window > 48 KB
        cuda_kernels.sad_sweep(cur, big, 32, 80)
