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
    cur = T(rng.integers(0, 256, (37, 16, 16)).astype(np.int32)).to(dev)
    fa = (plane, r, oy, ox, cur, 16)
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
    for k in before:
        assert cuda_mc.launches[k] == before[k] + 1
