"""models/intra_frame.py of the port against the JAX package.

The analysis is fp32 on both sides, summed in different orders, so the
costs are compared to 1e-4 relative and a mode may flip only between two
candidates whose costs tie to that tolerance. On these inputs no mode
flips at all, which the test asserts (flip rate 0)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from x265_tpu.models import intra_frame as jif
from x265_tpu_torch.models import intra_frame as tif
from torch_port_util import make_clip


def _frame(seed, w=192, h=128):
    rng = np.random.default_rng(seed)
    y = make_clip(w, h, 1, seed)[0][0].astype(np.int32)
    y[: h // 2] = np.clip(y[: h // 2] + rng.integers(-20, 21, (h // 2, w)),
                          0, 255)
    return y.astype(np.uint8)


@pytest.mark.parametrize("S,fast,psy", [(16, True, 2.0), (16, False, 0.0),
                                        (8, True, 0.0), (32, False, 2.0),
                                        (16, False, 2.0)])
def test_frame_intra_analysis(S, fast, psy):
    y = _frame(S)
    mj, cj = jif.frame_intra_analysis(jnp.asarray(y), S=S, fast=fast,
                                      psy=psy)
    mt, ct = tif.frame_intra_analysis(torch.from_numpy(y), S=S, fast=fast,
                                      psy=psy)
    mj, cj = np.asarray(mj), np.asarray(cj)
    assert mt.dtype == torch.int32 and ct.dtype == torch.float32
    np.testing.assert_allclose(ct.numpy(), cj, rtol=1e-4)
    flips = int((mt.numpy() != mj).sum())
    assert flips == 0, f"{flips} of {mj.size} modes flipped"


def test_extract_block_refs_exact():
    y = _frame(3).astype(np.float32)
    want = np.asarray(jif.extract_block_refs(jnp.asarray(y), 16))
    got = tif.extract_block_refs(torch.from_numpy(y), 16).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("w,h", [(192, 128), (200, 120)])
def test_decide_intra_frame_with_cost(w, h):
    y = _frame(9, w, h)
    dj, ij = jif.decide_intra_frame_tpu_with_cost(y, w, h, cu_log2=4,
                                                  fast=True, psy=2.0)
    dt, it = tif.decide_intra_frame_tpu_with_cost(y, w, h, cu_log2=4,
                                                  fast=True, psy=2.0,
                                                  device="cpu")
    assert np.array_equal(dt.cu_log2_map, dj.cu_log2_map)
    assert np.array_equal(dt.luma_mode8, dj.luma_mode8)
    assert dt.luma_mode8.dtype == dj.luma_mode8.dtype
    np.testing.assert_allclose(it, ij, rtol=1e-4)
    d2 = tif.decide_intra_frame_tpu(y, w, h, cu_log2=4, fast=True, psy=2.0,
                                    device="cpu")
    assert np.array_equal(d2.luma_mode8, dj.luma_mode8)


def test_first_argmin_keeps_first_on_ties():
    x = torch.tensor([[3., 1., 1., 2.], [0., 0., 0., 0.], [5., 4., 3., 3.]])
    assert tif.first_argmin(x, 1).tolist() == [1, 0, 2]
    assert tif.first_argmin(x.t().contiguous(), 0).tolist() == [1, 0, 2]
