"""models/residual.py of the port against the JAX package: the whole
transform/quant/SBH/dequant/inverse chain, exact."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from x265_tpu.models import residual as jres
from x265_tpu_torch.models import residual as tres
import torch_port_util  # noqa: F401  (one torch thread)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("is_intra", [False, True])
@pytest.mark.parametrize("sdh", [False, True])
def test_tq_chain_exact(n, is_intra, sdh):
    rng = np.random.default_rng(n * 4 + is_intra * 2 + sdh)
    N = 40
    resi = rng.integers(-255, 256, (N, n, n)).astype(np.int32)
    resi[:5] = rng.integers(-3, 4, (5, n, n))          # near-zero blocks
    resi[5] = 0
    qp = rng.integers(0, 52, N).astype(np.int32)
    scan = rng.integers(0, 3, N).astype(np.int32)
    dst = is_intra and n == 4
    want = jres.tq_chain(jnp.asarray(resi), jnp.asarray(qp),
                         jnp.asarray(scan), n, dst, is_intra, 8, sdh,
                         False, False)
    got = tres.tq_chain(T(resi), T(qp), T(scan), n, dst, is_intra, 8, sdh,
                        False, False)
    for g, w, name in zip(got, want, ("levels", "rres", "cbf")):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_transform_stages_exact(n):
    rng = np.random.default_rng(n)
    x = rng.integers(-255, 256, (25, n, n)).astype(np.int32)
    cf_j = jres.fwd_transform_b(jnp.asarray(x), n, False, 8)
    cf_t = tres.fwd_transform_b(T(x), n, False, 8)
    assert np.array_equal(cf_t.numpy(), np.asarray(cf_j))
    big = rng.integers(-32768, 32768, (25, n, n)).astype(np.int32)
    assert np.array_equal(
        tres.inv_transform_b(T(big), n, False, 8).numpy(),
        np.asarray(jres.inv_transform_b(jnp.asarray(big), n, False, 8)))
    qp = rng.integers(0, 52, 25).astype(np.int32)
    lv = rng.integers(-2000, 2000, (25, n, n)).astype(np.int32)
    assert np.array_equal(
        tres.dequantize_b(T(lv), T(qp), n, 8).numpy(),
        np.asarray(jres.dequantize_b(jnp.asarray(lv), jnp.asarray(qp), n, 8)))


def test_unported_branches_raise():
    """No branch of the chain is refused any more: scaling lists (the last
    one, tests/test_torch_scaling.py) run with and without RDOQ and give
    the JAX package's levels, recon residuals and cbf."""
    rng = np.random.default_rng(1)
    z = rng.integers(-60, 61, (3, 8, 8)).astype(np.int32)
    q = np.array([22, 30, 37], np.int32)
    for rdoq in (True, False):
        got = tres.tq_chain(T(z), T(q), T(np.zeros(3, np.int32)), 8, False,
                            False, 8, False, rdoq, False, scaling=True)
        want = jres.tq_chain(jnp.asarray(z), jnp.asarray(q),
                             jnp.zeros(3, jnp.int32), 8, False, False, 8,
                             False, rdoq, False, scaling=True)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
