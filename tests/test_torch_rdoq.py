"""The integer RDOQ of models/residual.py against the JAX package, exact:
rdoq_b on its own and inside tq_chain, at n = 4, 8, 16 and 32, luma and
chroma, intra and inter, with the static bin-count model and with the
estBit constants, psy-RDOQ off and on, every QP from 0 to 51 in one batch
(the QP is a per-TU tensor)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from x265_tpu.hevc import rate_model as jrm
from x265_tpu.models import residual as jres
from x265_tpu_torch.hevc import rate_model as trm
from x265_tpu_torch.models import residual as tres
import torch_port_util  # noqa: F401  (one torch thread)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _resi(rng, n, N):
    """Residual blocks from flat to strong, so that RDOQ both keeps and
    drops levels and zeroes whole coefficient groups."""
    amp = np.repeat([2, 6, 20, 60, 255], -(-N // 5))[:N]
    r = rng.integers(-255, 256, (N, n, n)) * amp[:, None, None] // 255
    r[:3] = 0
    r[3, 0, 0] = 9                                  # a lone DC
    return r.astype(np.int32)


def _consts(form, plane, slice_type=1, qp=30):
    """None (the static bin-count model) or the estBit row of a slice."""
    if form == "static":
        return None, None
    k = jrm.slice_rate_consts(slice_type, qp)
    assert np.array_equal(k, trm.slice_rate_consts(slice_type, qp))
    return k[plane], k[plane]


GRID = [(n, plane, is_intra, form, psy)
        for n in (4, 8, 16, 32)
        for plane in (0, 1)
        for is_intra in (False, True)
        for form in ("static", "estbit")
        for psy in ((0, 256) if plane == 0 else (0,))
        if not (plane == 1 and n == 32)]


@pytest.mark.parametrize("n,plane,is_intra,form,psy", GRID)
def test_rdoq_b_exact(n, plane, is_intra, form, psy):
    rng = np.random.default_rng(
        [n, plane, int(is_intra), form == "estbit", psy])
    N = 104
    resi = _resi(rng, n, N)
    qp = np.tile(np.arange(52, dtype=np.int32), 2)
    dst = is_intra and n == 4 and plane == 0
    cf = jres.fwd_transform_b(jnp.asarray(resi), n, dst, 8)
    lvl = jres.quantize_b(cf, jnp.asarray(qp), n, is_intra, 8)
    kj, kt = _consts(form, plane)
    want = jres.rdoq_b(cf, lvl, jnp.asarray(qp), n, 8, is_intra=is_intra,
                       consts=kj, psy_fx=psy)
    got = tres.rdoq_b(T(np.asarray(cf)), T(np.asarray(lvl)), T(qp), n, 8,
                      is_intra=is_intra, consts=kt, psy_fx=psy)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    # RDOQ did something: levels lowered, and some groups zeroed
    assert (np.abs(np.asarray(want)) < np.abs(np.asarray(lvl))).any()


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("form,psy", [("static", 0), ("estbit", 0),
                                      ("estbit", 192)])
@pytest.mark.parametrize("is_intra", [False, True])
def test_tq_chain_with_rdoq_exact(n, form, psy, is_intra):
    """RDOQ inside the whole chain, then SBH, dequant and the inverse:
    levels, recon residual and cbf."""
    rng = np.random.default_rng(n * 7 + psy + is_intra)
    N = 52
    resi = _resi(rng, n, N)
    qp = np.arange(52, dtype=np.int32)
    scan = rng.integers(0, 3, N).astype(np.int32)
    dst = is_intra and n == 4
    kj, kt = _consts(form, 0, slice_type=2 if is_intra else 0, qp=22)
    want = jres.tq_chain(jnp.asarray(resi), jnp.asarray(qp),
                         jnp.asarray(scan), n, dst, is_intra, 8, True,
                         True, False, consts=None if kj is None
                         else jnp.asarray(kj), psy_fx=psy)
    got = tres.tq_chain(T(resi), T(qp), T(scan), n, dst, is_intra, 8, True,
                        True, False, consts=None if kt is None else T(kt),
                        psy_fx=psy)
    for g, w, name in zip(got, want, ("levels", "rres", "cbf")):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    # RDOQ only ever lowers a level's magnitude (before SBH's nudge)
    plain = tres.tq_chain(T(resi), T(qp), T(scan), n, dst, is_intra, 8,
                          True, False, False)
    assert got[0].abs().sum() <= plain[0].abs().sum()
    if n >= 8:
        assert not torch.equal(plain[0], got[0])


def test_rdoq_scaling_lists_still_raise():
    """Scaling lists raised here until they were ported: rdoq_b with the
    default matrices now gives the JAX package's levels (the whole grid is
    in tests/test_torch_scaling.py)."""
    rng = np.random.default_rng(2)
    resi = _resi(rng, 8, 52)
    qp = np.arange(52, dtype=np.int32)
    cf = jres.fwd_transform_b(jnp.asarray(resi), 8, False, 8)
    lvl = jres.quantize_b(cf, jnp.asarray(qp), 8, False, 8, True)
    want = np.asarray(jres.rdoq_b(cf, lvl, jnp.asarray(qp), 8, 8, True))
    got = tres.rdoq_b(T(np.asarray(cf)), T(np.asarray(lvl)), T(qp), 8, 8,
                      scaling=True)
    assert np.array_equal(got.numpy(), want)
