"""The scaling-list branch of models/residual.py (--scaling-list default)
against the JAX package, exact: quantize_b's per-position coefficient
(quantScale*16 // m), the int64 m path of the dequant, dequantize_b,
rdoq_b with m, and tq_chain(scaling=True), at n = 4, 8, 16 and 32, intra
and inter, luma and chroma, bit depths 8 and 10, every QP' the encoder
passes (0-51, and 0-63 at 10 bits, where Qp' = QP + 12) in one batch,
RDOQ off and on.

The widening question: the JAX package's m path is int64 only inside an
enable_x64 trace. Every encoder call site of it opens one (tq_chain,
rdo, intra_rdo, inter_residual's build_inter_pre; the enable_x64(False)
blocks there wrap only the Pallas gathers), so the reference computes
int64, and so does the port. With the default matrices an int32 trace
would give the same values: test_dequant_widening_changes_nothing finds
the largest product |lvl| * scale * m << (per - shift) below 2^31 over
every QP', size, bit depth and matrix, and the int32 trace equal to the
int64 one at the extremes."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax import enable_x64

from x265_tpu.hevc import rate_model as jrm
from x265_tpu.models import residual as jres
from x265_tpu_torch.hevc.tables import default_scaling_matrix
from x265_tpu_torch.models import residual as tres
import torch_port_util  # noqa: F401  (one torch thread)


def T(a):
    return torch.from_numpy(np.array(a))


def _resi(rng, n, N, bd):
    """Residuals from flat to full range at the bit depth, so that RDOQ
    keeps and drops levels and whole coefficient groups go to zero."""
    top = (1 << bd) - 1
    amp = np.repeat([2, 6, 20, 60, top], -(-N // 5))[:N]
    r = rng.integers(-top, top + 1, (N, n, n)) * amp[:, None, None] // top
    r[:3] = 0
    r[3, 0, 0] = 9 << (bd - 8)
    return r.astype(np.int32)


def _qps(N, bd):
    """Every QP' of the bit depth (0-51, or 0-63 at 10 bits), repeated
    to N."""
    return np.resize(np.arange(52 + 6 * (bd - 8), dtype=np.int32), N)


GRID = [(n, is_intra, bd) for n in (4, 8, 16, 32)
        for is_intra in (False, True) for bd in (8, 10)]


@pytest.mark.parametrize("n,is_intra,bd", GRID)
def test_quant_dequant_with_m_exact(n, is_intra, bd):
    rng = np.random.default_rng([n, int(is_intra), bd])
    N = 104
    qp = _qps(N, bd)
    resi = _resi(rng, n, N, bd)
    dst = is_intra and n == 4
    cf = np.asarray(jres.fwd_transform_b(jnp.asarray(resi), n, dst, bd))
    want = np.asarray(jres.quantize_b(jnp.asarray(cf), jnp.asarray(qp), n,
                                      is_intra, bd, True))
    got = tres.quantize_b(T(cf), T(qp), n, is_intra, bd, True).numpy()
    assert np.array_equal(got, want)
    flat = tres.quantize_b(T(cf), T(qp), n, is_intra, bd).numpy()
    if n > 4:
        assert not np.array_equal(got, flat)    # the matrix changed levels
    lv = rng.integers(-32768, 32768, (N, n, n)).astype(np.int32)
    lv[:N // 2] //= 256                         # small levels as well
    with enable_x64():
        want = np.asarray(jres.dequantize_b(jnp.asarray(lv),
                                            jnp.asarray(qp), n, bd, True,
                                            is_intra))
    got = tres.dequantize_b(T(lv), T(qp), n, bd, True, is_intra)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


RDOQ_GRID = [(n, plane, is_intra, form, psy, bd)
             for n in (4, 8, 16, 32) for plane in (0, 1)
             for is_intra in (False, True)
             for form in ("static", "estbit")
             for psy in ((0, 256) if plane == 0 else (0,))
             for bd in (8, 10)
             if not (plane == 1 and n == 32)
             if not (form == "static" and psy)]


@pytest.mark.parametrize("n,plane,is_intra,form,psy,bd", RDOQ_GRID)
def test_rdoq_b_with_m_exact(n, plane, is_intra, form, psy, bd):
    rng = np.random.default_rng(
        [n, plane, int(is_intra), form == "estbit", psy, bd])
    N = 104
    resi = _resi(rng, n, N, bd)
    qp = _qps(N, bd)
    dst = is_intra and n == 4 and plane == 0
    cf = jres.fwd_transform_b(jnp.asarray(resi), n, dst, bd)
    lvl = jres.quantize_b(cf, jnp.asarray(qp), n, is_intra, bd, True)
    k = None if form == "static" else jrm.slice_rate_consts(1, 30)[plane]
    want = np.asarray(jres.rdoq_b(cf, lvl, jnp.asarray(qp), n, bd, True,
                                  is_intra, k, psy))
    got = tres.rdoq_b(T(np.asarray(cf)), T(np.asarray(lvl)), T(qp), n, bd,
                      True, is_intra, k, psy).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("is_intra,bd", [(False, 8), (True, 10),
                                         (False, 10)])
@pytest.mark.parametrize("rdoq", [False, True])
def test_tq_chain_scaling_exact(n, is_intra, bd, rdoq):
    rng = np.random.default_rng([n, int(is_intra), bd, int(rdoq)])
    N = 64
    resi = _resi(rng, n, N, bd)
    qp = _qps(N, bd)
    scan = rng.integers(0, 3, N).astype(np.int32)
    dst = is_intra and n == 4
    k = jrm.slice_rate_consts(2 if is_intra else 1, 32)[0] if rdoq else None
    want = jres.tq_chain(jnp.asarray(resi), jnp.asarray(qp),
                         jnp.asarray(scan), n, dst, is_intra, bd, True,
                         rdoq, False, True, None if k is None
                         else jnp.asarray(k), 256 if rdoq else 0)
    got = tres.tq_chain(T(resi), T(qp), T(scan), n, dst, is_intra, bd, True,
                        rdoq, False, True, None if k is None else T(k),
                        256 if rdoq else 0)
    for g, w, name in zip(got, want, ("levels", "rres", "cbf")):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32


@pytest.mark.parametrize("bd", [8, 10])
def test_dequant_widening_changes_nothing(bd):
    """The largest levels at every QP' and size, intra and inter: the
    port's int64 result equals the reference's enable_x64 trace and its
    int32 trace (the products stay below 2^31 with the default matrices,
    whose largest entry is 115), after the normative 16-bit clamp."""
    qps = np.arange(52 + 6 * (bd - 8), dtype=np.int32)
    worst = 0
    for n in (4, 8, 16, 32):
        log2 = n.bit_length() - 1
        for is_intra in (False, True):
            m = default_scaling_matrix(n, is_intra)
            N = len(qps)
            lv = np.full((2 * N, n, n), 32767, np.int32)
            lv[N:] = -32767
            qp = np.tile(qps, 2)
            got = tres.dequantize_b(T(lv), T(qp), n, bd, True,
                                    is_intra).numpy()
            with enable_x64():
                wide = np.asarray(jres.dequantize_b(
                    jnp.asarray(lv), jnp.asarray(qp), n, bd, True,
                    is_intra))
            narrow = np.asarray(jres.dequantize_b(
                jnp.asarray(lv), jnp.asarray(qp), n, bd, True, is_intra))
            assert np.array_equal(got, wide)
            assert np.array_equal(narrow, wide)
            scale = np.asarray([40, 45, 51, 57, 64, 72])[qps % 6]
            up = np.maximum(qps // 6 - (bd + log2 - 5), 0)
            worst = max(worst, int((32767 * scale * int(m.max())
                                    << up).max()))
    assert worst < (1 << 31)
