"""The port's assertion mode (X265TPU_CHECKIFY=1, utils/checks.py) against
tests/test_checkify.py's three tests of the JAX package's: a clean input
gives the unchecked chain's outputs (and the JAX tq_chain's), a bad QP
raises with the JAX package's message, the environment gate works; with
a 10-bit case, the other three invariants, and tq_chain's own gate."""
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one torch thread)
from x265_tpu_torch.models.residual import tq_chain as t_tq
from x265_tpu_torch.utils import checks


def _T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("bd,qp,rdoq", [(8, 30, False), (10, 40, False),
                                        (10, 12, True)])
def test_checked_tq_chain_clean_matches_unchecked(bd, qp, rdoq):
    import jax.numpy as jnp
    from x265_tpu.models.residual import tq_chain as j_tq
    rng = np.random.default_rng(3 + bd)
    lim = 200 << (bd - 8)
    resi = rng.integers(-lim, lim + 1, (8, 16, 16)).astype(np.int32)
    qps = np.full((8,), qp, np.int32)
    sel = np.zeros((8,), np.int32)
    args = (16, False, False, bd, True, rdoq, False)
    a = t_tq(_T(resi), _T(qps), _T(sel), *args)
    b = checks.checked_tq_chain(_T(resi), _T(qps), _T(sel), *args)
    c = j_tq(jnp.asarray(resi), jnp.asarray(qps), jnp.asarray(sel), *args)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y)
        assert np.array_equal(x.numpy(), np.asarray(z))


@pytest.mark.parametrize("bd,bad_qp", [(8, 99), (8, 52), (10, 64),
                                       (10, -1)])
def test_checked_tq_chain_raises_on_bad_qp(bd, bad_qp):
    resi = torch.zeros((4, 16, 16), dtype=torch.int32)
    qp = torch.full((4,), bad_qp, dtype=torch.int32)
    sel = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(checks.CheckError, match="QP out of range"):
        checks.checked_tq_chain(resi, qp, sel, 16, False, False, bd, True,
                                False, False)


def test_checked_tq_chain_other_invariants():
    """The residual bound is checked (before the chain's own bounds): a
    residual of 256 at 8 bits raises, the largest 10-bit one does not."""
    qp = torch.zeros((2,), dtype=torch.int32)
    sel = torch.zeros((2,), dtype=torch.int32)
    resi = torch.zeros((2, 8, 8), dtype=torch.int32)
    resi[1, 0, 0] = 256
    with pytest.raises(checks.CheckError, match="bit-depth dynamic range"):
        checks.checked_tq_chain(resi, qp, sel, 8, False, False, 8, False,
                                False, False)
    big = torch.full((1, 4, 4), 1023, dtype=torch.int32)
    out = checks.checked_tq_chain(big, qp[:1], sel[:1], 4, False, False,
                                  10, False, False, True)
    assert torch.equal(out[0], big)      # lossless passes it through


def test_checkify_env_gate(monkeypatch):
    monkeypatch.delenv("X265TPU_CHECKIFY", raising=False)
    assert not checks.enabled()
    monkeypatch.setenv("X265TPU_CHECKIFY", "1")
    assert checks.enabled()
    monkeypatch.setenv("X265TPU_CHECKIFY", "0")
    assert not checks.enabled()


def test_tq_chain_gate(monkeypatch):
    """tq_chain takes the checked chain only under X265TPU_CHECKIFY=1:
    off, a bad QP runs unchecked (on the CPU) and nothing is raised."""
    resi = torch.zeros((2, 8, 8), dtype=torch.int32)
    qp = torch.full((2,), 60, dtype=torch.int32)
    sel = torch.zeros((2,), dtype=torch.int32)
    monkeypatch.delenv("X265TPU_CHECKIFY", raising=False)
    t_tq(resi, qp, sel, 8, False, False, 8, True, False, False)
    monkeypatch.setenv("X265TPU_CHECKIFY", "1")
    with pytest.raises(checks.CheckError, match="QP out of range"):
        t_tq(resi, qp, sel, 8, False, False, 8, True, False, False)


def test_checked_encode_equals_unchecked(monkeypatch):
    """An encode under X265TPU_CHECKIFY=1 gives the same bytes."""
    from torch_port_util import slice_params
    from x265_tpu_torch.api.encoder import Encoder
    from x265_tpu_torch.utils.testclip import make_clip
    frames = make_clip(64, 64, 3, seed=8)
    streams = []
    for on in ("0", "1"):
        monkeypatch.setenv("X265TPU_CHECKIFY", on)
        streams.append(Encoder(slice_params("x265_tpu_torch", 64, 64),
                               device="cpu").encode(frames))
    assert streams[0] == streams[1]
