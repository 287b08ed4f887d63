"""engine/aq.py of the port against the JAX package: the integer block
energies exact, the float64 offsets of modes 1-3 equal to the last bit
(the float part is the same host numpy code on the same energies), mode
4 to 1e-5 (its angle goes through another atan2) with the number of
blocks whose rounded offset would differ stated."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from x265_tpu.engine import aq as jaq
from x265_tpu_torch.engine import aq as taq
from torch_port_util import make_hard_clip

W, H = 200, 120        # not a multiple of 16: aq_field pads by edge


def _frame(seed, bright=0):
    y, cb, cr = make_hard_clip(W, H, 1, seed)[0]
    y = np.clip(y.astype(np.int32) + bright, 0, 255).astype(np.uint8)
    return y, cb, cr


@pytest.mark.parametrize("S,bright", [(16, 0), (8, 0), (16, 90)])
def test_frame_energies_exact(S, bright):
    y, cb, cr = _frame(1, bright)
    y, cb, cr = y[:112, :192], cb[:56, :96], cr[:56, :96]
    want = np.asarray(jaq._frame_energies(jnp.asarray(y), jnp.asarray(cb),
                                          jnp.asarray(cr), S=S))
    got = taq._frame_energies(torch.from_numpy(y), torch.from_numpy(cb),
                              torch.from_numpy(cr), S=S)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    if bright:
        # bright blocks: the squared sum passes 2^31 and wraps in both
        # packages alike (the JAX package runs without 64-bit types)
        assert (y.reshape(7, 16, 12, 16).sum((1, 3)) > 46340).any()


@pytest.mark.parametrize("mode", [1, 2, 3])
@pytest.mark.parametrize("ctb_log2,bright", [(6, 0), (4, 0), (6, 90)])
def test_aq_qp_offsets_equal_to_the_last_bit(mode, ctb_log2, bright):
    y, cb, cr = _frame(2 + mode, bright)
    want = jaq.aq_qp_offsets(y, ctb_log2, mode, 1.0, cb=cb, cr=cr)
    got = taq.aq_qp_offsets(y, ctb_log2, mode, 1.0, cb=cb, cr=cr,
                            device="cpu")
    assert got.dtype == np.float64 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert np.any(np.rint(got) != 0)


def test_aq_mode4_offsets_close_and_flip_count():
    y, cb, cr = _frame(9)
    want = jaq.aq_qp_offsets(y, 4, 4, 1.0, cb=cb, cr=cr)
    got = taq.aq_qp_offsets(y, 4, 4, 1.0, cb=cb, cr=cr, device="cpu")
    assert np.allclose(got, want, rtol=1e-5, atol=1e-5)
    flips = int((np.rint(got) != np.rint(want)).sum())
    assert flips == 0, f"{flips} of {got.size} blocks round differently"
    # the edge maps themselves: density exact (integer filters,
    # thresholded). The mean angle is not comparable sample by sample: a
    # zero vertical gradient is +0 here and may be -0 out of the float
    # convolution, which turns 180 degrees into 0; neither is inclined,
    # so what aq_field reads from the angle, the inclined mask, is equal
    yp = np.pad(y, ((0, 8), (0, 8)), mode="edge")
    dj, aj = jaq._edge_maps(jnp.asarray(yp), S=16)
    dt, at = taq._edge_maps(torch.from_numpy(yp), S=16)
    assert np.array_equal(np.asarray(dj), dt.numpy())
    def inclined(a):
        return (((a >= 30) & (a <= 60)) | ((a >= 120) & (a <= 150)))
    assert np.array_equal(inclined(np.asarray(aj)), inclined(at.numpy()))
    assert inclined(at.numpy()).any()
    assert (dt > 0).any()


def test_aq_hdr10_opt_and_default_chroma():
    y, _, _ = _frame(4)
    want = jaq.aq_qp_offsets(y, 5, 2, 0.8, hdr10_opt=True)
    got = taq.aq_qp_offsets(y, 5, 2, 0.8, hdr10_opt=True, device="cpu")
    assert np.array_equal(got, want)
