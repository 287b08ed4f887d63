"""models/intra_pred.py (the table-driven batched intra prediction): the
cases of tests/test_intra_pred_tpu.py (nt 4/8/16/32, all 35 modes, luma
and chroma, strong smoothing on and off), each block equal to the port's
native writer (debug_pred: filter_refs + predict_intra) and the batch
equal to the JAX function; and, against the JAX function alone, partial
reference availability and 10-bit samples. Integer and exact."""
import ctypes

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one torch thread)
from x265_tpu_torch import native
from x265_tpu_torch.models import intra_pred


def _case(nt, seed=None, bd=8):
    rng = np.random.default_rng(nt if seed is None else seed)
    R = 4 * nt + 1
    N = 70
    maxv = (1 << bd) - 1
    refs = rng.integers(0, maxv + 1, (N, R)).astype(np.int32)
    # flat-ish rows exercise the strong-smoothing bilinear branch
    refs[::3] = np.clip(
        (100 << (bd - 8)) + np.round(np.linspace(0, 6, R)).astype(np.int32)
        + rng.integers(-1, 2, R), 0, maxv)
    modes = np.concatenate([np.arange(35), np.arange(35)]).astype(np.int32)
    return refs, modes


def _jax_pred(*a):
    from x265_tpu.models.intra_pred import predict_intra_batch
    return np.asarray(predict_intra_batch(*a))


@pytest.mark.parametrize("nt", [4, 8, 16, 32])
def test_pred_matches_native_and_jax(nt):
    lib = native.get_lib()
    lib.debug_pred.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    refs, modes = _case(nt)
    N, R = refs.shape
    avail = np.ones((N, R), bool)
    for strong in (0, 1):
        for luma in (True, False):
            pred = intra_pred.predict_intra_batch(
                refs, avail, modes, nt, 8, luma, bool(strong), device="cpu")
            assert pred.dtype == torch.int32
            assert tuple(pred.shape) == (N, nt, nt)
            pred = pred.numpy()
            assert np.array_equal(pred, _jax_pred(
                refs, avail, modes, nt, 8, luma, bool(strong)))
            for i in range(N):
                want = np.zeros((nt, nt), np.int32)
                r = np.ascontiguousarray(refs[i])
                lib.debug_pred(r.ctypes.data, nt, int(modes[i]),
                               0 if luma else 1, strong, want.ctypes.data)
                assert np.array_equal(pred[i], want), (
                    nt, int(modes[i]), luma, strong)


@pytest.mark.parametrize("nt,bd", [(8, 8), (32, 8), (16, 10), (32, 10)])
def test_pred_substitution_and_10bit_match_jax(nt, bd):
    """Unavailable samples forward-filled (none available: mid-grey),
    on 8- and 10-bit samples, from tensors that stay on their device."""
    refs, modes = _case(nt, seed=100 + nt, bd=bd)
    N, R = refs.shape
    rng = np.random.default_rng(nt + bd)
    avail = rng.random((N, R)) < 0.6
    avail[5] = False
    avail[6, :R // 2] = False
    for strong in (False, True):
        for luma in (True, False):
            got = intra_pred.predict_intra_batch(
                torch.from_numpy(refs), torch.from_numpy(avail),
                torch.from_numpy(modes), nt, bd, luma, strong).numpy()
            assert np.array_equal(got, _jax_pred(refs, avail, modes, nt, bd,
                                                 luma, strong))


def test_tables_and_filter_flags_match_jax():
    from x265_tpu.models import intra_pred as jip
    for nt in (4, 8, 16, 32):
        for luma in (True, False):
            for a, b in zip(intra_pred.build_pred_tables(nt, luma),
                            jip.build_pred_tables(nt, luma)):
                assert np.array_equal(a, b)
        log2 = nt.bit_length() - 1
        assert ([intra_pred._filter_flag(m, log2) for m in range(35)]
                == [jip._filter_flag(m, log2) for m in range(35)])


def test_numpy_inputs_default_to_cuda():
    refs, modes = _case(4)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        intra_pred.predict_intra_batch(refs, np.ones(refs.shape, bool),
                                       modes, 4, 8, True, False)
