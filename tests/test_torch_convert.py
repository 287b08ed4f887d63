"""utils/convert.py: the constant tensors and frame state the port
computes on are the JAX package's, value for value."""
import numpy as np
import pytest
import torch

from x265_tpu.hevc import tables as jtab
from x265_tpu.models import inter_residual as jir
from x265_tpu.models import residual as jres
from x265_tpu.ops.intra_matrix import intra_weight_matrices as j_bank
from x265_tpu_torch.utils import convert
from torch_port_util import make_clip


def test_constants_equal_the_reference():
    for S in (8, 16):
        bank = convert.intra_bank(S, device="cpu")
        assert bank.dtype == torch.float32
        assert np.array_equal(bank.numpy(), np.asarray(j_bank(S),
                                                       np.float32))
    luma, chroma = convert.interp_filters(device="cpu")
    assert np.array_equal(luma.numpy(), jir._LUMA_FILT)
    assert np.array_equal(chroma.numpy(), jir._CHROMA_FILT)
    for n in (4, 8, 16, 32):
        for dst in (False, True):
            assert np.array_equal(
                convert.transform_matrix(n, dst, device="cpu").numpy(),
                jres._tmat(n, dst))
    q, dq = convert.quant_tables(device="cpu")
    assert np.array_equal(q.numpy(), jtab.QUANT_SCALES)
    assert np.array_equal(dq.numpy(), jtab.DEQUANT_SCALES)


def test_reference_picture_round_trip_and_layouts():
    from x265_tpu.engine.planes import FramePlanes as JPlanes
    frame = make_clip(72, 40, 1, seed=3)[0]
    ref = convert.reference_from_numpy(frame, device="cpu")
    back = convert.reference_to_numpy(ref)
    for a, b in zip(back, frame):
        assert a.dtype == np.int32 and np.array_equal(a, b)
    jref = JPlanes(host=frame)
    for a, b in zip(ref.dev_padded(80), jref.dev_padded(80)):
        assert a.dtype == torch.int16
        assert np.array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(ref.host_padded(80), jref.dev_padded(80)):
        assert a.dtype == np.int16 and np.array_equal(a, np.asarray(b))
    me_t = ref.dev_luma_me(63, 48, 80)
    me_j = np.asarray(jref.dev_luma_me(63, 48, 80))
    assert np.array_equal(me_t.numpy(), me_j)
    dev_only = convert.reference_to_numpy(
        type(ref)(dev=ref.dev(), bd=8))
    assert all(np.array_equal(a, b) for a, b in zip(dev_only, frame))


def test_decisions_round_trip_copies():
    maps = dict(cu_log2_map=np.full((4, 6), 4, np.int32),
                luma_mode8=np.ones((4, 6), np.int32),
                inter8=np.ones((4, 6), bool),
                mv8=np.zeros((4, 6, 2, 2), np.int32))
    dec = convert.decisions_from_numpy(**maps)
    dec.cu_log2_map[:] = 5
    assert maps["cu_log2_map"][0, 0] == 4          # a copy, not a view
    out = convert.decisions_to_numpy(dec)
    assert out["dir8"] is None and out["cu_log2_map"][0, 0] == 5
    assert np.array_equal(out["mv8"], maps["mv8"])


def test_native_tables_header_is_the_reference_one():
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def body(path):
        with open(os.path.join(root, path)) as f:
            return [ln for ln in f if not ln.startswith("//")]
    assert (body("x265_tpu_torch/native/tables_gen.h")
            == body("x265_tpu/native/tables_gen.h"))


def test_loopfilter_state_conversions_copy_and_default():
    """SaoParams, DeblockState with its bS inputs, a qp map and explicit
    weights, from numpy: copies, with the all-intra defaults."""
    from x265_tpu_torch.hevc.deblock import NOPOC
    rng = np.random.default_rng(0)
    maps = {k: rng.integers(0, 3, (2, 3, 4) if k.startswith("off")
                            else (2, 3))
            for k in convert._SAO_FIELDS}
    sp = convert.sao_params_from_numpy(**maps)
    maps["type_y"][:] = 9
    assert sp.type_y.max() < 3 and sp.off_cr.dtype == np.int32
    back = convert.sao_params_to_numpy(sp)
    assert set(back) == set(convert._SAO_FIELDS)
    with pytest.raises(KeyError):
        convert.sao_params_from_numpy(type_y=maps["type_y"])
    ev = rng.random((6, 8)) < 0.5
    st, intra, mv4, refpoc4 = convert.deblock_state_from_numpy(
        24, 32, ev, ev.copy(), ev.copy())
    assert st.cbf4.shape == (6, 8) and intra.all() and not mv4.any()
    assert (refpoc4 == NOPOC).all() and not st.bypass4.any()
    ev[:] = False
    assert st.edge_v.any()                         # a copy
    q = convert.qp_map_from_numpy(np.array([[30.0, 31.0]]))
    assert q.dtype == np.int32
    assert convert.weights_from_numpy() is None
    wp, ld, cd = convert.weights_from_numpy((60, -4), ((64, 2), (64, -2)))
    assert ld == cd == 6 and wp.shape == (4, 3, 3)
    assert wp[0].tolist() == [[1, 60, -4], [1, 64, 2], [1, 64, -2]]
    assert not wp[1:].any()
    wp, ld, cd = convert.weights_from_numpy((60, -4), None)
    assert (ld, cd) == (6, 0) and not wp[0, 1:].any()
