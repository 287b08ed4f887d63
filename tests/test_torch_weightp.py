"""engine/weightp.py of the port against the JAX package on a clip with
a linear brightness ramp: the fitted weights, the weighted search
reference built on the device, and the decimated download."""
import numpy as np
import torch

from x265_tpu.engine import planes as jplanes
from x265_tpu.engine import weightp as jwp
from x265_tpu_torch.engine import planes as tplanes
from x265_tpu_torch.engine import weightp as twp
from x265_tpu_torch.utils import convert
from x265_tpu_torch.utils.testclip import make_ramp_clip
import torch_port_util  # noqa: F401  (one torch thread)

W, H = 192, 128


def test_analyze_slice_weights_on_a_ramp():
    frames = make_ramp_clip(W, H, 4, seed=5)
    found = 0
    for cur, ref in zip(frames[1:], frames[:-1]):
        want = jwp.analyze_slice_weights(cur, ref, 8)
        got = twp.analyze_slice_weights(cur, ref, 8)
        assert got == want
        # a reference that lives on the device downloads the 4x grid only
        fp = convert.reference_from_numpy(ref, 8, "cpu")
        fp_dev = tplanes.FramePlanes(dev=fp.dev(), bd=8)
        assert twp.analyze_slice_weights(cur, fp_dev, 8) == want
        for a, b in zip(fp_dev.host_decimated4(), ref):
            assert np.array_equal(a, np.asarray(b)[::4, ::4])
        assert not fp_dev.host_ready
        found += want[0] is not None
    assert found >= 2           # the ramp is found, so the branch is taken


def test_weight_luma_me_handle_matches():
    frames = make_ramp_clip(W, H, 2, seed=6)
    ref = frames[0]
    for w, off in ((70, -9), (58, 12), (64, 3), (127, -128)):
        jref = jplanes.FramePlanes(host=tuple(np.asarray(p) for p in ref))
        want = jwp.weight_luma_me_handle(jref, w, off, 8)
        tref = convert.reference_from_numpy(ref, 8, "cpu")
        got = twp.weight_luma_me_handle(tref, w, off, 8)
        P, ph, pw = 20, 128, 192
        a = np.asarray(want.dev_luma_me(P, ph, pw))
        b = got.dev_luma_me(P, ph, pw)
        assert b.dtype == torch.int16
        assert np.array_equal(a, b.numpy())
        host = twp.weight_plane(np.asarray(ref[0]), w, off, 8)
        assert np.array_equal(host, b.numpy()[P:P + H, P:P + W])
        assert np.array_equal(
            jwp.weight_plane(np.asarray(ref[0]), w, off, 8), host)
