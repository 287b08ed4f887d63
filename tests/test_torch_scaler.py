"""The port's downscaler (x265_tpu_torch/io/scaler.py) against the JAX
package's (x265_tpu/io/scaler.py) on the same planes: area averaging at
integer ratios (integers, exact), the polyphase bank at fractional ratios
(two float32 products, equal sample for sample on the CPU) and the host
bilinear method, on 8-bit and 10-bit planes; flat planes stay flat."""
import numpy as np
import pytest

from x265_tpu.io import scaler as jsc
from x265_tpu_torch.io import scaler as tsc
import torch_port_util  # noqa: F401  (one torch thread)


def _plane(h, w, bits, seed, kind):
    rng = np.random.default_rng(seed)
    maxv = (1 << bits) - 1
    dt = np.uint16 if bits > 8 else np.uint8
    if kind == "random":
        return rng.integers(0, maxv + 1, (h, w)).astype(dt)
    yy, xx = np.mgrid[0:h, 0:w]
    ramp = (yy * 3 + xx * 5) % (maxv + 1)
    return np.clip(ramp + rng.integers(-2, 3, (h, w)), 0, maxv).astype(dt)


@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("kind", ["random", "ramp"])
@pytest.mark.parametrize("h,w,oh,ow,method", [
    (128, 192, 64, 96, "auto"),         # area, ratio 2
    (96, 192, 32, 48, "auto"),          # area, ratios 3 and 4
    (128, 192, 86, 128, "auto"),        # polyphase, 2/3 (1080p -> 720p)
    (72, 96, 60, 80, "auto"),           # polyphase, 5/6
    (64, 96, 48, 120, "auto"),          # polyphase, down and up
    (128, 192, 86, 128, "bilinear"),
    (64, 96, 32, 48, "bilinear"),
])
def test_scale_plane_equals_reference(bits, kind, h, w, oh, ow, method):
    plane = _plane(h, w, bits, seed=h + w + bits, kind=kind)
    got = tsc.scale_plane(plane, oh, ow, method=method, device="cpu")
    want = jsc.scale_plane(plane, oh, ow, method=method)
    assert got.dtype == want.dtype == plane.dtype
    assert got.shape == (oh, ow)
    assert np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("oh,ow", [(64, 96), (86, 128)])
def test_scale_frame_equals_reference(oh, ow):
    rng = np.random.default_rng(4)
    frame = (rng.integers(0, 256, (128, 192)).astype(np.uint8),
             rng.integers(0, 256, (64, 96)).astype(np.uint8),
             rng.integers(0, 256, (64, 96)).astype(np.uint8))
    got = tsc.scale_frame(frame, oh, ow, device="cpu")
    want = jsc.scale_frame(frame, oh, ow)
    for a, b in zip(got, want):
        assert np.array_equal(a, np.asarray(b))
    assert got[0].shape == (oh, ow) and got[1].shape == (oh // 2, ow // 2)


@pytest.mark.parametrize("bits,v", [(8, 77), (8, 255), (10, 1023), (10, 3)])
@pytest.mark.parametrize("oh,ow", [(32, 48), (24, 40), (48, 64)])
def test_flat_planes_stay_flat(bits, v, oh, ow):
    dt = np.uint16 if bits > 8 else np.uint8
    flat = np.full((64, 96), v, dt)
    out = tsc.scale_plane(flat, oh, ow, device="cpu")
    assert out.dtype == dt and (out == v).all()


def test_poly_matrix_is_the_reference_bank():
    for n_in, n_out in ((1080, 720), (720, 1080), (96, 80)):
        assert np.array_equal(tsc._poly_matrix(n_in, n_out),
                              jsc._poly_matrix(n_in, n_out))


def test_same_size_is_the_plane_itself():
    p = np.zeros((16, 16), np.uint8)
    assert tsc.scale_plane(p, 16, 16, device="cpu") is p
