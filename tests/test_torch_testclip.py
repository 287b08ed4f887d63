"""utils/testclip.py's copies of bench.py's clips (tools/make_clips.py,
which imports the JAX package and so cannot serve the port) give the very
same pictures, at a small size and at the size chip_smoke.py uses."""
import importlib.util
import os

import numpy as np
import pytest

from x265_tpu_torch.utils import testclip

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make_clips():
    spec = importlib.util.spec_from_file_location(
        "make_clips", os.path.join(ROOT, "tools", "make_clips.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,args", [
    ("clip_pan", dict(W=320, H=288, n=3, seed=10)),
    ("clip_pan", dict(W=1280, H=720, n=2, seed=10)),
    ("clip_crowd1080", dict(W=416, H=240, n=3, seed=40))])
def test_clip_copy_equals_make_clips(name, args):
    want = list(getattr(_make_clips(), name)(**args))
    got = list(getattr(testclip, name)(**args))
    assert len(got) == len(want) == args["n"]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_lift10_is_seeded_and_keeps_the_8bit_picture():
    frames = testclip.make_clip(64, 48, 2, seed=3)
    a = testclip.lift10(frames, 5)
    b = testclip.lift10(iter(frames), 5)
    c = testclip.lift10(frames, 6)
    for fa, fb, fc, f8 in zip(a, b, c, frames):
        for pa, pb, pc, p8 in zip(fa, fb, fc, f8):
            assert pa.dtype == np.uint16 and pa.max() <= 1023
            assert np.array_equal(pa, pb)               # seeded
            assert np.array_equal(pa >> 2, p8)          # the 8-bit picture
            assert not np.array_equal(pa, pc)           # the low bits vary


def test_dhdr10_fixture_and_what_dhdr10_opt_dictates(tmp_path):
    from x265_tpu_torch.hevc.dhdr10 import load_dhdr10_json
    path = testclip.write_dhdr10_json(tmp_path / "m.json", 6, hold=2)
    assert load_dhdr10_json(path) == testclip.dhdr10_scenes(6, hold=2)
    # in display order, a repeat is dropped and a change is written
    assert testclip.dhdr10_expected("IPPPP", range(5), 6, hold=2) == [
        400, None, 500, None, 600]
    # in encode order the last payload written decides; I always writes
    types, pocs = "IPBPBI", [0, 2, 1, 5, 3, 4]
    assert testclip.dhdr10_expected(types, pocs, 6, hold=2) == [
        400, 500, 400, 600, 500, 600]
    assert testclip.dhdr10_expected("IPPP", [0, 1, 4, 5], 4, hold=2) == [
        400, None, None, None]                  # past the last entry
    assert testclip.dhdr10_expected("IPPP", range(4), 4, hold=2,
                                    opt=False) == [400, 400, 500, 500]
    with pytest.raises(ValueError, match="fixture"):
        from x265_tpu_torch.api import params as TP
        testclip.golden_params("main10_slow_hdr10", TP)
