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
