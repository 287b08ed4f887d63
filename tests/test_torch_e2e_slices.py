"""Multi-slice pictures at 192x128 (utils/testclip.GOLDEN_CASES): medium
with B frames and SAO in three CTU-row bands coded on a thread pool, and
noise reduction across two bands, coded one after the other, its sums
carried from picture to picture. The port's stream equals the JAX
package's byte for byte and decodes in the port's decoder to the
encoder's recon."""
import concurrent.futures
import os

import numpy as np
import pytest

from x265_tpu_torch.utils import testclip
from torch_port_util import assert_decodes_to_recon, golden_encoders


@pytest.fixture
def pools(monkeypatch):
    """Count the thread pools the band loop opens (both packages)."""
    made = []
    base = concurrent.futures.ThreadPoolExecutor

    class Counting(base):
        def __init__(self, *a, **kw):
            made.append(a[0] if a else kw.get("max_workers"))
            super().__init__(*a, **kw)
    monkeypatch.setattr(concurrent.futures, "ThreadPoolExecutor", Counting)
    return made


def test_slices3_bframes_sao_golden(pools):
    enc, stream, recons, jenc, ref, frames = golden_encoders(
        "medium_slices3")
    assert stream == ref
    p = enc.param
    assert p.slices == 3 and p.sao and p.bframes and p.ctu_size == 32
    wc = p.pic_width_in_ctbs
    assert (wc, p.pic_height_in_ctbs) == (6, 4)
    pics = testclip.stream_structure(stream)
    # bands round(i * 4 / 3): rows 0, 1-2, 3
    assert all(x["slices"] == [(0, 0), (wc, 0), (3 * wc, 0)] for x in pics)
    types = "".join("BPI"[x["slice_type"]] for x in pics)
    assert types.count("B") >= 3 and types.count("P") >= 3
    # both packages code each pass's bands on a pool of a thread a band
    # (two passes a picture: SAO's collect walk and its replay)
    n = min(3, os.cpu_count() or 1)
    assert pools == ([n] * (4 * len(pics)) if n > 1 else [])
    assert_decodes_to_recon(stream, recons, len(frames))


def test_nr_two_bands_golden(pools):
    offsets = []

    def setup(enc):
        orig = enc._nr_offsets

        def run():
            off = orig()
            offsets.append(off.copy())
            return off
        enc._nr_offsets = run
    enc, stream, recons, jenc, ref, frames = golden_encoders(
        "medium_nr_slices2", setup=setup)
    assert stream == ref
    p = enc.param
    assert (p.nr_intra, p.nr_inter, p.slices) == (200, 500, 2)
    pics = testclip.stream_structure(stream)
    assert all(len(x["slices"]) == 2 for x in pics)
    # serial bands under noise reduction (the sums are not synchronized)
    assert pools == []
    # one set of offsets a picture: none before the first picture's
    # sums, then intra (cats 0-7) and inter (8-15) offsets from the sums
    # of every picture so far, the same in both packages
    assert len(offsets) == len(frames)
    assert not offsets[0].any()
    assert offsets[1][:8].any() and offsets[-1][8:].any()
    assert np.array_equal(enc._nr["sum"], jenc._nr["sum"])
    assert np.array_equal(enc._nr["cnt"], jenc._nr["cnt"])
    assert_decodes_to_recon(stream, recons, len(frames))
