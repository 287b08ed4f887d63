"""The port's ctypes wrapper of the system's libde265
(decoder/de265.py), an HEVC decoder independent of this repo, on the
streams of the stream-structure golden cases: WPP substreams, slice
segments, transform skip, noise reduction, intra refresh, dropped
duplicates. Each stream is the port's, held against the committed JAX
digest, and decodes to the encoder's recon. Skipped where the library is
absent, as the JAX package's tests are."""
import hashlib

import numpy as np
import pytest

import torch_port_util  # noqa: F401  (one torch thread)
from x265_tpu_torch.decoder import de265
from x265_tpu_torch.utils import testclip

pytestmark = pytest.mark.skipif(not de265.available(),
                                reason="libde265 unavailable")

CASES = ["medium_zerolatency_wpp_ir", "medium_slices3", "medium_tskip",
         "medium_nr_slices2", "ultrafast_lossless_wpp",
         "medium_zerolatency_dup_hist"]


@pytest.mark.parametrize("name", CASES)
def test_structure_streams_decode_in_libde265(name):
    from x265_tpu_torch.api import params as TP
    from x265_tpu_torch.api.encoder import Encoder
    frames = testclip.golden_clip(name)
    enc = Encoder(testclip.golden_params(name, TP), device="cpu")
    by_idx, in_order = {}, []

    def sink(idx, planes):
        by_idx[idx] = planes
        in_order.append(idx)
    enc.recon_sink = sink
    stream, _ = testclip.golden_stream(enc, name, frames)
    gold = testclip.golden_digests()[name]
    assert hashlib.sha256(stream).hexdigest() == gold["sha256"]
    pics = de265.decode(stream)
    if name == "medium_zerolatency_dup_hist":
        # zerolatency signals no reordering while --frame-dup codes B
        # pictures: libde265 outputs in decode order (ROADMAP Queue 3)
        order = in_order
    else:
        order = sorted(by_idx)
    assert len(pics) == len(order) == len(by_idx)
    for pic, idx in zip(pics, order):
        for a, b in zip(pic, by_idx[idx]):
            assert np.array_equal(a, np.asarray(b))
