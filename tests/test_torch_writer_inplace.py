"""The native writer's walks, picture by picture, against digests recorded
before they worked in place on the device's planes: each picture's slice
bytes, and the pre-loop-filter recon, luma cbf map and QP map its first
walk hands to the deblock. The cases are golden cases (their streams are
held to the committed records too) that reach every kind of walk: P
pictures with intra CUs and SAO, B pictures, CTU-row bands on threads,
transform skip (whose second walk recomputes), noise reduction (no device
residual), WPP, lossless, Main10 with scaling lists, SAO without deblock
and the walk that quantizes every TB (use_tpu_residual off).

`python tests/test_torch_writer_inplace.py` rewrites the digests; they
may change only where a change of the streams is meant.

Then the writer's counters: writer.cus (the CUs a picture's first walk
codes) and writer.host_cus (those it reconstructs itself)."""
import json
import os

import numpy as np
import pytest

from torch_port_util import golden_encoders

DIGESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "writer_inplace_digests.json")
CASES = ("medium_crf_cut", "medium_zerolatency_wpp_ir", "medium_slices3",
         "medium_tskip", "medium_nr_slices2", "medium_abr_cpu_residual",
         "fast_lossless", "main10_medium_scaling", "split_nosdh_nodeblock")


def _digest(a, dtype):
    from x265_tpu_torch.utils.testclip import array_digest
    return array_digest(a, dtype)["sha256"][:16]


def _walk_digests(name):
    """{"slices": [digest of a picture's slice bytes], "prefilter":
    [[recon y, cb, cr, cbf4 or None, qp]]}, both in the order the
    pictures reach them."""
    slices, prefilter = [], []

    def spy(enc):
        gen = enc._inter_slice_gen
        inter, intra = enc._deblock_inter_recon, enc._deblock_intra_recon

        def slice_gen(*a):
            data, recon = yield from gen(*a)
            parts = ([d for _, d in data] if isinstance(data, list)
                     else [data])
            slices.append(_digest(np.frombuffer(b"".join(parts), np.uint8),
                                  np.uint8))
            return data, recon

        def note(recon, cbf4, qp):
            prefilter.append(
                [_digest(pl, np.int32) for pl in recon]
                + [None if cbf4 is None else _digest(cbf4, np.uint8),
                   _digest(np.atleast_1d(qp), np.int32)])

        def deblock_inter(recon, decisions, cbf4, ref_poc, qp, **kw):
            note(recon, cbf4, qp)
            return inter(recon, decisions, cbf4, ref_poc, qp, **kw)

        def deblock_intra(recon, decisions, qp, **kw):
            note(recon, None, qp)
            return intra(recon, decisions, qp, **kw)
        enc._inter_slice_gen = slice_gen
        enc._deblock_inter_recon = deblock_inter
        enc._deblock_intra_recon = deblock_intra
    golden_encoders(name, setup=spy)
    return {"slices": slices, "prefilter": prefilter}


@pytest.mark.parametrize("name", CASES)
def test_writer_walks_match_recorded_digests(name):
    with open(DIGESTS, encoding="utf-8") as f:
        want = json.load(f)[name]
    got = _walk_digests(name)
    assert len(got["slices"]) == len(want["slices"])
    for i, (a, b) in enumerate(zip(got["prefilter"], want["prefilter"])):
        assert a == b, f"{name}: picture {i} (pass-1 order)"
    assert got == want


def _cu_count(cu_log2_map):
    """CUs of a picture: 8x8 blocks at the origin of their CU."""
    h8, w8 = cu_log2_map.shape
    r = (1 << cu_log2_map.astype(np.int64)) >> 3
    ys, xs = np.indices((h8, w8))
    return int(((ys % r == 0) & (xs % r == 0)).sum())


def test_writer_counts_cus_and_host_cus():
    """Each picture's first walk counts its CUs (every CU of the CU-size
    map) and, of them, those it reconstructs on the host: all of an I
    picture's, none of a B picture whose CUs are all inter and all on the
    device's residual. The second walk (SAO's emit-only replay) counts
    nothing."""
    from x265_tpu_torch.hevc.headers import SLICE_B, SLICE_I
    from x265_tpu_torch.utils import profiling
    pics = []

    def spy(enc):
        gen = enc._inter_slice_gen

        def slice_gen(frame, sh, decisions, refs, ref_poc, poc, slice_type):
            c0 = profiling.counters()
            g = gen(frame, sh, decisions, refs, ref_poc, poc, slice_type)
            try:
                next(g)                 # the first walk, then the deblock
            except StopIteration as e:
                done = e.value
            else:
                done = None
            c1 = profiling.counters()
            pics.append((slice_type, decisions.cu_log2_map.copy(),
                         decisions.inter8,
                         c1["writer.cus"] - c0["writer.cus"],
                         c1["writer.host_cus"] - c0["writer.host_cus"]))
            if done is not None:
                return done
            yield
            c2 = profiling.counters()
            out = yield from g
            assert profiling.counters()["writer.cus"] == c2["writer.cus"]
            return out
        enc._inter_slice_gen = slice_gen
    profiling.reset()
    try:
        enc = golden_encoders("medium_crf_cut", setup=spy)[0]
    finally:
        profiling.reset()
    assert {"writer.cus", "writer.host_cus"} <= set(profiling.counters())
    assert enc.param.sao
    kinds = set()
    for slice_type, cu_map, inter8, cus, host in pics:
        assert cus == _cu_count(cu_map)
        assert 0 <= host <= cus
        if slice_type == SLICE_I:
            assert host == cus
            kinds.add("I")
        elif slice_type == SLICE_B and inter8 is not None and inter8.all():
            assert host == 0
            kinds.add("B")
    assert kinds == {"I", "B"}


if __name__ == "__main__":
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(DIGESTS)))
    out = {name: _walk_digests(name) for name in CASES}
    with open(DIGESTS, "w", encoding="utf-8") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
