"""x265's `slow` preset, golden case `slow_crf` (utils/testclip.GOLDEN_CASES,
192x128, 11 frames, CRF 28): RDOQ 2 (psy-RDOQ), rd 4, the explicit inter
RQT (tu-inter-depth 2), the dense star search at merange 57 over four
references, subme 3, B frames placed by b-adapt 2. The port's stream and
QPs equal the JAX package's (the JAX stream held against the committed
golden digest) and the stream decodes in the port's decoder to the
encoder's recon. A file of its own: the JAX side's dense search on the
CPU takes most of a few minutes.

The JAX side compiles without JAX's persistent compilation cache (the
directory X265TPU_XLA_CACHE names, shared by every test process). That
cache takes no lock when it has no size cap, writes an entry in place,
and stores it zstd-compressed without a checksum, so two processes that
write one entry at once can leave a torn entry that a third loads. This
file compiles the largest JAX programs of the port's tests (the dense
R=57 search); a test process running it was lost once inside a cache read
and it failed once under the six-process run while passing alone. It now
reads and writes no entry, at about a minute more of compiles."""
import pytest
from jax._src import compilation_cache

from x265_tpu_torch.engine import me as tme
from x265_tpu_torch.models import inter_residual as tir
from torch_port_util import assert_decodes_to_recon, golden_encoders


@pytest.fixture
def no_persistent_xla_cache(monkeypatch):
    """No cache key for any compile of the test: JAX then neither reads
    nor writes the persistent cache (the in-process caches stay)."""
    monkeypatch.setattr(compilation_cache, "is_cache_used",
                        lambda backend: False)


def test_slow_crf_rdoq_rqt_dense_search(monkeypatch,
                                        no_persistent_xla_cache):
    ranges, splits = [], []
    int_stage, pre = tme._int_stage, tir.build_inter_pre

    def int_stage_rec(cur, ref_R, mvcost, S, R):
        ranges.append((S, R))
        return int_stage(cur, ref_R, mvcost, S, R)

    def pre_rec(*a, **kw):
        out = pre(*a, **kw)
        if out is not None:
            splits.append(int(out["tusplit8"].sum()))
        return out
    monkeypatch.setattr(tme, "_int_stage", int_stage_rec)
    monkeypatch.setattr(tir, "build_inter_pre", pre_rec)
    enc, stream, recons, jenc, ref, frames = golden_encoders("slow_crf")
    assert stream == ref
    p = enc.param
    assert (p.rd_level == 4 and p.rdoq_level == 2 and p.tu_inter_depth == 2
            and p.me_method == "star" and p.me_range == 57 and p.ref == 4
            and p.sub_me == 3)
    assert enc.sps.max_transform_hierarchy_depth_inter == 1
    qps = [s["qp"] for s in enc.frame_stats]
    assert qps == [s["qp"] for s in jenc.frame_stats]
    types = "".join(s["type"] for s in enc.frame_stats)
    assert types[0] == "I" and "P" in types and "B" in types
    # every integer search was the dense sweep at S=16, R=57
    assert ranges and set(ranges) == {(16, 57)}
    # the explicit RQT split fired somewhere in the clip
    assert sum(splits) > 0
    assert_decodes_to_recon(stream, recons, len(frames))
