"""The B-frame golden case `fast_crf` (utils/testclip.GOLDEN_CASES,
192x128, 11 frames): `fast` without a tune under CRF — fixed mini-GOPs of
four B pictures, rd 2, the B-pyramid's referenced B, weightp on the P
anchors, cuTree over the mini-GOP. The port's stream equals the JAX
package's byte for byte, its QP maps, picture types and cuTree offsets
too, and decodes in the port's decoder to the encoder's recon; the JAX
package's stream is held against the committed golden digest."""
import numpy as np

from x265_tpu.engine import lookahead as jla
from x265_tpu_torch.engine import lookahead as tla
from x265_tpu_torch.utils import profiling
from torch_port_util import assert_decodes_to_recon, golden_encoders


def _recording(monkeypatch, module, sink):
    orig = module.cutree_propagate

    def rec(records, *a, **kw):
        off = orig(records, *a, **kw)
        sink.append((len(records), off))
        return off
    monkeypatch.setattr(module, "cutree_propagate", rec)


def test_fast_crf_fixed_minigops(monkeypatch):
    """b-adapt 0: mini-GOPs of four Bs, the middle one coded first as a
    referenced B (TRAIL_R), the leaf Bs batched per anchor pair; cuTree
    propagates over the mini-GOP and its offsets equal the reference's."""
    tcut, jcut = [], []
    _recording(monkeypatch, tla, tcut)
    _recording(monkeypatch, jla, jcut)
    profiling.reset()
    enc, stream, recons, jenc, ref, frames = golden_encoders("fast_crf")
    assert stream == ref
    p = enc.param
    assert (p.bframes == 4 and p.b_adapt == 0 and p.b_pyramid
            and p.rd_level == 2 and p.weightp and p.cu_tree)
    types = "".join(s["type"] for s in enc.frame_stats)
    assert types == "".join(s["type"] for s in jenc.frame_stats)
    assert types == "IPBBBBPBBBB"
    # decode order: the pyramid's middle B (poc 2 of 1..4) right after P
    assert [s["poc"] for s in enc.frame_stats][:4] == [0, 5, 3, 1]
    assert enc.sps.num_reorder_pics == 2 and enc.vps.num_reorder_pics == 2
    assert enc.get_ref_frame_list() == jenc.get_ref_frame_list()
    # cuTree: one chain per mini-GOP, live offsets, equal to the reference
    assert len(tcut) == len(jcut) == 2
    for (nt, ot), (nj, oj) in zip(tcut, jcut):
        assert nt == nj == 5
        assert np.array_equal(ot, oj)
    assert any((o < -0.01).any() for _, o in tcut)
    stages = profiling.report()
    for st in ("motion", "rd_promote", "loopfilter", "finalize"):
        assert stages[st]["calls"] >= 1, st
    assert_decodes_to_recon(stream, recons, len(frames))
