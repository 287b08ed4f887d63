"""The port's spans and counters (x265_tpu_torch/utils/profiling.py): the
span tree of a medium encode whose B pictures interleave under
frame-threads 2, self times, recording off, the counters of a VBV clip
that re-encodes, the spans on a CPU torch.profiler's timeline, and the
names the port opens against the ones profiling and PERF.md list."""
import os
import re
import statistics

import numpy as np
import pytest
import torch

from torch_port_util import make_clip
from x265_tpu_torch.api import params as TP
from x265_tpu_torch.api.encoder import Encoder
from x265_tpu_torch.engine.planes import FramePlanes
from x265_tpu_torch.models.rdo import rd_adopt16
from x265_tpu_torch.utils import profiling, testclip

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "x265_tpu_torch")


def _medium_encode(n=14):
    """x265 medium at 416x240 under ABR, frame-threads 2; the lookahead
    cut to 8 pictures so that mini-GOPs come within n pictures."""
    p = TP.param_default_preset("medium")
    TP.param_parse(p, "bitrate", "300")
    TP.param_parse(p, "rc-lookahead", "8")
    p.width, p.height = 416, 240
    assert p.frame_parallelism == 2 and p.bframes >= 3
    enc = Encoder(p, device="cpu")
    enc.headers()
    for f in make_clip(416, 240, n, 3, step=(1, 1)):
        enc.encode_frame(*f)
    return enc


@pytest.fixture(scope="module")
def traced():
    """The medium encode recorded under a CPU torch.profiler, inside a
    mark range: (encoder, spans, counters, profiler events)."""
    profiling.reset()
    profiling.record(True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("segment"):
                enc = _medium_encode()
        got = profiling.spans(), profiling.counters()
    finally:
        profiling.record(False)
        profiling.reset()
    return enc, got[0], got[1], prof.events()


def _by_id(sp):
    return {s.id: s for s in sp}


def test_span_tree_roots_and_pictures(traced):
    enc, sp, _, _ = traced
    by = _by_id(sp)
    roots = [s for s in sp if s.parent is None]
    assert roots and all(s.name == "encode_frame" for s in roots)
    assert [s.attrs["call"] for s in roots] == list(range(len(roots)))
    pics = [s for s in sp if s.name == "picture"]
    # one picture span a coded picture, each under an encode_frame span
    assert sorted(s.attrs["poc"] for s in pics) == \
        sorted(st["poc"] for st in enc.frame_stats)
    assert "".join(sorted(s.attrs["type"] for s in pics)) == \
        "".join(sorted(st["type"] for st in enc.frame_stats))
    assert {"I", "P", "B"} <= {s.attrs["type"] for s in pics}
    for s in pics:
        assert by[s.parent].name == "encode_frame"
        assert s.attrs["pass"] == 0
    # every span is closed and lies inside its parent
    for s in sp:
        assert s.end is not None and s.end >= s.start
        if s.parent is not None:
            p = by[s.parent]
            assert p.start <= s.start and s.end <= p.end


def test_interleaved_pictures_keep_their_own_spans(traced):
    """Under frame-threads 2 a leaf B picture's coding runs while the one
    before it waits on its loop filter: the two picture spans overlap in
    time, and no span sits under a picture other than its own."""
    _, sp, _, _ = traced
    by = _by_id(sp)
    pics = sorted((s for s in sp if s.name == "picture"),
                  key=lambda s: s.start)
    overlaps = [(a, b) for a, b in zip(pics, pics[1:]) if b.start < a.end]
    assert overlaps, "no two pictures were in flight together"
    for a, b in overlaps:
        assert a.attrs["type"] == b.attrs["type"] == "B"
    for s in sp:
        q = s.parent
        while q is not None:
            if by[q].name == "picture":
                assert s.picture == by[q].picture, (s, by[q])
            q = by[q].parent
    # the layer spans of each picture carry its id
    for name in ("finalize", "loopfilter", "lf.finish", "sao_analyze"):
        assert all(s.picture is not None for s in sp if s.name == name)


def test_self_time_is_duration_less_children(traced):
    _, sp, _, _ = traced
    own = profiling.self_ns(sp)
    kids = {}
    for s in sp:
        kids.setdefault(s.parent, []).append(s)
    checked = 0
    for s in sp:
        ch = kids.get(s.id, [])
        # children of one span run one after another unless pictures
        # interleave, which only encode_frame's children do
        if s.name == "encode_frame" or not ch:
            continue
        assert own[s.id] == (s.end - s.start) - sum(c.end - c.start
                                                    for c in ch)
        checked += 1
    assert checked > 20
    assert all(v >= 0 for v in own.values())
    # encode_frame's children overlap where pictures interleave: its
    # self time is what the union of its children leaves
    for s in sp:
        if s.name == "encode_frame":
            assert 0 <= own[s.id] < s.end - s.start


def test_self_time_of_overlapping_children():
    S = profiling.Span
    sp = [S(0, "encode_frame", 0, 100, None, None),
          S(1, "picture", 10, 30, 0, 1), S(2, "picture", 20, 50, 0, 2),
          S(3, "ratecontrol", 25, 28, 0, None), S(4, "sei", 60, 70, 0, 1),
          S(5, "nal", 90, 120, 0, 1)]
    own = profiling.self_ns(sp)
    assert own[0] == 100 - 40 - 10 - 10
    assert own[1] == 20 and own[5] == 30


def test_spans_on_the_profiler_timeline(traced):
    """Each span against its record_function twin (the host range of its
    name, the two paired in start order), after one offset, the median:
    within 0.2 ms at both ends."""
    _, sp, _, events = traced
    ranges = {}
    for e in events:
        if "CUDA" not in str(e.device_type):
            ranges.setdefault(e.name, []).append(e.time_range)
    pairs = []
    for name in {s.name for s in sp}:
        mine = sorted((s for s in sp if s.name == name),
                      key=lambda s: s.start)
        twins = sorted(ranges.get(name, []), key=lambda r: r.start)
        assert len(twins) == len(mine), name
        pairs += zip(mine, twins)
    off = statistics.median(r.start - s.start / 1e3 for s, r in pairs)
    err = max(max(abs(r.start - s.start / 1e3 - off),
                  abs(r.end - s.end / 1e3 - off)) for s, r in pairs)
    assert err < 200.0, err


def test_rd_counters(traced):
    _, _, counters, _ = traced
    assert set(counters) == set(profiling.COUNTERS)
    for rd in ("rd.adopt16", "rd.promote"):
        assert 0 < counters[rd + ".won"] <= counters[rd + ".tried"], rd
    assert 0 <= counters["rd.intra32.won"] <= counters["rd.intra32.tried"]
    assert counters["vbv.reencodes"] == 0


SLOW_SCOPES = ("rdoq", "rqt", "me.dense")
SLOW_COUNTERS = ("rdoq.tbs", "rqt.tried", "rqt.won")


def test_slow_scopes_stay_closed_in_medium(traced):
    """medium (rdoq-level 0, tu-inter-depth 1, the two-level search at
    merange 57) opens none of the slow preset's three scopes and moves
    none of their counters."""
    _, sp, counters, _ = traced
    assert not {s.name for s in sp} & set(SLOW_SCOPES)
    assert all(counters[c] == 0 for c in SLOW_COUNTERS)


def test_slow_encode_opens_its_scopes_and_counts():
    """A tiny encode at the port's slow preset, tu-inter-depth 2 as its
    table has it (the lookahead cut to 6 pictures and the search range to
    16, so that it stays small): RDOQ, the explicit RQT and the
    dense search each open their stage scope inside the picture (or the
    leaf-B batch) they work for, and the
    counters follow: TBs handed to RDOQ, CUs the RQT re-ran, those that
    took the split (no more than it re-ran)."""
    p = TP.param_default_preset("slow")
    for k, v in (("bitrate", "300"), ("rc-lookahead", "6"),
                 ("merange", "16"), ("psy-rdoq", "1.0")):
        TP.param_parse(p, k, v)
    p.width, p.height = 192, 128
    profiling.reset()
    profiling.record(True)
    try:
        enc = Encoder(p, device="cpu")
        enc.headers()
        for f in make_clip(192, 128, 10, 3, step=(1, 1)):
            enc.encode_frame(*f)
        enc.flush()
        sp, counters = profiling.spans(), profiling.counters()
        stages = profiling.report()
    finally:
        profiling.record(False)
        profiling.reset()
    assert set(SLOW_SCOPES) <= set(profiling.SYNC_STAGES)
    by = _by_id(sp)

    def ancestors(s):
        while s.parent is not None:
            s = by[s.parent]
            yield s.name
    for name in SLOW_SCOPES:
        mine = [s for s in sp if s.name == name]
        assert mine and stages[name]["calls"] == len(mine), name
        # each inside a picture, or the leaf-B batch of several
        assert all({"picture", "b_batch"} & set(ancestors(s))
                   for s in mine), name
    # the RQT and RDOQ run inside the residual, the dense sweep in motion
    assert all(by[s.parent].name == "tpu_residual"
               for s in sp if s.name == "rqt")
    assert all(by[s.parent].name == "motion"
               for s in sp if s.name == "me.dense")
    assert counters["rdoq.tbs"] > 0
    assert 0 < counters["rqt.won"] <= counters["rqt.tried"]


@pytest.mark.parametrize("case", ["own_motion", "other_motion"])
def test_adopt16_counts_inter_blocks_and_changed_motion(case):
    """rd_adopt16 on a 64x64 picture whose own motion points far off: the
    candidate wins every inter block. It counts only the inter blocks as
    tried, and as won only those whose motion changed: a candidate equal
    to a block's own motion wins on its header alone and changes none."""
    p = TP.param_default_preset("medium")
    p.width = p.height = 64
    rng = np.random.default_rng(7)
    y = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    cb, cr = (rng.integers(0, 256, (32, 32), dtype=np.uint8)
              for _ in range(2))
    ref = FramePlanes(host=(y, cb, cr), bd=8, device="cpu")
    inter = np.ones((4, 4), bool)
    inter[0, 0] = False
    own = (0, 0) if case == "own_motion" else (64, 40)
    mv = np.zeros((4, 4, 2, 2), np.int32)
    mv[:, :, 0] = own
    dirs = np.ones((4, 4), np.int32)
    refs = np.zeros((4, 4), np.int32)
    profiling.reset()
    d2, mv2, r2, adopted = rd_adopt16(
        (y, cb, cr), [ref], [], inter, mv, dirs, refs,
        [(1, 0, 0, (0, 0), (0, 0))], 30, p, device="cpu")
    c = profiling.counters()
    profiling.reset()
    assert c["rd.adopt16.tried"] == 15
    assert adopted.sum() == 15 and not adopted[0, 0]
    assert c["rd.adopt16.won"] == (0 if case == "own_motion" else 15)
    assert (mv2[inter, 0] == 0).all() and (d2 == 1).all() and (r2 == 0).all()


@pytest.mark.parametrize("mode", ["off_under_profiler", "off_unprofiled"])
def test_recording_off_leaves_no_spans(mode):
    profiling.reset()
    profiling.record(False)
    try:
        if mode == "off_under_profiler":
            acts = [torch.profiler.ProfilerActivity.CPU]
            with torch.profiler.profile(activities=acts):
                with profiling.scope("analysis"):
                    pass
        else:
            with profiling.scope("analysis"):
                pass
        assert profiling.spans() == []
        # the accumulator reads as before
        assert profiling.report()["analysis"]["calls"] == 1
    finally:
        profiling.record(False)
        profiling.reset()


def test_generators_detach_and_attach():
    """Two pictures whose coding yields mid-way, resumed in turn: each
    one's spans stay under its own picture span."""
    def picture(i):
        with profiling.scope("picture", picture=i):
            with profiling.scope("finalize"):
                pass
            mine = profiling.detach()
            yield
            profiling.attach(mine)
            with profiling.scope("loopfilter"):
                pass

    profiling.reset()
    profiling.record(True)
    try:
        with profiling.scope("encode_frame"):
            a, b = picture(0), picture(1)
            next(a)
            next(b)
            with profiling.scope("ratecontrol"):
                pass
            for g in (a, b):
                with pytest.raises(StopIteration):
                    next(g)
        sp = profiling.spans()
    finally:
        profiling.record(False)
        profiling.reset()
    by = _by_id(sp)
    for s in sp:
        if s.name in ("finalize", "loopfilter"):
            assert by[s.parent].name == "picture"
            assert by[s.parent].picture == s.picture
    rc = [s for s in sp if s.name == "ratecontrol"][0]
    assert by[rc.parent].name == "encode_frame" and rc.picture is None


def test_vbv_reencode_counted_and_spanned():
    """The ABR + VBV clip whose pictures are coded again (the golden case
    tests/test_torch_e2e_live.py holds byte for byte): the counter and
    the vbv_reencode spans follow Encoder.vbv_reencodes, and the rebuilt
    pass's picture span says which pass it is."""
    name = "fast_zerolatency_abr_vbv"
    frames = testclip.golden_clip(name)

    def port(p):
        return Encoder(p, device="cpu")
    enc = port(testclip.golden_params(name, TP, None, encoder=port))
    profiling.reset()
    profiling.record(True)
    try:
        testclip.golden_stream(enc, name, frames)
        sp, counters = profiling.spans(), profiling.counters()
    finally:
        profiling.record(False)
        profiling.reset()
    assert enc.vbv_reencodes >= 1
    assert counters["vbv.reencodes"] == enc.vbv_reencodes
    re_spans = [s for s in sp if s.name == "vbv_reencode"]
    assert len(re_spans) == enc.vbv_reencodes
    by = _by_id(sp)
    for s in re_spans:
        pics = [c for c in sp if c.parent == s.id and c.name == "picture"]
        assert len(pics) == 1 and pics[0].attrs["pass"] == s.attrs["pass"]
        assert pics[0].attrs["pass"] >= 1
        assert by[s.parent].name == "encode_frame"
    assert sum(1 for s in sp if s.name == "picture"
               and s.attrs["pass"] == 0) == len(frames)


def _port_literals(call):
    pat = re.compile(call + r'\("([^"]+)"')
    found = set()
    for d, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    found |= set(pat.findall(fh.read()))
    return found


def test_every_opened_span_is_listed():
    opened = _port_literals(r"(?:scope|spanned)")
    assert opened == set(profiling.SPANS)
    assert _port_literals(r"profiling\.count") == set(profiling.COUNTERS)


@pytest.mark.parametrize("name", profiling.SPANS + profiling.COUNTERS)
def test_perf_md_names_each_span_and_counter(name):
    with open(os.path.join(ROOT, "PERF.md")) as f:
        assert f"`{name}`" in f.read()
