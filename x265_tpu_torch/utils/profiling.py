"""Spans and counters (x265 analog: the ProfileScopeEvent X-macro system,
profile/cpuEvents.h + DETAILED_CU_STATS accumulators).

Each ``scope(name)`` opens a named record_function range (visible when a
profiler is active: the span's twin on its timeline) and feeds an
always-on wall-clock accumulator (``report()``). With ``set_sync(True)`` the stage scopes in
``SYNC_STAGES`` end with a device synchronise, so their seconds include
the device work they enqueued; no other span synchronises.

While recording, every scope also appends a ``Span`` to an in-memory
list (``spans()``): name, start and end on one host clock
(``time.perf_counter_ns``), the span it ran inside, the picture it
works for, and a few attributes. Recording is off until
``record(True)``; off, a scope pays one flag test. Counters (``count``,
``counters()``) are always on. ``self_ns`` gives each span's time
outside its children.

Span tree: ``encode_frame`` (one a call of Encoder.encode_frame,
attribute ``call``, the submission index) holds the stage spans and a
``picture`` span a coded picture (its ``picture`` is the display index;
attributes ``poc``, ``type``, ``pass``); a picture's stage spans are its
descendants and carry its id. A picture whose coding yields to another
picture (the B pipeline under frame-threads) takes its open spans off
the stack with ``detach()`` and puts them back with ``attach()``, so
the other picture's spans never nest under it.
"""
from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

# stage scopes that end in a synchronise under set_sync(True)
SYNC_STAGES = ("lookahead", "slicetype", "analysis", "motion", "rd_adopt",
               "rd_promote", "tpu_residual", "host_refs", "finalize",
               "sao_analyze", "loopfilter", "rdoq", "rqt", "me.dense")
# every span the port opens: the two that group the others (a call of
# encode_frame, a coded picture), the stage scopes, the rest
SPANS = ("encode_frame", "picture") + SYNC_STAGES + (
    "analysis.intra", "mode_choice", "rd.cands", "adopt_coherent", "weightp",
    "pad_refs", "b_batch", "ratecontrol", "aq", "cutree", "vbv_reencode",
    "lf.maps", "lf.bs", "lf.upload", "lf.deblock", "lf.finish", "sao_apply",
    "sei", "nal", "frame_stats")
# every counter the port increments: each RD pass counts the units it
# tried and those whose decision it changed; rdoq.tbs the TBs handed to
# the RDOQ, rqt.tried / rqt.won the CUs the explicit RQT level re-ran /
# that took its split (all from host-side sizes and the host copy of the
# split map: no counter synchronises); writer.cus / writer.host_cus the
# CUs a picture's first native walk codes / reconstructs on the host;
# slicetype.minigops / slicetype.bframes the mini-GOPs the slice-type
# decision closed and the B pictures in them (from the host's queue)
COUNTERS = ("rd.adopt16.tried", "rd.adopt16.won", "rd.promote.tried",
            "rd.promote.won", "rd.intra32.tried", "rd.intra32.won",
            "vbv.reencodes", "rdoq.tbs", "rqt.tried", "rqt.won",
            "writer.cus", "writer.host_cus", "slicetype.minigops",
            "slicetype.bframes")


@dataclass(slots=True, eq=False)
class Span:
    id: int
    name: str
    start: int                    # perf_counter_ns
    end: int | None
    parent: int | None            # the enclosing span's id
    picture: int | None           # display index of the coded picture
    attrs: dict = field(default_factory=dict)


# a span's twin on the profiler's timeline: the range record_function
# opens, entered and left in C++ (a microsecond where record_function
# takes over ten, so that the twin and the span start and end together)
_range = torch._C._profiler._RecordFunctionFast

_acc = defaultdict(float)
_cnt = defaultdict(int)
_counters = defaultdict(int)
_sync = False
_record = False
_spans: list[Span] = []
_stack: list[Span] = []


def set_sync(on: bool) -> None:
    """Synchronise the CUDA device at the end of every stage scope."""
    global _sync
    _sync = bool(on)


def record(on: bool) -> None:
    """Append a span a scope from now on (True), or stop (False)."""
    global _record
    _record = bool(on)


@contextlib.contextmanager
def scope(stage: str, picture: int | None = None, attrs: dict | None = None):
    """Time a stage, annotate the profiler trace when one is active, and
    record a span while recording. picture: the coded picture this span
    opens (descendants inherit it)."""
    span = None
    try:
        with _range(stage):
            t0 = time.perf_counter_ns()
            if _record:
                parent = _stack[-1] if _stack else None
                if picture is None and parent is not None:
                    picture = parent.picture
                span = Span(len(_spans), stage, t0, None,
                            None if parent is None else parent.id, picture,
                            attrs or {})
                _spans.append(span)
                _stack.append(span)
            yield
            if _sync and stage in SYNC_STAGES and torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        t1 = time.perf_counter_ns()
        if span is not None:
            span.end = t1
            if span in _stack:
                _stack.remove(span)
    _acc[stage] += (t1 - t0) / 1e9
    _cnt[stage] += 1


def spanned(stage: str):
    """Decorator: the function's every call is a scope of `stage`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with scope(stage):
                return fn(*args, **kwargs)
        return call
    return wrap


def detach() -> list[Span]:
    """Take the innermost open picture span and everything opened inside
    it off the stack (a picture about to yield to another); returns them
    for attach()."""
    for i in range(len(_stack) - 1, -1, -1):
        if _stack[i].name == "picture":
            out = _stack[i:]
            del _stack[i:]
            return out
    return []


def attach(spans: list[Span]) -> None:
    """Put spans taken off by detach() back on the stack (the picture
    resumes)."""
    _stack.extend(spans)


def count(name: str, n: int = 1) -> None:
    _counters[name] += int(n)


def report() -> dict:
    """Per-span totals (seconds) and call counts."""
    return {s: {"seconds": _acc[s], "calls": _cnt[s]}
            for s in _acc}


def spans() -> list[Span]:
    """The spans recorded since the last reset(), in start order."""
    return list(_spans)


def self_ns(spans: list[Span]) -> dict:
    """span id -> its duration less the part its children cover (the
    spans must be closed)."""
    kids = defaultdict(list)
    for s in spans:
        if s.parent is not None:
            kids[s.parent].append((s.start, s.end))
    out = {}
    for s in spans:
        covered, reach = 0, s.start
        for a, b in sorted(kids[s.id]):
            a, b = max(a, reach), min(b, s.end)
            if b > a:
                covered += b - a
                reach = b
        out[s.id] = (s.end - s.start) - covered
    return out


def counters() -> dict:
    """Every counter of the port (0 where it never moved) since reset()."""
    out = {c: 0 for c in COUNTERS}
    out.update(_counters)
    return out


def reset() -> None:
    _acc.clear()
    _cnt.clear()
    _counters.clear()
    _spans.clear()
    _stack.clear()
