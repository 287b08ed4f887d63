"""Stage tracing (x265 analog: the ProfileScopeEvent X-macro system,
profile/cpuEvents.h + DETAILED_CU_STATS accumulators).

One canonical stage list; each scope feeds a named
torch.profiler.record_function range (visible when a profiler is
active) and an always-on wall-clock accumulator the encoder can print.
With ``sync=True`` (set_sync) a scope ends with a device synchronise so
its seconds include the device work it enqueued.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

STAGES = ("frame_read", "lookahead", "analysis", "motion", "finalize",
          "loopfilter", "sao_analyze", "bitstream_write")

_acc = defaultdict(float)
_cnt = defaultdict(int)
_sync = False


def set_sync(on: bool) -> None:
    """Synchronise the CUDA device at the end of every scope."""
    global _sync
    _sync = bool(on)


@contextlib.contextmanager
def scope(stage: str):
    """Time a stage and annotate the profiler trace when one is active."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(stage):
        yield
        if _sync and torch.cuda.is_available():
            torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    _acc[stage] += dt
    _cnt[stage] += 1


def report() -> dict:
    """Per-stage totals (seconds) and call counts."""
    return {s: {"seconds": _acc[s], "calls": _cnt[s]}
            for s in _acc}


def reset() -> None:
    _acc.clear()
    _cnt.clear()
