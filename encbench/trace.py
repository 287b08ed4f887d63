"""The traced run's readings: torch.profiler over a segment of the encode,
and the shapes of every hand-written kernel launch in that segment.

Busy time is the union of the device's operation intervals (kernels,
copies, fills) on the profiler's timeline, so overlapping streams count
once; an idle gap is named by the innermost stage scope
(``x265_tpu_torch.utils.profiling.scope``, which opens a
``record_function`` range) the host was in at the gap's middle.
"""
from __future__ import annotations

import bisect
import sys
from collections import defaultdict

import torch

from encbench import roofline

WINDOW_MARK = "encbench.traced_segment"


class LaunchRecorder:
    """Wraps the port's kernel entry points (by identity, in every loaded
    module of the port that holds them) so that each launch on a CUDA
    tensor adds its bound, worked out from its shapes; ``restore`` puts
    the originals back."""

    def __init__(self):
        self.active = False
        self.launches = defaultdict(int)
        self.bound_s = defaultdict(float)
        self._patched = []

    def install(self):
        for name, (modname, shapes) in roofline.ENTRIES.items():
            orig = getattr(sys.modules[modname], name)
            wrapper = self._wrap(name, orig, shapes)
            for mod in list(sys.modules.values()):
                if not getattr(mod, "__name__", "").startswith("x265_tpu_torch"):
                    continue
                for k, v in list(vars(mod).items()):
                    if v is orig:
                        setattr(mod, k, wrapper)
                        self._patched.append((mod, k, orig))

    def _wrap(self, name, orig, shapes):
        def entry(*args, **kwargs):
            first = args[0]
            if self.active and first.device.type == "cuda":
                nbytes, ops = shapes(*args, **kwargs)
                self.launches[name] += 1
                self.bound_s[name] += roofline.bound_s(nbytes, ops)
            return orig(*args, **kwargs)
        entry.__wrapped__ = orig
        return entry

    def restore(self):
        for mod, k, orig in reversed(self._patched):
            setattr(mod, k, orig)
        self._patched.clear()


def _is_copy(name):
    return name.startswith(("Memcpy", "Memset"))


def read_profile(prof, pictures: int, stage_names, top: int = 10) -> dict:
    """Busy and window seconds, launches, the hand-written kernels' device
    time, the top device operations and the longest idle gaps.
    stage_names: the names of the port's stage scopes; they are host
    ranges, and their device-side shadows are not operations."""
    evs = prof.events()
    ranges = set(stage_names) | {WINDOW_MARK}
    marks = [e for e in evs if e.name == WINDOW_MARK
             and "CUDA" not in str(e.device_type)]
    if not marks:
        raise RuntimeError("the traced segment's mark is not in the trace")
    w0, w1 = marks[0].time_range.start, marks[0].time_range.end
    spans, by_name = [], defaultdict(float)
    stages, kernels, ours_us = [], 0, 0.0
    for e in evs:
        a, b = e.time_range.start, e.time_range.end
        if "CUDA" in str(e.device_type):
            if e.name in ranges:
                continue
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            spans.append((a, b))
            by_name[e.name[:160]] += (b - a) / 1e6
            if not _is_copy(e.name):
                kernels += 1
                if any(k in e.name for k in roofline.KERNEL_NAMES):
                    ours_us += b - a
        elif e.name in stage_names:
            stages.append((a, b, e.name))
    spans.sort()
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    gaps, t = [], w0
    for a, b in merged:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    stages.sort()
    starts = [s[0] for s in stages]

    def host_stage(t):
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(-1, i - 64), -1):
            if stages[j][1] >= t:
                return stages[j][2]
        return "outside_stages"

    idle_by_stage = defaultdict(float)
    named = []
    for a, b in gaps:
        st = host_stage((a + b) / 2)
        idle_by_stage[st] += (b - a) / 1e6
        named.append((st, (b - a) / 1e6))
    named.sort(key=lambda g: -g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6,
        "kernels": kernels, "pictures": pictures,
        "ours_device_s": ours_us / 1e6,
        "device_ops": [[k, v] for k, v in ops[:top]],
        "idle_gaps": [[k, v] for k, v in named[:top]],
        "idle_by_stage": dict(sorted(idle_by_stage.items(),
                                     key=lambda kv: -kv[1])),
    }


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)
