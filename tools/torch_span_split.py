"""Where a benchmark cell's host time goes, span by span, on the card.

    python3 tools/torch_span_split.py --workload live_1080p.cuts --seeds 1,2,3 \
        --out split.jsonl

For each seed: the cell's set-up as encbench/run.py makes it (pictures from
the seed, a warm-up encoder), then a fresh encoder fed `--lead` pictures,
then `--pairs` pairs of segments of `--pictures` coded pictures under
torch.profiler, the port's span recording on in one segment of a pair and
off in the other (alternating which comes first from seed to seed). A
segment with recording on is split: each CUDA runtime call of the trace
is put down to the innermost span it ran in (kernel launches, waits,
copies), every span's self time less those calls is its host Python, and
each idle gap of the device is named by encbench.trace's innermost range.
One JSON line a segment goes to `--out`; the last line of standard output
sums up the seeds. `--device cpu --size 416x240` rehearses it without a
card (times from such a run are not the card's).
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import time
from collections import defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from encbench import frames, spec  # noqa: E402
from encbench.run import pictures_in  # noqa: E402
from encbench.trace import WINDOW_MARK, read_profile  # noqa: E402
from x265_tpu_torch.api.encoder import Encoder  # noqa: E402
from x265_tpu_torch.utils import devcache, profiling  # noqa: E402

# spans that group the others: a call of Encoder.encode_frame, a picture
STRUCTURE = ("encode_frame", "picture")
# the layers of PERF.md, each a set of span names
LAYERS = {
    "lookahead": ("lookahead", "slicetype", "cutree"),
    "analysis": ("analysis", "analysis.intra"),
    "motion": ("motion", "mode_choice", "weightp", "pad_refs"),
    "rd": ("rd_adopt", "rd_promote", "rd.cands", "adopt_coherent"),
    "residual": ("tpu_residual", "host_refs"),
    "loopfilter": ("loopfilter", "sao_analyze", "lf.maps", "lf.bs",
                   "lf.upload", "lf.deblock", "lf.finish", "sao_apply"),
    "writer": ("finalize", "sei", "nal"),
    "ratecontrol": ("ratecontrol", "aq", "vbv_reencode"),
    "entry": STRUCTURE + ("b_batch", "frame_stats"),
}
RD_PASSES = ("rd.adopt16", "rd.promote", "rd.intra32")


def twin_pairs(sp, events):
    """Each span with its record_function twin (the host range of its
    name, paired in start order where a name has as many ranges as
    spans)."""
    ranges = defaultdict(list)
    for e in events:
        if "CUDA" not in str(e.device_type):
            ranges[e.name].append(e.time_range)
    by_name = defaultdict(list)
    for s in sp:
        by_name[s.name].append(s)
    pairs = []
    for name, ss in by_name.items():
        rs = sorted(ranges.get(name, []), key=lambda r: r.start)
        if len(rs) == len(ss):
            pairs += zip(sorted(ss, key=lambda s: s.start), rs)
    return pairs


def twin_error_us(span, twin, offset_us):
    """The wider of |start| and |end| of a twin against its span."""
    return max(abs(twin.start - (span.start / 1e3 + offset_us)),
               abs(twin.end - (span.end / 1e3 + offset_us)))


def runtime_kind(name: str):
    """launch, wait (a synchronise or a blocking copy), copy (an
    asynchronous copy's host time) or None for a CUDA runtime call."""
    if "LaunchKernel" in name or name.startswith("cuLaunch"):
        return "launch"
    if "Synchronize" in name or name == "cudaMemcpy":
        return "wait"
    if name.startswith(("cudaMemcpy", "cudaMemset")):
        return "copy"
    return None


def runtime_split(sp, offset_us, calls):
    """Each runtime call (name, start_us, end_us on the profiler's
    timeline) put down to the innermost span open at its middle: returns
    {span id: {kind: ns}} and the ns of calls outside every span."""
    order = sorted(sp, key=lambda s: s.start)
    starts = [s.start for s in order]
    out = defaultdict(lambda: defaultdict(int))
    outside = defaultdict(int)
    for name, a, b in calls:
        kind = runtime_kind(name)
        t = ((a + b) / 2 - offset_us) * 1e3
        ns = int(round((b - a) * 1e3))
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(-1, i - 256), -1):
            if order[j].end >= t:
                out[order[j].id][kind] += ns
                break
        else:
            outside[kind] += ns
    return out, dict(outside)


def uncovered(sp, per):
    """The time in encode_frame spans that no layer span covers (picture
    spans overlap where pictures interleave, so this is no sum of self
    times): ms a picture in all, and by the layer spans around each
    stretch, the 12 largest."""
    layer = sorted((s for s in sp if s.name not in STRUCTURE),
                   key=lambda s: s.start)
    out = defaultdict(float)
    for r in sp:
        if r.name != "encode_frame":
            continue
        t, prev = r.start, "(start)"
        for c in layer:
            if c.start < r.start or c.start >= r.end:
                continue
            if c.start > t:
                out[f"{prev} | {c.name}"] += (c.start - t) / 1e6
            if c.end > t:
                t, prev = c.end, c.name
        if r.end > t:
            out[f"{prev} | (end)"] += (r.end - t) / 1e6
    top = sorted(out.items(), key=lambda kv: -kv[1])[:12]
    return per * sum(out.values()), {k: per * v for k, v in top}


def split_segment(prof, got, seg_s):
    """The readings of one segment recorded with spans on."""
    evs = prof.events()
    tr = read_profile(prof, got, set(profiling.report()))
    sp, counters = profiling.spans(), profiling.counters()
    pairs = twin_pairs(sp, evs)
    off = statistics.median(r.start - s.start / 1e3 for s, r in pairs)
    worst = sorted(((twin_error_us(s, r, off), s.name) for s, r in pairs),
                   reverse=True)
    per = 1.0 / got
    unattributed, between = uncovered(sp, per)
    mark = [e for e in evs if e.name == WINDOW_MARK
            and "CUDA" not in str(e.device_type)][0].time_range
    calls = [(e.name, e.time_range.start, e.time_range.end) for e in evs
             if "CUDA" not in str(e.device_type)
             and runtime_kind(e.name)
             and mark.start <= e.time_range.start <= mark.end]
    by_span, outside = runtime_split(sp, off, calls)
    own = profiling.self_ns(sp)
    names = defaultdict(lambda: defaultdict(float))
    for s in sp:
        row = names[s.name]
        row["self_ms"] += own[s.id] / 1e6
        for kind, ns in by_span.get(s.id, {}).items():
            row[kind + "_ms"] += ns / 1e6
    for row in names.values():
        row["host_ms"] = row["self_ms"] - sum(
            row.get(k + "_ms", 0.0) for k in ("launch", "wait", "copy"))
    layers = {}
    for layer, members in LAYERS.items():
        layers[layer] = {k: per * sum(names[n].get(k, 0.0) for n in members
                                      if n in names)
                         for k in ("self_ms", "host_ms", "launch_ms",
                                   "wait_ms", "copy_ms")}
    kinds = defaultdict(float)
    for d in by_span.values():
        for kind, ns in d.items():
            kinds[kind] += ns / 1e6
    idle = tr["idle_by_stage"]
    idle_s = sum(idle.values()) or 1e-12
    return {
        "ms_per_picture": 1e3 * seg_s * per,
        "twin_offset_us": off, "twin_pairs": len(pairs),
        "twin_err_ms": worst[0][0] / 1e3, "twin_worst_us": worst[:6],
        "twins_within_0.2ms": sum(e <= 200.0 for e, _ in worst) / len(worst),
        "spans": len(sp),
        "unattributed_ms_per_frame": unattributed,
        "ratecontrol_ms_per_frame": per * sum(
            s.end - s.start for s in sp
            if s.name in ("ratecontrol", "aq")) / 1e6,
        "launch_ms_per_frame": per * kinds["launch"],
        "host_wait_ms_per_frame": per * kinds["wait"],
        "copy_ms_per_frame": per * kinds["copy"],
        "loopfilter_host_ms_per_frame": layers["loopfilter"]["host_ms"],
        "rd_host_ms_per_frame": layers["rd"]["host_ms"],
        "rd_won_share": {r: 100.0 * counters[r + ".won"]
                         / counters[r + ".tried"]
                         for r in RD_PASSES if counters[r + ".tried"]},
        "vbv_reencodes_per_frame": per * counters["vbv.reencodes"],
        "runtime_outside_spans_ms": {k: v / 1e6 for k, v in outside.items()},
        "counters": counters,
        "layers": layers,
        "idle_s": idle_s,
        # idle no layer explains: outside every range, or on the ranges
        # that only group the layers
        "unattributed_idle_share": sum(
            idle.get(n, 0.0) for n in ("outside_stages",) + STRUCTURE)
        / idle_s,
        "idle_by_span": idle,
        "idle_gaps": tr["idle_gaps"],
        "device_idle_share": 1.0 - tr["busy_s"] / tr["window_s"],
        "unattributed_between": between,
        "by_span": {n: dict(r) for n, r in sorted(
            names.items(), key=lambda kv: -kv[1]["self_ms"])},
    }


def run_seed(workload, seed, lead, pairs, want, device, size, first_on):
    cell = spec.load_cell(workload)
    cfg, mix = cell["config_spec"], cell["traffic_spec"]
    W, H = size or (cfg["width"], cfg["height"])
    on_card = device == "cuda"
    if on_card:
        from x265_tpu_torch import native
        from x265_tpu_torch.ops import cuda_build
        cuda_build.get_lib()
        native.get_lib()
    pool = frames.make_pool(mix, W, H, seed, cfg["bit_depth"])
    params = spec.params(cfg, W, H)

    def pos(s):
        return frames.feed_order(mix, len(pool), 1, s)[0]
    wu = cell["warmup"]
    enc = Encoder(params, device=device)
    enc.headers()
    fed = aus = 0
    while fed < wu["pictures"] or aus < wu["min_aus"]:
        y, cb, cr = pool[pos(wu["start"] + fed)]
        aus += pictures_in(enc.encode_frame(y.copy(), cb.copy(), cr.copy()))
        fed += 1
    del enc
    devcache.clear()
    w0 = cell.get("window", {}).get("start", 0)
    enc = Encoder(params, device=device)
    enc.headers()
    k = 0
    t = time.perf_counter()
    while k < lead:
        y, cb, cr = (p.copy() for p in pool[pos(w0 + k)])
        enc.encode_frame(y, cb, cr)
        k += 1
    lead_s = time.perf_counter() - t
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    rows = []
    for i in range(2 * pairs):
        on = (i % 2 == 0) == first_on
        profiling.reset()
        profiling.record(on)
        got = 0
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW_MARK):
                ts = time.perf_counter()
                while got < want:
                    y, cb, cr = (p.copy() for p in pool[pos(w0 + k)])
                    got += pictures_in(enc.encode_frame(y, cb, cr))
                    k += 1
                if on_card:
                    torch.cuda.synchronize()
                seg_s = time.perf_counter() - ts
        profiling.record(False)
        row = {"workload": workload, "seed": seed, "segment": i,
               "recording": on, "pictures": got, "seconds": seg_s,
               "ms_per_picture": 1e3 * seg_s / got}
        if on:
            row.update(split_segment(prof, got, seg_s))
        rows.append(row)
        print(json.dumps({n: v for n, v in row.items()
                          if n not in ("by_span", "layers", "idle_by_span",
                                       "idle_gaps")}), file=sys.stderr,
              flush=True)
    profiling.reset()
    return {"lead_s": lead_s, "rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--lead", type=int, default=40)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--pictures", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default=None, help="WxH (a rehearsal)")
    ap.add_argument("--out", required=True, help="JSON lines, appended")
    a = ap.parse_args(argv)
    size = tuple(int(v) for v in a.size.split("x")) if a.size else None
    if a.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    out = a.out
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    seeds = [int(s) for s in a.seeds.split(",")]
    summary = defaultdict(list)
    with open(out, "a") as f:
        for j, seed in enumerate(seeds):
            res = run_seed(a.workload, seed, a.lead, a.pairs, a.pictures,
                           a.device, size, first_on=(j % 2 == 0))
            for row in res["rows"]:
                f.write(json.dumps(row) + "\n")
                key = "on" if row["recording"] else "off"
                summary[f"ms_per_picture_{key}"].append(
                    row["ms_per_picture"])
                if row["recording"]:
                    for n in ("launch_ms_per_frame", "host_wait_ms_per_frame",
                              "copy_ms_per_frame",
                              "loopfilter_host_ms_per_frame",
                              "rd_host_ms_per_frame", "twin_err_ms",
                              "unattributed_ms_per_frame",
                              "ratecontrol_ms_per_frame",
                              "vbv_reencodes_per_frame",
                              "unattributed_idle_share",
                              "device_idle_share"):
                        summary[n].append(row[n])
                    for r, v in row["rd_won_share"].items():
                        summary[r + ".won_share"].append(v)
    dev = (torch.cuda.get_device_name(0) if a.device == "cuda" else "cpu")
    print(json.dumps({"workload": a.workload, "device": dev, "seeds": seeds,
                      "medians": {n: statistics.median(v)
                                  for n, v in summary.items()
                                  if None not in v},
                      "values": dict(summary)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
