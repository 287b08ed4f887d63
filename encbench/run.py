"""One run of one benchmark cell of the port (x265_tpu_torch) on the card.

    python -m encbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's pictures from the seed, builds the port's kernels
and writer (into the port's build/ directory, inside the checkout), and
warms every shape up with an encoder of its own. The window then drives a
fresh ``Encoder`` through what the port's CLI calls: ``headers()`` and
``encode_frame(y, cb, cr)`` a picture, fed by the mix's feed
(``feeds/<loop>.py``; the closed loop hands each picture over as soon as
the previous call returned), for ``--seconds``. With ``--trace 1`` every
stage scope ends in a device synchronise and, after the window, the
profiler traces a further segment of the same stream. Then the window's
stream is checked against the plain reference (encbench/check.py) and the
last line of standard output is the result, as JSON.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import inspect  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from encbench import check, frames, guard, spec, stream  # noqa: E402

E2E_DEFAULT = ("fps", "frame_ms_p90", "psnr_y_db", "kbps", "setup_s")
E2E_UNITS = {"fps": "frames/s", "frame_ms_p90": "ms", "psnr_y_db": "dB",
             "kbps": "kbit/s", "setup_s": "s"}


def log(msg):
    print(f"encbench: {msg}", file=sys.stderr, flush=True)


def machine_line(torch):
    smi = "not read"
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        smi = r.stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.TimeoutExpired):
        pass
    log(f"machine: {smi}; host cpus {os.cpu_count()}, torch threads "
        f"{torch.get_num_threads()}, torch {torch.__version__}, cuda "
        f"{torch.version.cuda}")


class AnalysisSampler:
    """A reservoir of `size` intra analyses of the window, drawn from the
    seed: wraps the port's two analysis entry points, and notes for each
    handed-over luma plane the display index it came with."""

    ENTRIES = ("submit_intra_analysis", "submit_intra_analysis_batch")

    def __init__(self, size, seed):
        self.size = size
        self.rng = np.random.default_rng([seed, 0x5A3])
        self.display_of = {}
        self.seen = 0
        self.kept = []
        self.foreign = 0
        self._patched = []

    def install(self):
        mod = sys.modules["x265_tpu_torch.models.intra_frame"]
        for name in self.ENTRIES:
            orig = getattr(mod, name)
            sig = inspect.signature(orig)
            wrapper = self._wrap(orig, sig, name.endswith("batch"))
            for m in list(sys.modules.values()):
                if getattr(m, "__name__", "").startswith("x265_tpu_torch"):
                    for k, v in list(vars(m).items()):
                        if v is orig:
                            setattr(m, k, wrapper)
                            self._patched.append((m, k, orig))

    def restore(self):
        for m, k, orig in reversed(self._patched):
            setattr(m, k, orig)
        self._patched.clear()

    def _wrap(self, orig, sig, batch):
        def entry(*args, **kwargs):
            out = orig(*args, **kwargs)
            b = sig.bind(*args, **kwargs)
            b.apply_defaults()
            a = b.arguments
            srcs = a["srcs"] if batch else [a["src_y"]]
            handles = out if batch else [out]
            for src, h in zip(srcs, handles):
                self._offer(src, h, a["fast"], a["psy"])
            return out
        return entry

    def _offer(self, src, handle, fast, psy):
        d = self.display_of.get(id(src))
        if d is None or d[1] is not src:
            self.foreign += 1
            return
        item = (d[0], handle[0], handle[1], 1 << handle[2], bool(fast),
                float(psy))
        if len(self.kept) < self.size:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.kept[j] = item
        self.seen += 1


class ReconKeeper:
    """Encoder.recon_sink for the first `count` pictures in coding order;
    a picture coded again under the VBV reports again and the last report
    is the one in the stream. Unsets itself on the next picture."""

    def __init__(self, enc, count):
        self.enc, self.count, self.order, self.planes = enc, count, [], {}

    def __call__(self, idx, planes):
        if idx not in self.planes and len(self.order) == self.count:
            self.enc.recon_sink = None
            return
        if idx not in self.planes:
            self.order.append(idx)
        self.planes[idx] = tuple(np.array(p, copy=True) for p in planes)


def pictures_in(chunk: bytes) -> int:
    return sum(1 for _b, _e, t, pl in stream.nal_units(chunk)
               if t < 32 and len(pl) > 2 and pl[2] & 0x80)


def percentile(values, q):
    """Nearest-rank percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def traced_segment(enc, pool, order, k, want):
    """Feed pictures k, k+1, ... of the stream under the profiler, with
    every hand-written kernel launch's bound recorded, until `want`
    pictures came out; returns (the trace's readings, the next k)."""
    import torch
    from encbench.trace import (WINDOW_MARK, LaunchRecorder, profiler,
                                read_profile)
    from x265_tpu_torch.utils import profiling
    rec = LaunchRecorder()
    rec.install()
    got = 0
    profiling.reset()
    with profiler() as prof:
        with torch.profiler.record_function(WINDOW_MARK):
            rec.active = True
            ts = time.perf_counter()
            while got < want:
                y, cb, cr = (p.copy() for p in pool[order(k)])
                got += pictures_in(enc.encode_frame(y, cb, cr))
                k += 1
            torch.cuda.synchronize()
            seg_s = time.perf_counter() - ts
            rec.active = False
    rec.restore()
    t = time.perf_counter()
    tr = read_profile(prof, got, set(profiling.report()))
    tr["bound_s"] = sum(rec.bound_s.values())
    tr["launches_by_entry"] = dict(rec.launches)
    log("trace: " + json.dumps({n: v for n, v in tr.items()
                                if n not in ("device_ops", "idle_gaps")}))
    log(f"traced segment: {got} pictures in {seg_s:.3f} s, read in "
        f"{time.perf_counter() - t:.3f} s")
    return tr, k


def run_cell(workload, seed, seconds, trace, device="cuda", size=None,
             check_pictures=None):
    """Set-up, window, traced segment, check; returns the result dict
    (the last line's object) and prints the check lines on stderr."""
    import torch
    from x265_tpu_torch.api.encoder import Encoder
    from x265_tpu_torch.ops import cuda_build
    from x265_tpu_torch.utils import devcache, profiling
    from x265_tpu_torch import native

    cell = spec.load_cell(workload)
    cfg, mix = cell["config_spec"], cell["traffic_spec"]
    W, H = size or (cfg["width"], cfg["height"])
    K = check_pictures or cell["check"]["pictures"]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        machine_line(torch)

    t = time.perf_counter()
    built = []
    if on_card:
        cuda_build.get_lib()
        native.get_lib()
        if cuda_build.build_seconds is not None:
            built.append(f"kernels {cuda_build.build_seconds:.1f} s")
    compile_s = time.perf_counter() - t
    t = time.perf_counter()
    pool = frames.make_pool(mix, W, H, seed, cfg["bit_depth"])

    def pos(s):
        """The pool index at position s of the mix's order."""
        return frames.feed_order(mix, len(pool), 1, s)[0]

    w0 = cell.get("window", {}).get("start", 0)

    def order(k):
        """The pool index of the window's picture k."""
        return pos(w0 + k)
    frames_s = time.perf_counter() - t
    params = spec.params(cfg, W, H)

    # warm-up: an encoder of its own over the cell's own shapes
    t = time.perf_counter()
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
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
    warm_s = time.perf_counter() - t

    enc = Encoder(params, device=device)
    keeper = ReconKeeper(enc, K)
    enc.recon_sink = keeper
    sampler = AnalysisSampler(cell["check"]["analysis_sample"], seed)
    sampler.install()
    setup_s = time.perf_counter() - T_START
    log(f"set-up {setup_s:.3f} s: compile {compile_s:.3f} s"
        f"{' (built: ' + ', '.join(built) + ')' if built else ' (nothing built)'}"
        f", frames {frames_s:.3f} s ({len(pool)} pictures), warm-up "
        f"{warm_s:.3f} s ({fed} pictures in, {aus} out)")

    # the window
    if trace:
        profiling.set_sync(True)
    profiling.reset()
    header = enc.headers()

    def picture(k):
        y, cb, cr = (p.copy() for p in pool[order(k)])
        sampler.display_of[id(y)] = (k, y)
        return y, cb, cr
    win = frames.feed(mix)(enc, picture, seconds)
    chunks, submit_t, return_t = (win[n] for n in
                                  ("chunks", "submit_t", "return_t"))
    window_s, k = win["window_s"], len(chunks)
    stages = {s: v["seconds"] for s, v in profiling.report().items()}
    profiling.set_sync(False)
    sampler.restore()

    # the traced segment: the same stream, the profiler on, no synchronise
    tr = None
    if trace and on_card:
        tr, k = traced_segment(enc, pool, order, k,
                               cell["trace"]["pictures"])

    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    found = guard.loaded_forbidden()

    # the check, the program's state freed first
    samples = [(d, m.cpu().numpy(), c.cpu().numpy(), S, f, p)
               for d, m, c, S, f, p in sampler.kept]
    recon = keeper.planes
    del enc, keeper, sampler
    devcache.clear()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    aus_ = stream.split_access_units(chunks)
    read, unparsed = check.read_headers(header, aus_, k)
    sources = {}
    for au, info in read[:K]:
        if info is not None:
            sources[info["display"]] = pool[order(info["display"])][0]
    mismatch, psnr_y = check.decode_first(header, read, recon, sources,
                                          params.bit_depth, K)
    n_rate = cell["check"]["rate_pictures"]
    if len(aus_) < n_rate:
        log(f"kbps over {len(aus_)} pictures: the window coded fewer than "
            f"{n_rate}")
    gap = check.analysis_gap(
        [(pool[order(d)][0], m, c, S, f, p) for d, m, c, S, f, p in samples],
        cfg["analysis"], device)
    if not samples:
        gap = float("inf")
    limits = cell["limits"]
    vbv = None
    if "vbv_underflows" in limits:
        o = cfg["options"]
        sizes = [len(au.data) for au in aus_]
        if sizes:
            sizes[0] += len(header)
        vbv = check.vbv_underflows(sizes, o["vbv-maxrate"], o["vbv-bufsize"],
                                   o["vbv-init"], cfg["fps"])
    check_s = time.perf_counter() - t

    lat = [return_t[au.call] - submit_t[info["display"]]
           for au, info in read if info is not None]
    e2e = {"fps": len(aus_) / window_s,
           "frame_ms_p90": 1e3 * percentile(lat, 90) if lat else None,
           "psnr_y_db": psnr_y,
           "kbps": check.kbps(aus_, cfg["fps"], n_rate), "setup_s": setup_s}
    checks = {"unparsed_aus": (unparsed, limits["unparsed_aus"]),
              "recon_mismatch": (mismatch, limits["recon_mismatch"]),
              "analysis_gap": (gap, limits["analysis_gap"])}
    if vbv is not None:
        checks["vbv_underflows"] = (vbv, limits["vbv_underflows"])
    correct = all(v <= lim for v, lim in checks.values()) and not found
    log(f"window {window_s:.3f} s: {k} pictures in, {len(aus_)} out; "
        f"{'traced, ' if trace else ''}fps {e2e['fps']:.4f}; stages "
        + json.dumps({s: round(v, 4) for s, v in stages.items()}))
    log(f"check {check_s:.3f} s: {len(read[:K])} pictures decoded, "
        f"{len(samples)} analyses recomputed (pictures "
        f"{','.join(str(x[0]) for x in samples)}), "
        f"memory peak {memory_peak} bytes")
    if found:
        log(f"forbidden modules loaded: {found}")

    if trace:
        record = {"pictures": len(aus_), "stages": stages, "trace": tr}
        names = spec.metric_names(workload, "per_layer", spec.all_readers())
        units = spec.units("per_layer")
        metrics = {}
        for n in names:
            v = spec.reader(n)(record)
            if v is None:
                log(f"per-layer metric {n}: nothing to read")
                continue
            metrics[n] = {"value": v, "unit": units.get(n, "")}
    else:
        names = spec.metric_names(workload, "end_to_end", E2E_DEFAULT)
        metrics = {n: {"value": e2e[n], "unit": E2E_UNITS[n]}
                   for n in names
                   if e2e.get(n) is not None and math.isfinite(e2e[n])}
    result = {"correct": bool(correct), "attempted": len(aus_),
              "failed": int(unparsed + mismatch), "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": (torch.cuda.get_device_name(0) if on_card
                                  else "cpu"),
                         "count": 1, "memory_peak_bytes": int(memory_peak)}}
    if tr is not None:
        result["device"]["busy_s"] = tr["busy_s"]
        result["device"]["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    # a gap that has no finite reading (no sample, or a departure from the
    # configuration) is written as 1e30: the line stays strict JSON
    result["checks"] = {n: {"value": v if math.isfinite(v) else 1e30,
                            "limit": lim}
                        for n, (v, lim) in checks.items()}
    for n, (v, lim) in checks.items():
        log(f"check {n} {v!r} limit {lim!r}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bad = guard.loaded_forbidden() + [f"{f}: {m}" for f, m in
                                      guard.reference_imports_port()]
    if bad:
        log(f"refusing to run: {bad}")
        return 3
    import torch
    need = spec.chips(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"needs {need} CUDA device(s), found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            "; no result")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, args.trace)
    found = guard.loaded_forbidden()
    if found:
        log(f"forbidden modules loaded by the run: {found}; no result")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
