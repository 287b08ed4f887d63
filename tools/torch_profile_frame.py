#!/usr/bin/env python3
"""Where one 1080p P frame (or one mini-GOP, or one chunk of the
all-intra path) of the PyTorch/CUDA port spends its time.

    python3 tools/torch_profile_frame.py
        [--config ultrafast|filtered|live|medium|slow|lossless|main10|slices]
        [--frames N] [--out trace.json]

Needs a CUDA device. Encodes a seeded clip in one of the configurations
chip_smoke.py drives (at 1920x1080: ultrafast + zerolatency; the
filtered fast + zerolatency with its brightness ramp; the live medium +
zerolatency under CRF 23 and a 6000 kbps VBV buffer, on the scene-cut
clip with the cut at frame 4, so the last frame is a P frame of the new
scene; x265's default medium at 4000 kbps ABR, bench.py's config 3, on
its clip_crowd1080; the slow preset under the same rate control; config
3 in four slices a picture with transform skip (slices: SAO's second pass
recomputes every TB, as transform skip demands, in place of replaying
the first pass's levels); at
1280x720 bench.py's config 1, all-intra lossless on its pan; at
3840x2160 BASELINE config 4, the slow preset at Main10 with scaling
lists and the HDR10/HDR10+ metadata on the crowd clip lifted to 10
bits), lets the
first frames warm everything up, then traces with torch.profiler the
LAST P frame or, for medium, slow, main10 and slices, the second
mini-GOP: the flush_step call that codes one P anchor and the B pictures
before it (frames default 6, and 11 for those four: the I picture and
ten
queued pictures, two or more mini-GOPs); for lossless, one chunk of the
pipelined path (Encoder.encode of 8 frames, after another encoder's
encode of the same frames as warm-up), with no stage synchronising, so
that the analysis overlaps the writer as in an encode and the stage
times are host time. Prints one JSON object:
the wall time, the device's busy time and idle share inside it, the
per-stage seconds (and the lookahead's share of the wall time), the
device time of the hand-written kernels, and the kernels that took most
of the device's time; beside them the warm-up's stage seconds (each stage
ending in a synchronise) and the kernel launches it made (for medium and
slow the warm-up holds the slice-type search's pair pass). With --out it
also writes the Chrome trace.
"""
import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402  (exits when there is no CUDA device)
from x265_tpu_torch.api.encoder import Encoder  # noqa: E402
from x265_tpu_torch.ops import cuda_build, cuda_mc  # noqa: E402
from x265_tpu_torch.utils import profiling  # noqa: E402

# name fragments of the hand-written kernels; the three tile_gather kernels
# (n a power of two, staged, rows) count as one, the fused gather + SATD
# and the window search under their own names
OURS = ("mc_gather_kernel", "tile_gather_", "gather_satd_kernel",
        "satd8_kernel", "sad_sweep_kernel", "sad_local_kernel")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config",
                    choices=("ultrafast", "filtered", "live", "medium",
                             "slow", "lossless", "main10", "slices"),
                    default="ultrafast")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    card = chip_smoke.smi()
    W, H = chip_smoke.W, chip_smoke.H
    n = args.frames or {"medium": 11, "slow": 11, "main10": 11,
                        "slices": 11, "lossless": 8}.get(args.config, 6)
    tmp = tempfile.TemporaryDirectory()          # the HDR10+ metadata
    if args.config == "filtered":
        frames = chip_smoke.make_ramp_clip(W, H, n, seed=11,
                                           step=0.05)
        enc = Encoder(chip_smoke.filtered_params(W, H))
    elif args.config == "live":
        frames = chip_smoke.make_cut_clip(W, H, n, seed=11,
                                          cut=4)
        enc = Encoder(chip_smoke.live_params(W, H))
    elif args.config in ("medium", "slow", "slices"):
        frames = list(chip_smoke.clip_crowd1080(W, H, n, seed=40))
        params = {"medium": chip_smoke.medium_params,
                  "slow": chip_smoke.slow_params,
                  "slices": chip_smoke.steered_params(
                      {"slices": "4", "tskip": "1"})}[args.config]
        enc = Encoder(params(W, H))
    elif args.config == "main10":
        W, H = chip_smoke.W4K, chip_smoke.H4K
        frames = chip_smoke.lift10(
            chip_smoke.clip_crowd1080(W, H, n, seed=40), 40)
        meta = chip_smoke.testclip.write_dhdr10_json(
            os.path.join(tmp.name, "hdr10plus.json"), n)
        enc = Encoder(chip_smoke.main10_params(W, H, meta))
    elif args.config == "lossless":
        W, H = 1280, 720
        frames = list(chip_smoke.clip_pan(W, H, n, seed=10))
        Encoder(chip_smoke.lossless_params(W, H)).encode(frames)
        enc = Encoder(chip_smoke.lossless_params(W, H))
    else:
        frames = chip_smoke.make_clip(W, H, n, seed=11)
        enc = Encoder(chip_smoke.slice_params(W, H))
    cuda_build.get_lib()            # the build is no part of the warm-up
    profiling.reset()
    profiling.set_sync(args.config != "lossless")
    cuda_mc.reset_launches()
    t_warm = time.perf_counter()
    if args.config == "lossless":
        step = lambda: enc.encode(frames)  # noqa: E731
    elif args.config in ("medium", "slow", "main10", "slices"):
        enc.headers()
        # the I picture codes at once, the rest queue (b-adapt's window is
        # rc-lookahead frames); the first mini-GOP warms up the B path
        for f in frames:
            enc.encode_frame(*f)
        enc.flush_step()
        step = enc.flush_step
    else:
        enc.headers()
        for f in frames[:-1]:
            enc.encode_frame(*f)
        step = lambda: enc.encode_frame(*frames[-1])  # noqa: E731
    torch.cuda.synchronize()
    warmup = {"seconds": time.perf_counter() - t_warm,
              "stage_ms": {k: v["seconds"] * 1e3
                           for k, v in profiling.report().items()},
              "launches": dict(cuda_mc.launches)}
    profiling.reset()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        done = len(enc.frame_stats)
        au = step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    profiling.set_sync(False)
    rows = []
    stage_names = set(profiling.report())
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0)
        on_device = str(getattr(e, "device_type", "")).endswith("CUDA")
        # the stage scopes also appear on the device timeline, as ranges
        # that span their kernels: they are not kernels and not busy time
        if on_device and dev_us > 0 and e.key not in stage_names:
            rows.append((e.key, dev_us / 1e3, e.count))
    spans = {e.key: getattr(e, "self_device_time_total", 0) / 1e3
             for e in prof.key_averages()
             if e.key in stage_names
             and str(getattr(e, "device_type", "")).endswith("CUDA")}
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    stage_ms = {k: v["seconds"] * 1e3
                for k, v in profiling.report().items()}
    out = {
        "card": card, "config": args.config, "frame_bytes": len(au),
        "frame_type": "".join(st["type"] for st in enc.frame_stats[done:]),
        "frame_pocs": [st["poc"] for st in enc.frame_stats[done:]],
        "frame_wall_ms": wall * 1e3, "stage_ms": stage_ms,
        "slowest_stage": max(stage_ms, key=stage_ms.get, default=None),
        "lookahead_share_of_wall": stage_ms.get("lookahead", 0.0)
        / (wall * 1e3), "warmup": warmup,
    }
    if rows:
        ours = {k: sum(r[1] for r in rows if k in r[0]) for k in OURS}
        out.update({
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
            "device_kernel_launches": sum(r[2] for r in rows),
            "device_span_ms_by_stage": spans,
            "hand_written_kernels_ms": ours,
            "hand_written_share_of_busy": sum(ours.values()) / busy_ms,
            "top_kernels": [{"name": r[0][:90], "ms": r[1], "calls": r[2]}
                            for r in rows[:15]],
        })
    else:
        out["device_busy_ms"] = "not measured (the profiler saw no kernels)"
    out["frame_size"] = [W, H]
    tmp.cleanup()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        prof.export_chrome_trace(args.out)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
