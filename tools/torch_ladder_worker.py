#!/usr/bin/env python3
"""One process of an ABR ladder sharded over several processes (the
PyTorch port's counterpart of tools/ladder_worker.py; x265 abrEncApp's
one-process-per-host analog, BASELINE.json config 5).

Every process runs this same script with its own --proc-id. They join
one torch.distributed process group (the gloo backend: the renditions are
independent, so the group carries only identity and a barrier), build the
same seeded source themselves (no pixels cross processes), encode the
renditions api/ladder.renditions_for_process gives their rank
(round-robin) and write each as r{i}.hevc into --out.

Usage, two processes on one machine (and one card):
  python3 tools/torch_ladder_worker.py --coordinator 127.0.0.1:PORT \\
      --procs 2 --proc-id 0 --out ladder/ [--ladder config5|golden] \\
      [--frames N] [--device cpu]
  python3 tools/torch_ladder_worker.py --coordinator 127.0.0.1:PORT \\
      --procs 2 --proc-id 1 --out ladder/ ...

--ladder golden: the two-rendition golden ladder of utils/testclip
(GOLDEN_LADDER_SOURCE, 192x128 and 96x64; each stream's SHA-256 is in
utils/golden_streams.json). --ladder config5 (the default): 11 frames of
testclip.clip_crowd1080 at 3840x2160, seed 40, into 3840x2160 at 12000
kbps, 1920x1080 at 4000 and 1280x720 at 2400, each x265's medium under
ABR at 25 fps. The device defaults to CUDA. Prints one JSON line: the
rank, the renditions it encoded with each one's seconds (its scaling and
its encoder calls) and bytes, the process's wall time from the first
picture (which every process starts after a barrier) to the last flush,
and its kernel launches.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# (width, height, kbps) of BASELINE config 5's renditions, from a
# 3840x2160 source: area ratio 2 for 1080p, the polyphase 1/3 for 720p
CONFIG5_SOURCE = (3840, 2160, 11, 40)       # width, height, frames, seed
CONFIG5 = ((3840, 2160, 12000), (1920, 1080, 4000), (1280, 720, 2400))


def ladder_spec(name, frames=0):
    """(source frames, source size, renditions as (w, h, kbps)); the
    frames are built here, before any encode is timed."""
    from x265_tpu_torch.utils import testclip
    if name == "golden":
        w, h, n, seed = testclip.GOLDEN_LADDER_SOURCE
        n = frames or n
        return (list(testclip.make_clip(w, h, n, seed)), (w, h),
                list(testclip.GOLDEN_LADDER.values()))
    w, h, n, seed = CONFIG5_SOURCE
    n = frames or n
    return (list(testclip.clip_crowd1080(w, h, n, seed=seed)), (w, h),
            list(CONFIG5))


def encode_shard(frames, size, rends, rank, world, device=None,
                 start=None):
    """AbrLadder's shard of this rank, each rendition timed on its own;
    start, when given, is called once the encoders exist, just before the
    first picture (the processes' barrier). Returns ({rendition: stream},
    {rendition: seconds}, wall seconds, the AbrLadder)."""
    import torch
    from x265_tpu_torch.api import ladder

    lad = ladder.AbrLadder(size[0], size[1],
                           [ladder.Rendition(*r) for r in rends],
                           process_index=rank, process_count=world,
                           device=device)
    on_card = lad.encoders and next(iter(
        lad.encoders.values())).device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()
    secs = dict.fromkeys(lad.encoders, 0.0)
    for i, enc in lad.encoders.items():
        for name in ("encode_frame", "flush"):
            def timed(*a, _f=getattr(enc, name), _i=i, **kw):
                t = time.time()
                out = _f(*a, **kw)
                sync()
                secs[_i] += time.time() - t
                return out
            setattr(enc, name, timed)
    heights = [r[1] for r in rends]
    scale = ladder.scale_frame

    def timed_scale(frame, oh, ow, device=None):
        t = time.time()
        out = scale(frame, oh, ow, device=device)
        sync()
        secs[heights.index(oh)] += time.time() - t
        return out
    ladder.scale_frame = timed_scale
    try:
        sync()
        if start is not None:
            start()
        t0 = time.time()
        for f in frames:
            lad.push(f)
        out = lad.finish()
        sync()
        wall = time.time() - t0
    finally:
        ladder.scale_frame = scale
    return out, secs, wall, lad


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True, help="host:port")
    ap.add_argument("--procs", type=int, required=True)
    ap.add_argument("--proc-id", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=0,
                    help="source frames (0: the ladder's own count)")
    ap.add_argument("--ladder", choices=("config5", "golden"),
                    default="config5")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args()

    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://{args.coordinator}",
                            rank=args.proc_id, world_size=args.procs)
    rank, world = dist.get_rank(), dist.get_world_size()
    assert rank == args.proc_id and world == args.procs, (rank, world)
    try:
        # the same seed on every process: each builds the same source
        frames, size, rends = ladder_spec(args.ladder, args.frames)
        # every process starts its first picture together
        out, secs, wall, _ = encode_shard(frames, size, rends, rank, world,
                                          device=args.device,
                                          start=dist.barrier)
        os.makedirs(args.out, exist_ok=True)
        for i, stream in out.items():
            with open(os.path.join(args.out, f"r{i}.hevc"), "wb") as f:
                f.write(stream)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    from x265_tpu_torch.ops.cuda_mc import launches
    print(json.dumps({
        "rank": rank, "world": world, "wall_seconds": wall,
        "launches": dict(launches),
        "renditions": {str(i): {"size": f"{rends[i][0]}x{rends[i][1]}",
                                "seconds": secs[i], "bytes": len(out[i])}
                       for i in sorted(out)}}), flush=True)


if __name__ == "__main__":
    main()
