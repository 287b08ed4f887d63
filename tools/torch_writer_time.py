"""Where the writer's time goes, walk by walk: encode a benchmark cell's
pictures and time every `native.encode_slice_px` call (the wrapper) and
the C call inside it, by walk (1: the first walk, which reconstructs; 2:
SAO's emit-only replay, which carries the SAO parameters) and by slice
type, beside the `finalize` span a picture.

    python3 tools/torch_writer_time.py --workload medium_1080p.crowd \
        --pictures 40 --seed 1
    python3 tools/torch_writer_time.py --workload live_1080p.cuts \
        --device cpu --size 960x544 --pictures 16

Prints one JSON line: per walk and slice type the calls, the wrapper's and
the C call's milliseconds (mean over calls), and the writer's
milliseconds a coded picture (the `finalize` span). Host times: under
CUDA the other stages run too, unsynchronised, as in an encode."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="medium_1080p.crowd")
    ap.add_argument("--pictures", type=int, default=40)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default=None, help="WxH (default: the cell's)")
    a = ap.parse_args()

    from encbench import frames, spec
    from x265_tpu_torch import native
    from x265_tpu_torch.api.encoder import Encoder
    from x265_tpu_torch.utils import profiling

    cell = spec.load_cell(a.workload)
    cfg, mix = cell["config_spec"], cell["traffic_spec"]
    W, H = ((int(v) for v in a.size.split("x")) if a.size
            else (cfg["width"], cfg["height"]))
    pool = frames.make_pool(mix, W, H, a.seed, cfg["bit_depth"])
    start = cell.get("window", {}).get("start", 0)
    order = frames.feed_order(mix, len(pool), a.pictures, start)
    lib = native.get_lib()
    c_call = lib.encode_slice_px
    t_c = [0.0]

    def timed_c(*args):
        t = time.perf_counter()
        try:
            return c_call(*args)
        finally:
            t_c[0] += time.perf_counter() - t
    lib.encode_slice_px = timed_c
    wrapper = native.encode_slice_px
    acc = defaultdict(lambda: [0, 0.0, 0.0])     # calls, wrapper s, C s

    def timed(*args, **kw):
        walk = 2 if kw.get("sao_params") is not None else 1
        c0 = t_c[0]
        t = time.perf_counter()
        try:
            return wrapper(*args, **kw)
        finally:
            e = acc[(walk, "BPI"[int(args[9])])]
            e[0] += 1
            e[1] += time.perf_counter() - t
            e[2] += t_c[0] - c0
    native.encode_slice_px = timed
    enc = Encoder(spec.params(cfg, W, H), device=a.device)
    enc.headers()
    profiling.reset()
    t0 = time.perf_counter()
    for k in order:
        y, cb, cr = (p.copy() for p in pool[k])
        enc.encode_frame(y, cb, cr)
    enc.flush()
    wall = time.perf_counter() - t0
    coded = len(enc.frame_stats)
    fin = profiling.report().get("finalize", {"seconds": 0.0})["seconds"]
    out = {"workload": a.workload, "size": f"{W}x{H}", "device": a.device,
           "pictures": coded, "wall_s": round(wall, 3),
           "writer_ms_per_frame": round(1e3 * fin / max(coded, 1), 3),
           "counters": {k: v for k, v in profiling.counters().items()
                        if k.startswith("writer.")},
           "walks": {f"{w}{t}": {"calls": n,
                                 "wrapper_ms": round(1e3 * s / n, 3),
                                 "c_ms": round(1e3 * c / n, 3)}
                     for (w, t), (n, s, c) in sorted(acc.items())}}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
