#!/usr/bin/env python3
"""Times the deblocking boundary strengths at a picture's 4x4 grid.

    python3 tools/torch_deblock_bs_time.py [--h4 270] [--w4 480] [--reps 20]

Needs a CUDA device. On the random maps of tests/deblock_bs_cases.py,
which reach every branch of the derivation, it prints one JSON object
with:
- kernel_ms: ops.cuda_kernels.deblock_bs (csrc/deblock_bs.cu), CUDA events
  over --reps launches queued behind a spin of the device, after a
  warm-up, inputs hot in L2;
- bound_ms: its bytes (17 in and 8 out a block) over 3.35 TB/s;
- plain_ms: the plain PyTorch version on the card, timed the same way;
- derive_bs_ms: hevc.deblock.derive_bs on the host, both directions (what
  the loop filter ran before the kernel);
- host_ms / host_sync_ms: models.loopfilter._boundary_strengths on the
  host's clock (the flag packing, the narrowing into page-locked memory,
  the copy and the launch: what the span lf.bs covers), without and with
  a synchronise after it;
- max_abs_err of the kernel against derive_bs;
with the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from deblock_bs_cases import random_maps  # noqa: E402
from x265_tpu_torch.hevc.deblock import DeblockState, derive_bs  # noqa: E402
from x265_tpu_torch.models import loopfilter  # noqa: E402
from x265_tpu_torch.ops import cuda_kernels  # noqa: E402

HBM_BYTES_PER_S = 3.35e12


def cuda_ms(fn, reps):
    """Device ms a call: the launches are queued behind a spin of the
    device, so they run back to back whatever the host's enqueue costs."""
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(20_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def host_ms(fn, reps, sync):
    """Median host-clock ms a call."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        if sync:
            torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return float(np.median(ts))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--h4", type=int, default=270)
    ap.add_argument("--w4", type=int, default=480)
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_deblock_bs_time: no CUDA device")
    dev = torch.device("cuda")
    h4, w4 = a.h4, a.w4
    edge_v, edge_h, intra, cbf, mv4, refpoc4 = random_maps(
        np.random.default_rng(7), h4, w4)
    flags = torch.from_numpy(cuda_kernels.deblock_bs_flags(
        edge_v, edge_h, intra, cbf)).to(dev)
    mv = torch.from_numpy(mv4.astype(np.int16)).to(dev)
    poc = torch.from_numpy(refpoc4.astype(np.int32)).to(dev)
    got = cuda_kernels.deblock_bs(flags, mv, poc)
    want = [derive_bs(e, intra, cbf, mv4, refpoc4, vertical=v)
            for e, v in ((edge_v, True), (edge_h, False))]
    err = max(int(np.abs(g.cpu().numpy() - w).max())
              for g, w in zip(got, want))
    st = DeblockState(4 * h4, 4 * w4)
    st.edge_v, st.edge_h, st.cbf4 = edge_v, edge_h, cbf
    t0 = time.perf_counter()
    for _ in range(3):
        for e, v in ((edge_v, True), (edge_h, False)):
            derive_bs(e, intra, cbf, mv4, refpoc4, vertical=v)
    derive = (time.perf_counter() - t0) * 1e3 / 3
    n = h4 * w4
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()

    def packed():
        return loopfilter._boundary_strengths(st, intra, mv4, refpoc4, dev)

    print(json.dumps({
        "shape": f"[{h4}, {w4}]", "card": card[0] if card else None,
        "kernel_ms": cuda_ms(lambda: cuda_kernels.deblock_bs(flags, mv, poc),
                             a.reps),
        "bound_ms": 25 * n / HBM_BYTES_PER_S * 1e3,
        "plain_ms": cuda_ms(
            lambda: cuda_kernels.deblock_bs_plain(flags, mv, poc), a.reps),
        "derive_bs_ms": derive,
        "host_ms": host_ms(packed, a.reps, sync=False),
        "host_sync_ms": host_ms(packed, a.reps, sync=True),
        "max_abs_err": err,
        "strengths": {int(k): int(c) for k, c in zip(*np.unique(
            np.concatenate([w.ravel() for w in want]), return_counts=True))},
    }), flush=True)


if __name__ == "__main__":
    main()
