"""The readings a cell's ``analysis_gap`` limit is set from, in one process:
sound runs of the port over many seeds (the lower reading is their
largest), and the control, the port with its matmuls in TF32 (the
precision below the float32 its configuration states; the upper reading
is the control's smallest). Each is a whole run but for its length.

    python -m encbench.calibrate --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 6

Prints one JSON line a run and a summary line. Needs the card.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from encbench.run import run_cell


def reading(workload, seed, seconds, tf32):
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        r = run_cell(workload, seed, seconds, 0, check_pictures=1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    c = {k: v["value"] for k, v in r["checks"].items()}
    print(json.dumps({"workload": workload, "seed": seed,
                      "control": tf32, "checks": c,
                      "correct": r["correct"]}), flush=True)
    return c["analysis_gap"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    import x265_tpu_torch  # noqa: F401  (sets TF32 off, as a run has it)
    sound = [reading(a.workload, int(s), a.seconds, False)
             for s in a.seeds.split(",")]
    ctrl = [reading(a.workload, int(s), a.seconds, True)
            for s in a.control_seeds.split(",")]
    print(json.dumps({"workload": a.workload, "lower": max(sound),
                      "upper": min(ctrl), "sound": sound,
                      "control": ctrl}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
