#!/usr/bin/env python3
"""Instructions per absolute difference of the SAD kernels, read from SASS.

    python3 tools/torch_sass_count.py [--out DIR]

Needs nvcc and cuobjdump (the CUDA toolkit); no device. Builds the port's
kernel library as the package does, disassembles it with `cuobjdump
-sass`, and prints one JSON object. For every instantiation of the kernels
of csrc/sad_sweep.cu it gives the instruction count, a histogram of the
opcodes that matter (vabsdiff4, vabsdiff, byte permutes, funnel shifts,
shared loads) and, for the byte path and the int16 path separately, the
instructions per absolute difference of the inner loop: the instructions
of the basic blocks that hold the SAD instructions, over the differences
those instructions make (4 a VABSDIFF4, 1 a VABSDIFF). With --out the
disassembly of each kernel is written there.
"""
import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from x265_tpu_torch.ops import cuda_build  # noqa: E402

KERNELS = ("sad_sweep_kernel", "sad_local_kernel")
SHOWN = ("VABSDIFF4", "VABSDIFF", "PRMT", "SHF", "LDS", "LDG", "STS", "IMAD",
         "IADD3", "LOP3", "BAR", "SHFL")
_INSN = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_]+)"
                   r"([.\w]*)\s")


def _functions(sass):
    """{mangled name: [lines]} of a cuobjdump -sass listing."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return out


def _blocks(lines):
    """Basic blocks: lists of opcodes, cut at labels and after branches."""
    blocks, cur = [], []
    for line in lines:
        if re.match(r"\s*\.L_", line):
            if cur:
                blocks.append(cur)
            cur = []
            continue
        m = _INSN.match(line)
        if not m:
            continue
        op = m.group(1)
        cur.append(op)
        if op in ("BRA", "EXIT", "RET", "BRX", "JMP"):
            blocks.append(cur)
            cur = []
    if cur:
        blocks.append(cur)
    return blocks


def _per_difference(blocks, op, per_insn):
    hot = [b for b in blocks if op in b]
    diffs = sum(b.count(op) for b in hot) * per_insn
    insns = sum(len(b) for b in hot)
    return {"instructions": insns, "differences": diffs,
            "instructions_per_difference": insns / diffs if diffs else None}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    cuda_build.get_lib()
    exe = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    sass = subprocess.run([exe, "-sass", cuda_build.LIBRARY],
                          capture_output=True, text=True, check=True).stdout
    report = {}
    for name, lines in _functions(sass).items():
        if not any(k in name for k in KERNELS):
            continue
        blocks = _blocks(lines)
        hist = collections.Counter(op for b in blocks for op in b)
        short = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?(\d+sad_)", r"\1", name)[:60]
        report[short] = {
            "instructions": sum(hist.values()),
            "opcodes": {k: hist[k] for k in SHOWN if hist[k]},
            "byte_path": _per_difference(blocks, "VABSDIFF4", 4),
            "int16_path": _per_difference(blocks, "VABSDIFF", 1),
        }
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, short + ".sass"), "w") as f:
                f.write("\n".join(lines))
    if not report:
        sys.exit("torch_sass_count: no SAD kernel found in the disassembly")
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
