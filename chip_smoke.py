#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc and g++; nothing else (no network, no JAX).
Builds every kernel from the sources in this checkout, holds each against
its plain PyTorch version on the card (exact equality: they are integer
kernels), encodes a small clip and decodes it back, then drives the main
path — the low-latency I/P encode at 1920x1080 through Encoder.encode —
and checks that it went through every kernel. One JSON line per phase;
any failure ends the run with a non-zero exit code and no result line.
"""
import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    sys.exit(1)

from x265_tpu_torch.api.encoder import Encoder
from x265_tpu_torch.api.params import param_default_preset, param_parse
from x265_tpu_torch.decoder.decoder import HEVCDecoder
from x265_tpu_torch.engine import me
from x265_tpu_torch.models import inter_residual
from x265_tpu_torch.ops import cuda_build, cuda_kernels, cuda_mc
from x265_tpu_torch.utils import devcache, profiling
from x265_tpu_torch.utils.convert import interp_filters
from x265_tpu_torch import native

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
INT_OPS_PER_S = 67e12          # non-tensor-core 32-bit rate, same sheet
W, H = 1920, 1080
FAR = [1 << 20, -(1 << 20), -1, 5]    # origins far outside a plane


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg):
    print("chip_smoke: FAILED: " + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def make_clip(w, h, n, seed):
    """Moving band-limited texture + noise, so motion is non-zero and
    residuals are not."""
    rng = np.random.default_rng(seed)
    m = 96
    big = rng.integers(0, 256, (h + m, w + m)).astype(np.float32)
    for _ in range(4):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
               + np.roll(big, -1, 0) + np.roll(big, -1, 1)) / 5.0
    big = np.clip((big - 128.0) * 4.0 + 128.0, 0, 255)
    frames = []
    for i in range(n):
        dy, dx = 16 + 2 * i, 16 + 5 * i
        y = big[dy:dy + h, dx:dx + w] + rng.normal(0, 1.5, (h, w))
        y = np.clip(np.rint(y), 0, 255).astype(np.uint8)
        cb = (y[::2, ::2] // 2 + 64).astype(np.uint8)
        cr = (255 - y[::2, ::2] // 2).astype(np.uint8)
        frames.append((y, cb, cr))
    return frames


def slice_params(w, h):
    p = param_default_preset("ultrafast", "zerolatency")
    for k, v in (("qp", "30"), ("scenecut", "0"), ("ref", "1")):
        param_parse(p, k, v)
    p.width, p.height = w, h
    return p


@contextlib.contextmanager
def plain_versions():
    """Rebind, for the duration, the names through which the engine
    reaches the kernels' wrappers to the plain versions, so a whole
    encode on the card can be held against the kernels' encode. The
    package itself has no such switch."""
    saved = (inter_residual.tile_gather, inter_residual.mc_gather_interp,
             me.tile_gather_planes, me._satd_kernel)
    inter_residual.tile_gather = cuda_mc.tile_gather_plain
    inter_residual.mc_gather_interp = cuda_mc.mc_gather_interp_plain
    me.tile_gather_planes = cuda_mc.tile_gather_planes_plain
    me._satd_kernel = cuda_kernels.satd_plain
    try:
        yield
    finally:
        (inter_residual.tile_gather, inter_residual.mc_gather_interp,
         me.tile_gather_planes, me._satd_kernel) = saved


def rnd_i32(rng, lo, hi, n):
    return torch.from_numpy(rng.integers(lo, hi, n).astype(np.int32)).to(DEV)


# ------------------------------------------------------------- kernel cases

def gather_bytes(plane_elems, N, side, out_elems, n_index_arrays):
    """Least traffic: the windows' int16s (or the whole plane when the
    windows cover more than it), the per-lane indices, the int32 output."""
    return (min(plane_elems, N * side * side) * 2
            + n_index_arrays * N * 4 + out_elems * 4)


def check_equal(name, got, want):
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: shape/dtype {got.shape}/{got.dtype} vs "
             f"{want.shape}/{want.dtype}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0
    if err != 0:
        fail(f"{name}: kernel differs from plain version, max abs {err}")
    return err


def kernel_phase():
    rng = np.random.default_rng(7)
    rows = {}
    luma, chroma = interp_filters(DEV)

    # --- mc_gather_interp: padded 1080p reference planes -----------------
    Hp, Wp = H + 160, W + 160
    planes_y = torch.from_numpy(
        rng.integers(0, 256, (2, Hp, Wp)).astype(np.int16)).to(DEV)
    planes_c = planes_y[:, :H // 2 + 80, :W // 2 + 80].contiguous()
    for (n, taps) in ((8, 8), (16, 8), (32, 8), (4, 4), (8, 4), (16, 4)):
        pl, filt = (planes_y, luma) if taps == 8 else (planes_c, chroma)
        R_, hp, wp = pl.shape
        side = n + taps - 1
        N = 1003                                   # not a multiple of 8
        ridx = rnd_i32(rng, 0, R_, N)
        oy = rnd_i32(rng, 0, hp - side + 1, N)
        ox = rnd_i32(rng, 0, wp - side + 1, N)
        oy[:4] = torch.tensor([0, hp - side, 0, hp - side], device=DEV)
        ox[:4] = torch.tensor([0, wp - side, wp - side, 0], device=DEV)
        oy[4:8] = torch.tensor(FAR, device=DEV)      # clipped, never read
        ox[4:8] = torch.tensor(FAR[::-1], device=DEV)
        ridx[8:10] = torch.tensor([-3, 99], device=DEV)
        nph = filt.shape[0]
        xf = (torch.arange(N, device=DEV, dtype=torch.int32) % nph)
        yf = (torch.arange(N, device=DEV, dtype=torch.int32) // nph) % nph
        a = (ridx, oy, ox, xf.contiguous(), yf.contiguous(), filt, n, taps, 8)
        check_equal(f"mc_gather_interp edge n={n} taps={taps}",
                    cuda_mc.mc_gather_interp(pl, *a),
                    cuda_mc.mc_gather_interp_plain(pl, *a))
    # main-path shape: every 16x16 luma CU of a 1080p P frame
    n, taps, side = 16, 8, 23
    N = (W // 16) * (H // 16)
    ridx = torch.zeros(N, dtype=torch.int32, device=DEV)
    oy = rnd_i32(rng, 0, Hp - side + 1, N)
    ox = rnd_i32(rng, 0, Wp - side + 1, N)
    xf = rnd_i32(rng, 0, 4, N)
    yf = rnd_i32(rng, 0, 4, N)
    a = (ridx, oy, ox, xf, yf, luma, n, taps, 8)
    nbytes = gather_bytes(Hp * Wp, N, side, N * n * n, 5) + luma.numel() * 4
    nops = N * 2 * taps * (side * n + n * n)
    err = check_equal("mc_gather_interp",
                      cuda_mc.mc_gather_interp(planes_y, *a),
                      cuda_mc.mc_gather_interp_plain(planes_y, *a))
    rows["mc_gather_interp"] = dict(
        shape=f"planes[2,{Hp},{Wp}] N={N} n=16 taps=8", max_abs_err=err,
        ms=time_ms(lambda: cuda_mc.mc_gather_interp(planes_y, *a)),
        plain_ms=time_ms(
            lambda: cuda_mc.mc_gather_interp_plain(planes_y, *a), 5),
        bytes=nbytes, ops=nops, library_ms=None)

    # --- tile_gather: 30x30 search patches of the integer refine --------
    R = 57
    Hr, Wr = 1088 + 2 * R, W + 2 * R
    plane = torch.from_numpy(
        rng.integers(0, 256, (Hr, Wr)).astype(np.int16)).to(DEV)
    for n in (4, 8, 16, 30, 32):
        N = 1003
        oy = rnd_i32(rng, 0, Hr - n + 1, N)
        ox = rnd_i32(rng, 0, Wr - n + 1, N)
        oy[:2] = torch.tensor([0, Hr - n], device=DEV)
        ox[:2] = torch.tensor([Wr - n, 0], device=DEV)
        oy[2:6] = torch.tensor(FAR, device=DEV)
        ox[2:6] = torch.tensor(FAR[::-1], device=DEV)
        check_equal(f"tile_gather edge n={n}",
                    cuda_mc.tile_gather(plane, oy, ox, n),
                    cuda_mc.tile_gather_plain(plane, oy, ox, n))
    n, N = 30, 68 * 120
    oy = rnd_i32(rng, 0, Hr - n + 1, N)
    ox = rnd_i32(rng, 0, Wr - n + 1, N)
    err = check_equal("tile_gather", cuda_mc.tile_gather(plane, oy, ox, n),
                      cuda_mc.tile_gather_plain(plane, oy, ox, n))
    idx = cuda_mc._window_index(oy, ox, n, Hr, Wr)
    flat = plane.reshape(-1)
    rows["tile_gather"] = dict(
        shape=f"plane[{Hr},{Wr}] N={N} n=30", max_abs_err=err,
        ms=time_ms(lambda: cuda_mc.tile_gather(plane, oy, ox, n)),
        plain_ms=time_ms(lambda: cuda_mc.tile_gather_plain(plane, oy, ox, n)),
        bytes=gather_bytes(Hr * Wr, N, n, N * n * n, 2), ops=0,
        library_ms=time_ms(lambda: torch.take(flat, idx)))

    # --- tile_gather_planes: one subpel refine round (9 candidates) ------
    margin = R + 2
    Hm, Wm = 1088 + 2 * margin, W + 2 * margin
    pp = torch.from_numpy(
        rng.integers(0, 256, (16, Hm, Wm)).astype(np.int16)).to(DEV)
    n, N = 16, 1003
    ridx = (torch.arange(N, device=DEV, dtype=torch.int32) % 16).contiguous()
    oy = rnd_i32(rng, 0, Hm - n + 1, N)
    ox = rnd_i32(rng, 0, Wm - n + 1, N)
    oy[:2] = torch.tensor([0, Hm - n], device=DEV)
    ox[:2] = torch.tensor([Wm - n, 0], device=DEV)
    oy[2:6] = torch.tensor(FAR, device=DEV)
    ox[2:6] = torch.tensor(FAR[::-1], device=DEV)
    ridx[6:8] = torch.tensor([-1, 16], device=DEV)
    check_equal("tile_gather_planes edge",
                cuda_mc.tile_gather_planes(pp, ridx, oy, ox, n),
                cuda_mc.tile_gather_planes_plain(pp, ridx, oy, ox, n))
    N = 9 * 68 * 120
    ridx = rnd_i32(rng, 0, 16, N)
    oy = rnd_i32(rng, 0, Hm - n + 1, N)
    ox = rnd_i32(rng, 0, Wm - n + 1, N)
    err = check_equal("tile_gather_planes",
                      cuda_mc.tile_gather_planes(pp, ridx, oy, ox, n),
                      cuda_mc.tile_gather_planes_plain(pp, ridx, oy, ox, n))
    idx = (cuda_mc._window_index(oy, ox, n, Hm, Wm)
           + ridx.long()[:, None, None] * (Hm * Wm))
    flat = pp.reshape(-1)
    rows["tile_gather_planes"] = dict(
        shape=f"planes[16,{Hm},{Wm}] N={N} n=16", max_abs_err=err,
        ms=time_ms(lambda: cuda_mc.tile_gather_planes(pp, ridx, oy, ox, n)),
        plain_ms=time_ms(
            lambda: cuda_mc.tile_gather_planes_plain(pp, ridx, oy, ox, n)),
        bytes=gather_bytes(16 * Hm * Wm, N, n, N * n * n, 3), ops=0,
        library_ms=time_ms(lambda: torch.take(flat, idx)))

    # --- satd: the same round's SATD -------------------------------------
    for S, N_ in ((8, 1003), (16, 1003), (32, 77)):
        a_ = rnd_i32(rng, 0, 256, N_ * S * S).reshape(N_, S, S)
        b_ = rnd_i32(rng, 0, 256, N_ * S * S).reshape(N_, S, S)
        check_equal(f"satd edge S={S}", cuda_kernels.satd(a_, b_),
                    cuda_kernels.satd_plain(a_, b_))
    S = 16
    a_ = rnd_i32(rng, 0, 256, N * S * S).reshape(N, S, S)
    b_ = rnd_i32(rng, 0, 256, N * S * S).reshape(N, S, S)
    err = check_equal("satd8x8", cuda_kernels.satd(a_, b_),
                      cuda_kernels.satd_plain(a_, b_))
    # per 8x8 block: 64 subtractions, 2*8*24 butterfly adds, 64 abs-adds
    rows["satd8x8"] = dict(
        shape=f"a,b[{N},16,16] int32", max_abs_err=err,
        ms=time_ms(lambda: cuda_kernels.satd(a_, b_)),
        plain_ms=time_ms(lambda: cuda_kernels.satd_plain(a_, b_), 5),
        bytes=2 * N * S * S * 4 + N * 4, ops=N * 4 * (64 + 384 + 64),
        library_ms=None)
    return rows


META = {
    "mc_gather_interp": ("x265_tpu_torch/csrc/mc_gather.cu",
                         "x265_tpu/ops/pallas_mc.py:121"),
    "tile_gather": ("x265_tpu_torch/csrc/tile_gather.cu",
                    "x265_tpu/ops/pallas_mc.py:205"),
    "tile_gather_planes": ("x265_tpu_torch/csrc/tile_gather.cu",
                           "x265_tpu/ops/pallas_mc.py:275"),
    "satd8x8": ("x265_tpu_torch/csrc/satd.cu",
                "x265_tpu/ops/pallas_kernels.py:58"),
}


def main():
    t_start = time.time()
    card = smi()
    emit("device", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    # ---- build
    cuda_build.get_lib()
    t0 = time.time()
    native.get_lib()
    emit("build", kernels_seconds=cuda_build.build_seconds,
         native_writer_seconds=time.time() - t0,
         ptxas=[l for l in cuda_build.build_log.splitlines()
                if "registers" in l or "spill" in l])

    # ---- kernels against their plain versions, on the card
    rows = kernel_phase()
    emit("kernels", kernels=sorted(rows), tolerance="exact (integer)",
         **{k: {"kernel_ms": v["ms"], "plain_ms": v["plain_ms"],
                "shape": v["shape"], "max_abs_err": v["max_abs_err"]}
            for k, v in rows.items()})

    # ---- small encode, decoded back by the port's decoder
    devcache.clear()
    frames = make_clip(416, 240, 6, seed=3)
    enc = Encoder(slice_params(416, 240))
    recons = []
    enc.recon_sink = lambda idx, planes: recons.append(planes)
    t0 = time.time()
    stream = enc.encode(frames)
    t_enc = time.time() - t0
    pics = HEVCDecoder().decode(stream)
    if len(pics) != len(frames) or len(recons) != len(frames):
        fail(f"encode_small: {len(pics)} pictures decoded, "
             f"{len(recons)} recons, {len(frames)} frames")
    for i, (pic, rec) in enumerate(zip(pics, recons)):
        for a, b in zip((pic.y, pic.cb, pic.cr), rec):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                fail(f"encode_small: decoded picture {i} != encoder recon")
    mvs = enc._last_analysis.mv8
    if not np.any(mvs):
        fail("encode_small: the motion field is all zero")
    emit("encode_small", frames=len(frames), bytes=len(stream),
         encode_seconds=t_enc, decoded_equals_recon=True,
         types="".join(s["type"] for s in enc.frame_stats))

    # ---- the main path: 1080p, 1 I + 7 P, through Encoder.encode
    devcache.clear()
    frames = make_clip(W, H, 8, seed=11)
    enc = Encoder(slice_params(W, H))
    profiling.reset()
    profiling.set_sync(True)
    cuda_mc.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    stream = enc.encode(frames)
    torch.cuda.synchronize()
    t_enc = time.time() - t0
    launches = dict(cuda_mc.launches)
    profiling.set_sync(False)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"encode_1080p: kernels never launched: {missing}")
    from x265_tpu_torch.hevc.bitstream import split_annexb
    nal_types = [(n[0] >> 1) & 0x3F for n in split_annexb(stream)[:3]]
    if not stream or nal_types != [32, 33, 34]:
        fail(f"encode_1080p: stream does not start with VPS/SPS/PPS: "
             f"{nal_types}")
    types = "".join(s["type"] for s in enc.frame_stats)
    if types != "IPPPPPPP":
        fail(f"encode_1080p: frame types {types}")
    inter_pct = float(enc._last_analysis.inter8.astype(bool).mean())
    stages = {k: round(v["seconds"], 4)
              for k, v in profiling.report().items()}
    # the same first frames with the plain versions forced on the card
    devcache.clear()
    with plain_versions():
        cuda_mc.reset_launches()
        plain_stream = Encoder(slice_params(W, H)).encode(frames[:3])
        if any(cuda_mc.launches.values()):
            fail("encode_1080p: the plain-version run launched a kernel")
    if not stream.startswith(plain_stream):
        fail("encode_1080p: kernel stream != plain-version stream")
    emit("encode_1080p", card=card, frames=len(frames), bytes=len(stream),
         seconds=t_enc, fps=len(frames) / t_enc, stage_seconds=stages,
         launches=launches, launches_per_p_frame={
             k: v / 7.0 for k, v in launches.items()},
         inter_cu_share_last_frame=inter_pct,
         kernel_stream_equals_plain_stream=True,
         bits=[s["bits"] for s in enc.frame_stats])

    # ---- the kernels' table
    table = []
    for name, r in rows.items():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / INT_OPS_PER_S * 1e3
        table.append({
            "name": name, "route": "cuda", "source": META[name][0],
            "replaces": META[name][1], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": r["library_ms"], "shape": r["shape"]})
    print(json.dumps({"kernels": table}), flush=True)
    emit("done", total_seconds=time.time() - t_start)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
